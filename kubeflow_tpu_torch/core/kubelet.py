"""Local-process kubelet: runs Pods as real OS subprocesses.

The port's copy of ``kubeflow_tpu/core/kubelet.py``.  One thing differs:
the card indices the scheduler bound a pod to (scheduler/topology.py's
``gpu-indices`` annotation) reach its process as ``CUDA_VISIBLE_DEVICES``,
as the NVIDIA device plugin's allocation does.  The indices count the
cards this process sees: where its own ``CUDA_VISIBLE_DEVICES`` is set,
node index ``i`` is that list's ``i``-th entry, so two node cards may map
onto one card (``"0,0"``; the port's processes collapse such a list before
CUDA starts, utils/device.py).  A pod that holds no card gets
``CUDA_VISIBLE_DEVICES=""`` and sees none.

Upstream analogue (UNVERIFIED): the kubelet + container runtime.  This is the
piece that lets the rebuild go *further* than upstream CI (SURVEY.md §4): pods
are actual processes, so a job's reconcile path ends in a genuine
multi-process rendezvous on localhost rather than a fake.

Supported Pod surface: ``spec.initContainers`` (sequential), the first entry of
``spec.containers``, ``env``/``command``/``args``/``workingDir``,
``restartPolicy`` (Always | OnFailure | Never), deletion → SIGTERM/SIGKILL,
ConfigMap volumes (rendered as files under a per-pod root, with the k8s
``$(VAR)`` dependent-env expansion so specs can reference the mount root),
and ``POD_VOLUME_ROOT`` exported to the process.
"""

from __future__ import annotations

import os
import re
import signal
import subprocess
import tempfile
import time
from dataclasses import dataclass, field
from typing import Optional

from .api import APIServer, NotFound, Obj
from ..scheduler.topology import gpu_indices

_ENV_REF = re.compile(r"\$\(([A-Za-z_][A-Za-z0-9_]*)\)")


@dataclass
class _PodRun:
    namespace: str
    name: str
    uid: str
    init_remaining: list[dict] = field(default_factory=list)
    current: Optional[subprocess.Popen] = None
    in_init: bool = False
    main_container: Optional[dict] = None
    # containers[1:] run as sidecars: spawned with the main container, killed
    # (stop file + SIGTERM, so they can flush) when the main terminates — the
    # k8s semantics Katib's injected metrics collector relies on
    sidecar_containers: list[dict] = field(default_factory=list)
    sidecars: list[subprocess.Popen] = field(default_factory=list)
    # main exited; waiting (non-blocking, across sync ticks) for sidecars to
    # flush before the pod goes terminal
    draining: bool = False
    drain_rc: int = 0
    drain_sigterm_at: float = 0.0
    drain_deadline: float = 0.0
    log_path: str = ""
    # uid-scoped stop-file path: the log path is NAME-scoped (user-visible,
    # stable across recreates) but the stop signal must die with the run — a
    # reaped old incarnation's _stop_sidecars would otherwise re-create a
    # name-scoped stop file AFTER the recreated pod started, and the new
    # pod's sidecars would flush-and-exit at startup
    stop_path: str = ""
    restart_count: int = 0
    next_restart_at: float = 0.0
    terminating: bool = False
    kill_at: float = 0.0
    volume_root: str = ""
    # CUDA_VISIBLE_DEVICES for the pod's processes ("" holds no card)
    cards: str = ""


class LocalProcessKubelet:
    def __init__(
        self,
        api: APIServer,
        node_name: str = "local-0",
        workdir: Optional[str] = None,
        base_env: Optional[dict] = None,
    ):
        self.api = api
        self.node_name = node_name
        self.workdir = workdir or tempfile.mkdtemp(prefix="kubelet-")
        self.logdir = os.path.join(self.workdir, "logs")
        os.makedirs(self.logdir, exist_ok=True)
        self.base_env = dict(base_env or {})
        self._runs: dict[str, _PodRun] = {}  # by uid
        if api.try_get("Node", node_name) is None:
            api.create(
                {
                    "apiVersion": "v1",
                    "kind": "Node",
                    "metadata": {"name": node_name, "labels": {"kubernetes.io/hostname": node_name}},
                    "status": {"phase": "Ready"},
                }
            )

    # ------------------------------------------------------------------ sync

    def sync(self) -> bool:
        """One kubelet sync pass; returns True if any pod state changed."""
        changed = False
        pods = self.api.list("Pod", field_selector=lambda p: p.get("spec", {}).get("nodeName") == self.node_name)
        live_uids = set()
        for pod in pods:
            live_uids.add(pod["metadata"]["uid"])
            if self._sync_pod(pod):
                changed = True
        # pods we were running that no longer exist in the store → kill
        for uid, run in list(self._runs.items()):
            if uid not in live_uids:
                self._terminate(run, grace=0.5)
                if run.current is None:
                    del self._runs[uid]
                changed = True
        return changed

    def _sync_pod(self, pod: Obj) -> bool:
        uid = pod["metadata"]["uid"]
        phase = pod.get("status", {}).get("phase", "Pending")
        run = self._runs.get(uid)
        if run is None:
            if phase in ("Succeeded", "Failed"):
                return False
            run = self._start(pod)
            return True
        return self._poll(pod, run)

    # ----------------------------------------------------------------- start

    def _start(self, pod: Obj) -> _PodRun:
        meta = pod["metadata"]
        spec = pod["spec"]
        run = _PodRun(
            namespace=meta.get("namespace", "default"),
            name=meta["name"],
            uid=meta["uid"],
            init_remaining=list(spec.get("initContainers", [])),
            main_container=spec["containers"][0],
            sidecar_containers=list(spec["containers"][1:]),
        )
        run.log_path = os.path.join(self.logdir, f"{run.namespace}_{run.name}.log")
        run.stop_path = run.log_path + f".{run.uid}.stop"
        # stale stop files are uid-scoped litter from reaped runs; the LOG is
        # truncated only for SIDECAR-bearing pods — a freshly injected
        # metrics collector starts at offset 0 and would re-push the previous
        # incarnation's objective values into the new trial.  Sidecar-less
        # pods keep the name-scoped accumulate behavior: gang-restarted
        # TPUJob workers append across incarnations, which is how the
        # resume-continuity tests (and operators reading logs) observe that
        # a restart actually resumed from the checkpoint.
        import glob as _glob
        # only unlink stop files of runs that are GONE from self._runs: a
        # previous same-named incarnation still draining needs its stop file
        # for the race-free sidecar stop signal (else its sidecars only exit
        # via the SIGTERM/kill escalation)
        stale = []
        for path in _glob.glob(run.log_path + ".*.stop"):
            uid = path[len(run.log_path) + 1:-len(".stop")]
            if uid not in self._runs:
                stale.append(path)
        if run.sidecar_containers:
            stale.append(run.log_path)
        for path in stale:
            try:
                os.unlink(path)
            except OSError:
                pass
        self._runs[meta["uid"]] = run
        try:
            run.cards = self._visible_cards(gpu_indices(pod))
            self._render_volumes(pod, run)
            self._advance(run)
        except (ValueError, OSError) as e:
            self._set_status(
                run,
                {
                    "phase": "Failed",
                    "reason": "StartError",
                    "message": str(e),
                    "containerStatuses": [
                        {
                            "name": run.main_container.get("name", "main"),
                            "state": {"terminated": {"exitCode": 128, "reason": "StartError"}},
                        }
                    ],
                },
            )
            self._runs.pop(meta["uid"], None)
            return run
        self._set_status(
            run,
            {
                "phase": "Running",
                "startTime": time.time(),
                "podIP": "127.0.0.1",
                "hostIP": "127.0.0.1",
            },
        )
        return run

    def _render_volumes(self, pod: Obj, run: _PodRun) -> None:
        """Materialize ConfigMap volumes as files under a per-pod root.

        Containers are plain processes here, so absolute ``mountPath``s are
        re-rooted at ``<workdir>/pods/<uid>``; the process finds them via the
        exported ``POD_VOLUME_ROOT`` (specs reference it with the k8s
        ``$(VAR)`` dependent-env syntax, expanded in ``_spawn``).
        """
        spec = pod["spec"]
        volumes = {v["name"]: v for v in spec.get("volumes", []) if "configMap" in v}
        if not volumes:
            return
        run.volume_root = os.path.join(self.workdir, "pods", run.uid)
        for container in list(spec.get("initContainers", [])) + spec["containers"]:
            for mount in container.get("volumeMounts", []):
                vol = volumes.get(mount["name"])
                if vol is None:
                    continue
                cm = self.api.try_get("ConfigMap", vol["configMap"]["name"], run.namespace)
                if cm is None:
                    raise ValueError(
                        f"pod {run.name}: ConfigMap {vol['configMap']['name']!r} not found")
                target = run.volume_root + os.path.abspath(mount["mountPath"])
                os.makedirs(target, exist_ok=True)
                for key, content in (cm.get("data") or {}).items():
                    with open(os.path.join(target, key), "w") as f:
                        f.write(content)

    def _visible_cards(self, indices: list[int]) -> str:
        """``CUDA_VISIBLE_DEVICES`` for a pod bound to node card
        ``indices``, mapped through the one this process runs under."""
        parent = self.base_env.get("CUDA_VISIBLE_DEVICES",
                                   os.environ.get("CUDA_VISIBLE_DEVICES"))
        if parent is None:
            return ",".join(str(i) for i in indices)
        seen = [d.strip() for d in parent.split(",") if d.strip()]
        for i in indices:
            if i >= len(seen):
                raise ValueError(
                    f"card {i} is not among the cards this node sees "
                    f"(CUDA_VISIBLE_DEVICES={parent!r})")
        return ",".join(seen[i] for i in indices)

    def _spawn(self, run: _PodRun, container: dict,
               log_suffix: str = "") -> subprocess.Popen:
        cmd = list(container.get("command", [])) + list(container.get("args", []))
        if not cmd:
            raise ValueError(f"pod {run.name}: container has no command (images are not pullable here)")
        env = dict(os.environ)
        env.update(self.base_env)
        if run.volume_root:
            env["POD_VOLUME_ROOT"] = run.volume_root
        env["CUDA_VISIBLE_DEVICES"] = run.cards
        # sidecars (e.g. the Katib metrics collector) tail the main
        # container's log through this; their own output goes to a
        # per-container file so it cannot pollute the parsed stream.
        # POD_STOP_FILE appears when the pod is shutting down — the
        # race-free companion to the SIGTERM sidecars also receive.
        env["POD_LOG_PATH"] = run.log_path
        env["POD_STOP_FILE"] = run.stop_path
        # k8s dependent-env semantics: $(VAR) in a value resolves against the
        # base env plus PREVIOUSLY-declared container vars only — forward
        # references stay verbatim, exactly like a real kubelet
        for e in container.get("env", []):
            if "value" not in e:  # valueFrom (fieldRef/secretKeyRef) not resolvable here
                continue
            value = str(e["value"])
            if "$(" in value:
                value = _ENV_REF.sub(lambda m: env.get(m.group(1), m.group(0)), value)
            env[e["name"]] = value
        env.setdefault("POD_NAME", run.name)
        env.setdefault("POD_NAMESPACE", run.namespace)
        log_path = (run.log_path if not log_suffix
                    else f"{run.log_path}.{log_suffix}")
        log = open(log_path, "ab")
        return subprocess.Popen(
            cmd,
            env=env,
            cwd=container.get("workingDir") or self.workdir,
            stdout=log,
            stderr=subprocess.STDOUT,
            start_new_session=True,
        )

    def _advance(self, run: _PodRun) -> None:
        """Start the next container (init chain, then main + sidecars)."""
        if run.init_remaining:
            run.in_init = True
            run.current = self._spawn(run, run.init_remaining.pop(0))
        else:
            run.in_init = False
            run.current = self._spawn(run, run.main_container)
            if run.sidecar_containers and not run.sidecars:
                # sidecars start alongside the FIRST main start and survive
                # main crash-restarts (upstream pod semantics)
                try:
                    for c in run.sidecar_containers:
                        run.sidecars.append(
                            self._spawn(run, c, log_suffix=c.get("name", "sidecar")))
                except (ValueError, OSError):
                    # a bad sidecar spec must not leak the already-started
                    # main process (or earlier sidecars): the StartError
                    # handlers up-stack only mark the pod Failed
                    try:
                        os.killpg(run.current.pid, signal.SIGKILL)
                    except ProcessLookupError:
                        pass
                    run.current = None
                    self._stop_sidecars(run, grace=0.0)
                    raise

    def _stop_sidecars(self, run: _PodRun, grace: float) -> None:
        """Stop sidecars so they can flush, then the pod may go terminal.

        Shutdown signal ordering matters: SIGTERM delivered while a sidecar
        interpreter is still starting up (main exited fast) kills it before
        any handler is installed — flushing nothing.  So the stop FILE at
        ``POD_STOP_FILE`` is the primary signal (a polling sidecar of any
        age sees it); SIGTERM goes out only halfway into the grace window,
        by which point a live sidecar has long installed its handler; at
        the deadline stragglers are SIGKILLed."""
        if not run.sidecars:
            return
        try:
            with open(run.stop_path, "w"):
                pass
        except OSError:
            pass
        deadline = time.monotonic() + grace
        sigterm_at = time.monotonic() + grace / 2
        sigtermed = grace <= 0
        if sigtermed:
            self._signal_sidecars(run, signal.SIGTERM)
        while time.monotonic() < deadline:
            if all(p.poll() is not None for p in run.sidecars):
                break
            if not sigtermed and time.monotonic() >= sigterm_at:
                self._signal_sidecars(run, signal.SIGTERM)
                sigtermed = True
            time.sleep(0.02)
        for p in run.sidecars:
            if p.poll() is None:
                try:
                    os.killpg(p.pid, signal.SIGKILL)
                except ProcessLookupError:
                    pass
        run.sidecars.clear()

    def _signal_sidecars(self, run: _PodRun, sig: int) -> None:
        for p in run.sidecars:
            if p.poll() is None:
                try:
                    os.killpg(p.pid, sig)
                except ProcessLookupError:
                    pass

    # ------------------------------------------------------------------ poll

    def _poll(self, pod: Obj, run: _PodRun) -> bool:
        if run.terminating:
            if run.current is not None and run.current.poll() is None:
                if time.monotonic() >= run.kill_at:
                    try:
                        os.killpg(run.current.pid, signal.SIGKILL)
                    except ProcessLookupError:
                        pass
                return False
            run.current = None
            self._stop_sidecars(run, grace=0.5)
            self._runs.pop(run.uid, None)
            return True

        if run.draining:
            return self._poll_drain(pod, run)

        if run.current is None:
            # waiting out a crash-restart backoff
            if time.monotonic() >= run.next_restart_at:
                try:
                    self._advance(run)
                except (ValueError, OSError) as e:
                    self._set_status(run, {"phase": "Failed", "reason": "StartError", "message": str(e)})
                    self._runs.pop(run.uid, None)
                return True
            return False

        rc = run.current.poll()
        if rc is None:
            return False

        if run.in_init:
            if rc == 0:
                try:
                    self._advance(run)
                except (ValueError, OSError) as e:
                    self._set_status(run, {"phase": "Failed", "reason": "StartError", "message": str(e)})
                    self._runs.pop(run.uid, None)
                return True
            self._set_status(run, self._terminated_status(pod, "Failed", rc, init=True))
            run.current = None
            self._runs.pop(run.uid, None)
            return True

        restart = pod["spec"].get("restartPolicy", "Always")
        if restart == "Always" or (restart == "OnFailure" and rc != 0):
            run.restart_count += 1
            run.current = None
            run.next_restart_at = time.monotonic() + min(0.2 * run.restart_count, 2.0)
            self._set_status(
                run,
                {
                    "phase": "Running",
                    "containerStatuses": [
                        {
                            "name": run.main_container.get("name", "main"),
                            "restartCount": run.restart_count,
                            "lastState": {"terminated": {"exitCode": rc, "finishedAt": time.time()}},
                            "state": {"waiting": {"reason": "CrashLoopBackOff" if rc else "Restarting"}},
                        }
                    ],
                },
            )
            return True

        # sidecars flush BEFORE the pod goes terminal: a watcher that sees
        # Succeeded can rely on sidecar-pushed state (metrics) being
        # complete.  The wait is NON-blocking — draining is polled across
        # sync ticks so a slow sidecar never stalls the whole manager.
        run.current = None
        if run.sidecars:
            self._begin_drain(run, rc)
            return self._poll_drain(pod, run)
        self._set_status(run, self._terminated_status(pod, "Succeeded" if rc == 0 else "Failed", rc))
        self._runs.pop(run.uid, None)
        return True

    _DRAIN_GRACE = 8.0

    def _begin_drain(self, run: _PodRun, rc: int) -> None:
        run.draining = True
        run.drain_rc = rc
        now = time.monotonic()
        run.drain_sigterm_at = now + self._DRAIN_GRACE / 2
        run.drain_deadline = now + self._DRAIN_GRACE
        try:
            with open(run.stop_path, "w"):
                pass
        except OSError:
            pass

    def _poll_drain(self, pod: Obj, run: _PodRun) -> bool:
        now = time.monotonic()
        alive = [p for p in run.sidecars if p.poll() is None]
        if alive:
            # stop-file first; SIGTERM only mid-grace (a sidecar signalled
            # during interpreter startup dies handler-less, flushing nothing)
            if now >= run.drain_deadline:
                self._signal_sidecars(run, signal.SIGKILL)
            elif now >= run.drain_sigterm_at:
                self._signal_sidecars(run, signal.SIGTERM)
            if now < run.drain_deadline:
                return False
        run.sidecars.clear()
        run.draining = False
        rc = run.drain_rc
        self._set_status(run, self._terminated_status(pod, "Succeeded" if rc == 0 else "Failed", rc))
        self._runs.pop(run.uid, None)
        return True

    def _terminated_status(self, pod: Obj, phase: str, rc: int, init: bool = False) -> dict:
        run = self._runs[pod["metadata"]["uid"]]
        return {
            "phase": phase,
            "startTime": pod.get("status", {}).get("startTime"),
            "containerStatuses": [
                {
                    "name": ("init" if init else run.main_container.get("name", "main")),
                    "restartCount": run.restart_count,
                    "state": {"terminated": {"exitCode": rc, "finishedAt": time.time()}},
                }
            ],
        }

    # ------------------------------------------------------------- lifecycle

    def _terminate(self, run: _PodRun, grace: float) -> None:
        if run.current is not None and run.current.poll() is None:
            run.terminating = True
            run.kill_at = time.monotonic() + grace
            try:
                os.killpg(run.current.pid, signal.SIGTERM)
            except ProcessLookupError:
                run.current = None
        else:
            run.current = None
        if run.current is None:
            self._stop_sidecars(run, grace=min(grace, 0.5))

    def _set_status(self, run: _PodRun, status: dict) -> None:
        try:
            pod = self.api.get("Pod", run.name, run.namespace)
        except NotFound:
            return
        merged = dict(pod.get("status", {}))
        merged.update(status)
        pod["status"] = merged
        self.api.update_status(pod)

    def logs(self, name: str, namespace: str = "default") -> str:
        path = os.path.join(self.logdir, f"{namespace}_{name}.log")
        if not os.path.exists(path):
            return ""
        with open(path, "rb") as f:
            return f.read().decode(errors="replace")

    def shutdown(self) -> None:
        for run in list(self._runs.values()):
            self._terminate(run, grace=0.0)
            if run.current is not None:
                try:
                    run.current.wait(timeout=2)
                except subprocess.TimeoutExpired:
                    try:
                        os.killpg(run.current.pid, signal.SIGKILL)
                    except ProcessLookupError:
                        pass
            self._stop_sidecars(run, grace=0.2)
        self._runs.clear()
