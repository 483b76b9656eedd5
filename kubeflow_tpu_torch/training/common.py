"""Shared JobController: the reconcile engine behind every training job kind.

The port's copy of ``kubeflow_tpu/training/common.py``.  What the
accelerator changes:

* Pods land on the port's GPU nodes.  A replica gets its cards as an
  upstream PyTorchJob's does: from its container's ``nvidia.com/gpu``
  request, which the scheduler binds to card indices and the kubelet hands
  to the process as ``CUDA_VISIBLE_DEVICES`` (scheduler/topology.py,
  core/kubelet.py).  No ``spec`` field is added for it.
* ``spec.tpu`` has no GPU counterpart, so it is refused, never dropped:
  the job's pods carry a ``google.com/tpu`` request for the slice's chips
  (``tpu_request``) and no TPU placement, which the port's scheduler leaves
  Pending with a ``FailedScheduling`` event naming the resource.  The
  JAX operator's TPU node selector, slice-group label and replica
  expansion from the slice topology are not rendered.

Upstream analogue (UNVERIFIED, SURVEY.md §2a "Training operator: common
JobController"): ``JobController.ReconcileJobs/ReconcilePods/
ReconcileServices`` in training-operator's ``pkg/controller.v1/common``.

Reconcile contract (framework subclasses override the hooks at the bottom):
  1. terminal jobs: apply cleanPodPolicy, honor ttlSecondsAfterFinished;
  2. allocate rendezvous ports once (persisted as an annotation so the
     reconcile is idempotent);
  3. ensure the gang PodGroup (minMember = total replicas, all-or-nothing);
  4. create missing pods with framework rendezvous env injected
     (``set_cluster_spec`` — the TF_CONFIG / MASTER_ADDR / jax.distributed
     analogue, SURVEY.md §3.1) + a headless Service per replica;
  5. restart policy: ExitCode treats exit codes >= 128 (signal/preemption)
     as retryable (pod recreated, Restarting condition) and 1–127 as
     permanent; Never fails the job; Always/OnFailure restart in place via
     the kubelet.  ``backoffLimit`` caps total controller-driven recreations;
  6. aggregate replicaStatuses + Created/Running/Restarting/Succeeded/Failed
     conditions (success policy is a framework hook).
"""

from __future__ import annotations

import json
import time
from typing import Optional

from ..core.api import APIServer, AlreadyExists, NotFound, Obj, owner_reference
from ..core.conditions import has_condition, set_condition
from ..core.controller import Request, Result
from ..core.events import EventRecorder
from ..scheduler.topology import POD_GROUP_LABEL, TPU_RESOURCE
from ..core.metrics import JOBS_CREATED, JOBS_FAILED, JOBS_RESTARTED, JOBS_SUCCESSFUL
from ..utils.net import find_free_ports
from . import api as tapi

PORTS_ANNOTATION = "training.kubeflow.org/rendezvous-ports"

RETRYABLE_EXIT_MIN = 128  # signal-terminated / preempted → retryable


class JobController:
    kind: str = "TPUJob"
    # slice-level failure domain (SURVEY.md §5): retryable failure of ANY
    # replica restarts the whole gang (one backoff count). True for the
    # rendezvous kinds (the port's workers join over torch.distributed from
    # the JAX variables) — survivors of a partial failure are wedged in
    # collectives and rendezvous needs every process to rejoin. Framework
    # kinds with per-rank recovery semantics (TF PS, torch elastic) keep
    # per-pod restarts.
    gang_restart: bool = False

    def __init__(self, api: APIServer):
        self.api = api
        self.recorder = EventRecorder(api, f"{self.kind.lower()}-controller")

    # ------------------------------------------------------------- reconcile

    def reconcile(self, req: Request) -> Optional[Result]:
        job = self.api.try_get(self.kind, req.name, req.namespace)
        if job is None:
            return None
        status = job.setdefault("status", {})

        if has_condition(status, tapi.SUCCEEDED) or has_condition(status, tapi.FAILED):
            return self._reconcile_terminal(job)

        if not has_condition(status, tapi.CREATED):
            set_condition(status, tapi.CREATED, "True", f"{self.kind}Created", "job accepted")
            self.recorder.normal(job, "JobCreated", f"{self.kind} {req.name} created")
            JOBS_CREATED.inc(kind=self.kind)
            job = self.api.update_status(job)
            status = job["status"]

        replicas = self.effective_replicas(job)
        total = sum(r["replicas"] for r in replicas.values())

        job = self._ensure_ports(job, replicas)
        status = job["status"]  # rebind: _ensure_ports returns a fresh copy
        self._ensure_pod_group(job, total)
        self.prepare(job, replicas)

        pods_by_type: dict[str, list[Optional[Obj]]] = {}
        for rtype, rspec in replicas.items():
            pods_by_type[rtype] = [
                self.api.try_get("Pod", self.pod_name(job, rtype, i), req.namespace)
                for i in range(rspec["replicas"])
            ]

        # --- restart / failure policy before creating anything.
        # Two passes: detect any PERMANENT failure first so we never delete
        # sibling pods (and their logs) of a job that is about to fail.
        backoff_limit = job["spec"].get("runPolicy", {}).get("backoffLimit", 3)
        failure_msg = None
        retryable_failures: list[tuple[str, int, Obj, Optional[int]]] = []
        for rtype, rspec in replicas.items():
            policy = rspec.get("restartPolicy", "Never")
            for i, pod in enumerate(pods_by_type[rtype]):
                if pod is None or pod.get("status", {}).get("phase") != "Failed":
                    continue
                rc = _exit_code(pod)
                retryable = policy in ("Always", "OnFailure") or (
                    policy == "ExitCode" and rc is not None and rc >= RETRYABLE_EXIT_MIN
                )
                if not retryable:
                    if self.absorb_failure(job, status, rtype, i, pod, rc):
                        # elastic shrink: the framework accepted the loss;
                        # drop the pod, requeue to re-render the world
                        self.api.try_delete("Pod", pod["metadata"]["name"], req.namespace)
                        self.api.update_status(job)
                        return Result(requeue_after=0.05)
                    failure_msg = f"{rtype}[{i}] failed with exit code {rc} (permanent)"
                    break
                # gang mode: the current cycle's failures all collapse into ONE
                # restart that hasn't been charged yet, so only PAST restarts
                # count against the budget (backoffLimit=N allows N restarts,
                # matching the per-pod accounting)
                pending = 0 if self.gang_restart else len(retryable_failures)
                if self._restarts(status) + pending >= backoff_limit:
                    failure_msg = f"{rtype}[{i}] exceeded backoffLimit ({backoff_limit})"
                    break
                retryable_failures.append((rtype, i, pod, rc))
            if failure_msg:
                break

        restarted = False
        if failure_msg is None and retryable_failures:
            if self.gang_restart:
                # slice-level failure domain (SURVEY.md §5): one worker down
                # restarts the WHOLE gang — survivors are blocked in
                # collectives and a fresh rendezvous needs
                # every process to rejoin; workers resume from the newest
                # checkpoint (spec.checkpoint), so this costs steps-since-
                # save, not the run. One gang restart = one backoff count.
                rtype0, i0, _, rc0 = retryable_failures[0]
                for rtype, rspec in replicas.items():
                    for i, pod in enumerate(pods_by_type[rtype]):
                        if pod is not None:
                            self.api.try_delete("Pod", pod["metadata"]["name"], req.namespace)
                            pods_by_type[rtype][i] = None
                status["restartCount"] = self._restarts(status) + 1
                restarted = True
                JOBS_RESTARTED.inc(kind=self.kind)
                self.recorder.warning(
                    job, "SliceRestarting",
                    f"{rtype0}[{i0}] exit {rc0}: retryable, restarting the whole gang"
                )
            else:
                for rtype, i, pod, rc in retryable_failures:
                    self.api.try_delete("Pod", pod["metadata"]["name"], req.namespace)
                    pods_by_type[rtype][i] = None
                    status["restartCount"] = self._restarts(status) + 1
                    restarted = True
                    JOBS_RESTARTED.inc(kind=self.kind)
                    self.recorder.warning(
                        job, "JobRestarting", f"{rtype}[{i}] exit {rc}: retryable, recreating"
                    )

        if failure_msg:
            set_condition(status, tapi.FAILED, "True", "JobFailed", failure_msg)
            set_condition(status, tapi.RUNNING, "False", "JobFailed", failure_msg)
            status["completionTime"] = time.time()
            self.recorder.warning(job, "JobFailed", failure_msg)
            JOBS_FAILED.inc(kind=self.kind)
            self.api.update_status(job)
            return self._reconcile_terminal(job)

        if restarted:
            set_condition(status, tapi.RESTARTING, "True", "JobRestarting", "recreating failed pods")
            self.api.update_status(job)
            return Result(requeue_after=0.05)

        # --- create missing pods + services; delete pods beyond the desired
        # count (elastic scale-down / spec.replicas shrink)
        for rtype, rspec in replicas.items():
            for i, pod in enumerate(pods_by_type[rtype]):
                if pod is None:
                    created = self._create_pod(job, rtype, i, rspec, replicas)
                    pods_by_type[rtype][i] = created
                    self._ensure_service(job, created)
            i = rspec["replicas"]
            while self.api.try_delete("Pod", self.pod_name(job, rtype, i), req.namespace):
                self.recorder.normal(job, "JobScaledDown", f"removed {rtype}[{i}]")
                i += 1

        # --- aggregate status
        replica_statuses = {}
        any_active = False
        for rtype, pods in pods_by_type.items():
            phases = [((p or {}).get("status") or {}).get("phase", "Pending") for p in pods]
            replica_statuses[rtype] = {
                "active": sum(ph in ("Pending", "Running") for ph in phases),
                "succeeded": sum(ph == "Succeeded" for ph in phases),
                "failed": sum(ph == "Failed" for ph in phases),
            }
            any_active = any_active or any(ph == "Running" for ph in phases)
        status["replicaStatuses"] = replica_statuses

        if self.is_succeeded(job, pods_by_type):
            set_condition(status, tapi.SUCCEEDED, "True", "JobSucceeded", "job completed")
            set_condition(status, tapi.RUNNING, "False", "JobSucceeded", "job completed")
            status["completionTime"] = time.time()
            self.recorder.normal(job, "JobSucceeded", f"{self.kind} {req.name} succeeded")
            JOBS_SUCCESSFUL.inc(kind=self.kind)
            self.api.update_status(job)
            return self._reconcile_terminal(self.api.get(self.kind, req.name, req.namespace))

        if any_active and not has_condition(status, tapi.RUNNING):
            set_condition(status, tapi.RUNNING, "True", f"{self.kind}Running", "pods running")
            self.recorder.normal(job, "JobRunning", "all pods scheduled")
        grow = self.maybe_grow(job, status)
        self.api.update_status(job)
        return grow

    # ------------------------------------------------------------- terminal

    def _reconcile_terminal(self, job: Obj) -> Optional[Result]:
        ns = job["metadata"].get("namespace", "default")
        policy = job["spec"].get("runPolicy", {}).get("cleanPodPolicy", "None")
        if policy != "None":
            for pod in self._job_pods(job):
                phase = pod.get("status", {}).get("phase", "Pending")
                if policy == "All" or (policy == "Running" and phase in ("Pending", "Running")):
                    self.api.try_delete("Pod", pod["metadata"]["name"], ns)
        ttl = job["spec"].get("runPolicy", {}).get("ttlSecondsAfterFinished")
        if ttl is not None:
            done_at = job.get("status", {}).get("completionTime") or time.time()
            remaining = done_at + ttl - time.time()
            if remaining <= 0:
                self.api.try_delete(self.kind, job["metadata"]["name"], ns)
                return None
            return Result(requeue_after=remaining)
        return None

    # --------------------------------------------------------------- helpers

    def _restarts(self, status: dict) -> int:
        return int(status.get("restartCount", 0))

    def _job_pods(self, job: Obj) -> list[Obj]:
        return self.api.list(
            "Pod",
            namespace=job["metadata"].get("namespace", "default"),
            label_selector={tapi.LABEL_JOB_NAME: job["metadata"]["name"]},
        )

    def pod_name(self, job: Obj, rtype: str, index: int) -> str:
        return f"{job['metadata']['name']}-{rtype.lower()}-{index}"

    def _ensure_ports(self, job: Obj, replicas: dict) -> Obj:
        if PORTS_ANNOTATION in job["metadata"].get("annotations", {}):
            return job
        total = sum(r["replicas"] for r in replicas.values())
        ports = find_free_ports(self.num_ports(total))
        job["metadata"].setdefault("annotations", {})[PORTS_ANNOTATION] = json.dumps(ports)
        return self.api.update(job)

    def ports_of(self, job: Obj) -> list[int]:
        return json.loads(job["metadata"]["annotations"][PORTS_ANNOTATION])

    def _ensure_pod_group(self, job: Obj, total: int) -> None:
        name = job["metadata"]["name"]
        ns = job["metadata"].get("namespace", "default")
        min_member = total
        sched = job["spec"].get("runPolicy", {}).get("schedulingPolicy") or {}
        elastic = job["spec"].get("elasticPolicy") or {}
        if "minAvailable" in sched:
            min_member = sched["minAvailable"]
        elif "minReplicas" in elastic:
            # elastic jobs gang only on the floor: the job is viable at min
            min_member = min(total, elastic["minReplicas"])
        try:
            self.api.create(
                {
                    "apiVersion": "scheduling.kubeflow.org/v1",
                    "kind": "PodGroup",
                    "metadata": {
                        "name": name,
                        "namespace": ns,
                        "ownerReferences": [owner_reference(job)],
                    },
                    "spec": {"minMember": min_member, "queue": sched.get("queue", "default")},
                }
            )
        except AlreadyExists:
            pass

    def _create_pod(self, job: Obj, rtype: str, index: int, rspec: dict, replicas: dict) -> Obj:
        import copy

        name = job["metadata"]["name"]
        ns = job["metadata"].get("namespace", "default")
        template = copy.deepcopy(rspec["template"])
        pod = {
            "apiVersion": "v1",
            "kind": "Pod",
            "metadata": {
                "name": self.pod_name(job, rtype, index),
                "namespace": ns,
                "labels": {
                    tapi.LABEL_JOB_NAME: name,
                    tapi.LABEL_REPLICA_TYPE: rtype.lower(),
                    tapi.LABEL_REPLICA_INDEX: str(index),
                    POD_GROUP_LABEL: name,
                    **template.get("metadata", {}).get("labels", {}),
                },
                "ownerReferences": [owner_reference(job)],
            },
            "spec": copy.deepcopy(template["spec"]),
        }
        spec = pod["spec"]
        spec.setdefault("restartPolicy", self._pod_restart_policy(rspec))
        if spec.get("nodeSelector") is None:
            spec.pop("nodeSelector", None)

        tpu = job["spec"].get("tpu")
        if tpu:
            # refused, never dropped: the scheduler leaves the pod Pending
            req = spec["containers"][0].setdefault("resources", {}).setdefault("requests", {})
            req.setdefault(TPU_RESOURCE, tpu_request(tpu))

        # rendezvous env goes into EVERY container (sidecars need it too);
        # template entries win on name collision, valueFrom entries pass through
        cluster_env = self.set_cluster_spec(job, rtype, index, replicas)
        for c in spec["containers"]:
            existing = c.get("env", [])
            names = {e["name"] for e in existing}
            c["env"] = existing + [
                {"name": k, "value": str(v)} for k, v in cluster_env.items() if k not in names
            ]
        self.mutate_pod(pod, job, rtype, index)
        return self.api.create(pod)

    def _pod_restart_policy(self, rspec: dict) -> str:
        policy = rspec.get("restartPolicy", "Never")
        # ExitCode is controller-driven recreation; at pod level it is Never.
        return "Never" if policy == "ExitCode" else policy

    def _ensure_service(self, job: Obj, pod: Obj) -> None:
        """Headless Service per replica — upstream gives each replica stable
        DNS; in the simulator every address is 127.0.0.1 but the objects keep
        API parity for tests and UIs."""
        try:
            self.api.create(
                {
                    "apiVersion": "v1",
                    "kind": "Service",
                    "metadata": {
                        "name": pod["metadata"]["name"],
                        "namespace": pod["metadata"].get("namespace", "default"),
                        "ownerReferences": [owner_reference(job)],
                    },
                    "spec": {
                        "clusterIP": "None",
                        "selector": {
                            tapi.LABEL_JOB_NAME: job["metadata"]["name"],
                            tapi.LABEL_REPLICA_INDEX: pod["metadata"]["labels"][tapi.LABEL_REPLICA_INDEX],
                            tapi.LABEL_REPLICA_TYPE: pod["metadata"]["labels"][tapi.LABEL_REPLICA_TYPE],
                        },
                    },
                }
            )
        except AlreadyExists:
            pass

    # ------------------------------------------------------ framework hooks

    def effective_replicas(self, job: Obj) -> dict[str, dict]:
        """Expanded replicaSpecs: the spec's counts (a slice topology sizes
        nothing here: ``spec.tpu`` is refused)."""
        replicas = {k: dict(v) for k, v in (job["spec"].get("replicaSpecs") or {}).items()}
        # elastic shrink recorded by absorb_failure overrides the spec count
        for rtype, n in ((job.get("status") or {}).get("elasticReplicas") or {}).items():
            if rtype in replicas:
                replicas[rtype]["replicas"] = n
        return replicas

    def num_ports(self, total_replicas: int) -> int:
        return 1  # coordinator only; frameworks with per-task ports override

    def prepare(self, job: Obj, replicas: dict) -> None:
        """Hook: ensure framework-owned side objects (e.g. the MPIJob
        hostfile ConfigMap) before any pod is created."""

    def mutate_pod(self, pod: Obj, job: Obj, rtype: str, index: int) -> None:
        """Hook: framework-specific pod surgery (volumes, mounts) before
        the pod is POSTed."""

    def maybe_grow(self, job: Obj, status: dict) -> Optional[Result]:
        """Hook: elastic scale-UP decision, called at the end of a healthy
        reconcile.  Return a Result to requeue for future growth."""
        return None

    def set_cluster_spec(self, job: Obj, rtype: str, index: int, replicas: dict) -> dict[str, str]:
        """Rendezvous env for one replica. Framework-specific."""
        return {}

    def absorb_failure(self, job: Obj, status: dict, rtype: str, index: int,
                       pod: Obj, rc: Optional[int]) -> bool:
        """Hook: return True to absorb a permanent pod failure instead of
        failing the job (elastic frameworks shrink the replica set here)."""
        return False

    def is_succeeded(self, job: Obj, pods_by_type: dict[str, list[Optional[Obj]]]) -> bool:
        """Default success policy: the chief replica type fully succeeded;
        if absent, all pods succeeded."""
        chief = tapi.JOB_KINDS[self.kind]["chief"]
        target = pods_by_type.get(chief)
        if not target:
            target = [p for pods in pods_by_type.values() for p in pods]
        return bool(target) and all(
            p is not None and p.get("status", {}).get("phase") == "Succeeded" for p in target
        )


def tpu_request(tpu: dict) -> int:
    """The chips a ``spec.tpu`` slice asks for: the product of its topology's
    dimensions times its slices (``2x4`` -> 8)."""
    chips = 1
    for dim in str(tpu.get("topology", "2x2")).lower().split("x"):
        chips *= int(dim)
    return chips * int(tpu.get("numSlices", 1))


def _exit_code(pod: Obj) -> Optional[int]:
    for cs in pod.get("status", {}).get("containerStatuses", []):
        term = cs.get("state", {}).get("terminated")
        if term is not None and "exitCode" in term:
            return int(term["exitCode"])
    return None
