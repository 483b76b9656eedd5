"""Katib controllers: Experiment → Suggestion → Trial → training job.

The port's copy of ``kubeflow_tpu/katib/controllers.py``.  Trials run as
the port's training jobs (``TPUJob`` by default, as in the JAX package),
and the Push collector's sidecar runs
``kubeflow_tpu_torch.katib.collector_main``.

Upstream analogue (UNVERIFIED, SURVEY.md §3.3): the experiment controller
creates a Suggestion and Trials until goal/maxTrials; the trial controller
renders the trialTemplate into a real job (full §3.1 stack nested) and reads
metrics; the suggestion controller serves parameter assignments.

Deviations from upstream, by design of the simulator:
  * suggestion algorithms run in-process at reconcile time instead of in a
    per-algorithm gRPC service pod (same request/response contract).

Metrics collection supports BOTH upstream shapes: the default pull path
(trial controller reads kubelet logs at reconcile — see metrics.py) and the
upstream sidecar architecture (``metricsCollectorSpec.collector.kind:
"Push"`` — a pod webhook injects collector_main.py as a sidecar container
that tails the log and pushes to the db-manager HTTP service, dbmanager.py).
"""

from __future__ import annotations

import copy
import os
import re
import sys
from typing import Callable, Optional

from ..core.api import AlreadyExists, APIServer, Obj, owner_reference
from ..core.conditions import has_condition, set_condition
from ..core.controller import Request, Result
from ..core.events import EventRecorder
from ..training import api as tapi
from ..utils.render import deep_map_strings
from . import api as kapi
from .metrics import parse_metrics, parse_tfevent_dir
from .obslog import ObservationStore
from .suggest import get_suggester

_PLACEHOLDER = re.compile(r"\$\{trialParameters\.([\w\-]+)\}")


def render_trial_spec(template: dict, assignments: dict) -> dict:
    """Substitute ``${trialParameters.x}`` through the whole spec tree."""
    trial_params = {p["name"]: p["reference"] for p in template.get("trialParameters", [])}

    def repl(m):
        pname = m.group(1)
        ref = trial_params.get(pname, pname)
        if ref not in assignments:
            raise KeyError(f"trial parameter {pname!r} (ref {ref!r}) has no assignment")
        return str(assignments[ref])

    return deep_map_strings(
        copy.deepcopy(template["trialSpec"]), lambda s: _PLACEHOLDER.sub(repl, s)
    )


class ExperimentController:
    kind = "Experiment"

    def __init__(self, api: APIServer):
        self.api = api
        self.recorder = EventRecorder(api, "katib-experiment-controller")

    def _trials(self, exp: Obj) -> list[Obj]:
        return self.api.list(
            "Trial",
            namespace=exp["metadata"].get("namespace", "default"),
            label_selector={kapi.LABEL_EXPERIMENT: exp["metadata"]["name"]},
        )

    def _optimal(self, exp: Obj, trials: list[Obj]) -> Optional[dict]:
        metric = exp["spec"]["objective"]["objectiveMetricName"]
        sign = 1.0 if exp["spec"]["objective"]["type"] == "maximize" else -1.0
        best, best_val = None, None
        for t in trials:
            if not has_condition(t.get("status", {}), kapi.SUCCEEDED):
                continue
            for m in t.get("status", {}).get("observation", {}).get("metrics", []):
                if m["name"] == metric:
                    v = sign * float(m["latest"])
                    if best_val is None or v > best_val:
                        best_val = v
                        best = {
                            "bestTrialName": t["metadata"]["name"],
                            "parameterAssignments": t["spec"].get("parameterAssignments", []),
                            "observation": t["status"]["observation"],
                        }
        return best

    def reconcile(self, req: Request) -> Optional[Result]:
        exp = self.api.try_get("Experiment", req.name, req.namespace)
        if exp is None:
            return None
        status = exp.setdefault("status", {})
        if has_condition(status, kapi.SUCCEEDED) or has_condition(status, kapi.FAILED):
            return None
        if not has_condition(status, kapi.CREATED):
            set_condition(status, kapi.CREATED, "True", "ExperimentCreated", "")
            self.recorder.normal(exp, "Created", "experiment accepted")

        spec = exp["spec"]
        trials = self._trials(exp)
        succeeded = [t for t in trials if has_condition(t.get("status", {}), kapi.SUCCEEDED)]
        failed = [t for t in trials if has_condition(t.get("status", {}), kapi.FAILED)]
        active = [t for t in trials if t not in succeeded and t not in failed]

        status["trials"] = len(trials)
        status["trialsSucceeded"] = len(succeeded)
        status["trialsFailed"] = len(failed)
        status["trialsRunning"] = len(active)
        optimal = self._optimal(exp, trials)
        if optimal:
            status["currentOptimalTrial"] = optimal

        # terminal conditions
        goal = spec["objective"].get("goal")
        metric_reached = False
        if goal is not None and optimal:
            sign = 1.0 if spec["objective"]["type"] == "maximize" else -1.0
            for m in optimal["observation"]["metrics"]:
                if m["name"] == spec["objective"]["objectiveMetricName"]:
                    metric_reached = sign * float(m["latest"]) >= sign * float(goal)
        if len(failed) > spec["maxFailedTrialCount"]:
            set_condition(status, kapi.FAILED, "True", "TooManyFailedTrials",
                          f"{len(failed)} trials failed")
            self.recorder.warning(exp, "Failed", "too many failed trials")
            self.api.update_status(exp)
            return None
        sug = self.api.try_get("Suggestion", req.name, req.namespace)
        # a suggester that cannot produce more points (e.g. grid fully
        # enumerated) ends the experiment once every issued trial finished —
        # upstream's "SuggestionEndReached" terminal reason
        exhausted = (
            sug is not None
            and sug.get("status", {}).get("exhausted", False)
            and not active
            and len(trials) >= sug.get("status", {}).get("suggestionCount", 0)
        )
        if metric_reached or len(succeeded) >= spec["maxTrialCount"] or exhausted:
            reason = (
                "GoalReached" if metric_reached
                else "MaxTrialsReached" if len(succeeded) >= spec["maxTrialCount"]
                else "SuggestionEndReached"
            )
            set_condition(status, kapi.SUCCEEDED, "True", reason, "")
            set_condition(status, kapi.RUNNING, "False", reason, "")
            self.recorder.normal(exp, "Succeeded", reason)
            self.api.update_status(exp)
            return None

        # ensure suggestion object, sized to keep parallelTrialCount running
        free_slots = max(0, spec["parallelTrialCount"] - len(active))
        budget_left = spec["maxTrialCount"] - len(succeeded) - len(active)
        want = len(trials) + min(free_slots, max(0, budget_left))
        if sug is None:
            sug = self.api.create(
                {
                    "apiVersion": kapi.API_VERSION,
                    "kind": "Suggestion",
                    "metadata": {
                        "name": req.name,
                        "namespace": req.namespace,
                        "labels": {kapi.LABEL_EXPERIMENT: req.name},
                        "ownerReferences": [owner_reference(exp)],
                    },
                    "spec": {
                        "algorithm": spec["algorithm"],
                        "requests": want,
                    },
                }
            )
        elif sug["spec"].get("requests", 0) < want:
            sug["spec"]["requests"] = want
            sug = self.api.update(sug)

        # create trials for issued-but-unconsumed assignments
        issued = sug.get("status", {}).get("suggestions", [])
        for idx in range(len(trials), min(len(issued), want)):
            assignments = issued[idx]["assignments"]
            run_spec = render_trial_spec(
                spec["trialTemplate"],
                {a["name"]: a["value"] for a in assignments},
            )
            trial_name = f"{req.name}-{idx:03d}"
            try:
                self.api.create(
                    {
                        "apiVersion": kapi.API_VERSION,
                        "kind": "Trial",
                        "metadata": {
                            "name": trial_name,
                            "namespace": req.namespace,
                            "labels": {kapi.LABEL_EXPERIMENT: req.name},
                            "ownerReferences": [owner_reference(exp)],
                        },
                        "spec": {
                            "parameterAssignments": assignments,
                            "objective": spec["objective"],
                            "primaryContainerName": spec["trialTemplate"].get(
                                "primaryContainerName", "main"
                            ),
                            "runSpec": run_spec,
                            "metricsCollectorSpec": copy.deepcopy(
                                spec.get("metricsCollectorSpec",
                                         {"collector": {"kind": "StdOut"}})),
                            **({"earlyStopping": spec["earlyStopping"]}
                               if spec.get("earlyStopping") else {}),
                        },
                    }
                )
                self.recorder.normal(exp, "TrialCreated", trial_name)
            except AlreadyExists:
                pass

        if active and not has_condition(status, kapi.RUNNING):
            set_condition(status, kapi.RUNNING, "True", "ExperimentRunning", "")
        self.api.update_status(exp)
        return None


class SuggestionController:
    kind = "Suggestion"

    def __init__(self, api: APIServer):
        self.api = api

    def reconcile(self, req: Request) -> Optional[Result]:
        sug = self.api.try_get("Suggestion", req.name, req.namespace)
        if sug is None:
            return None
        exp = self.api.try_get("Experiment", req.name, req.namespace)
        if exp is None:
            return None
        status = sug.setdefault("status", {})
        issued = status.get("suggestions", [])
        want = sug["spec"].get("requests", 0)
        if len(issued) >= want:
            return None
        trials = self.api.list(
            "Trial", namespace=req.namespace,
            label_selector={kapi.LABEL_EXPERIMENT: req.name},
        )
        algo = sug["spec"]["algorithm"]["algorithmName"]
        suggester = get_suggester(algo)
        new = suggester.suggest(exp, trials, want - len(issued))
        for assignments in new:
            issued.append(
                {"assignments": [{"name": k, "value": v} for k, v in assignments.items()]}
            )
        status["suggestions"] = issued
        status["suggestionCount"] = len(issued)
        # fewer than requested = the search space is exhausted (grid etc.);
        # the experiment controller turns this into SuggestionEndReached
        status["exhausted"] = len(issued) < want
        self.api.update_status(sug)
        return None


class TrialController:
    kind = "Trial"

    def __init__(self, api: APIServer, log_reader: Callable[[str, str], str],
                 store: Optional[ObservationStore] = None):
        self.api = api
        self.log_reader = log_reader
        # db-manager equivalent: intermediate series persist here (WAL-backed
        # when kfadm passes a path), not on Trial status / in pod logs
        self.store = store if store is not None else ObservationStore()
        self.recorder = EventRecorder(api, "katib-trial-controller")
        # per-(trial, pod) high-water marks: collection parses only NEW log
        # bytes each reconcile instead of re-parsing from byte 0
        self._log_offsets: dict[tuple[str, str], int] = {}

    def _metric_names(self, trial: Obj) -> list[str]:
        return [trial["spec"]["objective"]["objectiveMetricName"]] + list(
            trial["spec"]["objective"].get("additionalMetricNames", [])
        )

    def _collect(self, trial: Obj, req: Request, final: bool = False) -> None:
        """Pull-based metrics collection into the observation store.

        The simulator's analogue of the injected metrics-collector sidecar
        (SURVEY.md §2a metrics-collectors row): stdout/JSON lines from pod
        logs, or TFEvent files when the trial carries a TFEvent
        metricsCollectorSpec.  Incremental: only bytes past the per-pod
        high-water mark are parsed; a trailing partial line is held back
        until newline-terminated (unless ``final``).
        """
        name = trial["metadata"]["name"]
        metric_names = self._metric_names(trial)
        collector = (trial["spec"].get("metricsCollectorSpec") or {})
        if collector.get("collector", {}).get("kind") == "Push":
            # the injected sidecar owns reporting (push architecture); the
            # kubelet guarantees its final flush lands before the pod goes
            # terminal, so there is nothing to pull here
            return
        if collector.get("collector", {}).get("kind") == "TFEvent":
            path = collector.get("source", {}).get("fileSystemPath", {}).get("path", "")
            for metric, series in parse_tfevent_dir(path, metric_names).items():
                have = self.store.count(name, metric)
                for step, value in series[have:]:
                    self.store.report(name, metric, value, step=step)
            return
        pods = self.api.list(
            "Pod", namespace=req.namespace,
            label_selector={tapi.LABEL_JOB_NAME: req.name},
        )
        if trial["spec"]["runSpec"].get("kind", "TPUJob") == "Pod":
            # bare-Pod trial: the workload IS one pod named after the trial
            # — no job-name label to select on.  Gated on the runSpec kind,
            # never on "no labeled pods found": a job trial with no pods yet
            # must not read an unrelated same-named pod's logs as metrics
            solo = self.api.try_get("Pod", req.name, req.namespace)
            pods = [solo] if solo is not None else []
        for p in pods:
            pod = p["metadata"]["name"]
            log = self.log_reader(pod, req.namespace)
            off = self._log_offsets.get((name, pod), 0)
            new = log[off:]
            if not final:
                cut = new.rfind("\n")
                if cut < 0:
                    continue
                new = new[:cut]
                self._log_offsets[(name, pod)] = off + cut + 1
            else:
                self._log_offsets[(name, pod)] = off + len(new)
            for metric, values in parse_metrics(new, metric_names).items():
                for v in values:
                    self.store.report(name, metric, v)

    def reconcile(self, req: Request) -> Optional[Result]:
        trial = self.api.try_get("Trial", req.name, req.namespace)
        if trial is None:
            return None
        status = trial.setdefault("status", {})
        if has_condition(status, kapi.SUCCEEDED) or has_condition(status, kapi.FAILED):
            return None

        run_spec = trial["spec"]["runSpec"]
        kind = run_spec.get("kind", "TPUJob")
        job = self.api.try_get(kind, req.name, req.namespace)
        if job is None:
            job_obj = copy.deepcopy(run_spec)
            job_obj.setdefault("metadata", {})
            job_obj["metadata"]["name"] = req.name
            job_obj["metadata"]["namespace"] = req.namespace
            job_obj["metadata"].setdefault("labels", {})[kapi.LABEL_EXPERIMENT] = (
                trial["metadata"].get("labels", {}).get(kapi.LABEL_EXPERIMENT, "")
            )
            job_obj["metadata"]["ownerReferences"] = [owner_reference(trial)]
            self.api.create(job_obj)
            set_condition(status, kapi.RUNNING, "True", "TrialRunning", "")
            self.api.update_status(trial)
            return None

        job_status = job.get("status", {})
        if kind == "Pod":
            # bare-Pod trials (upstream's plain batch-job/pod trialTemplate):
            # completion is the pod phase — pods have no job conditions
            job_failed = job_status.get("phase") == "Failed"
            job_succeeded = job_status.get("phase") == "Succeeded"
        else:
            job_failed = has_condition(job_status, tapi.FAILED)
            job_succeeded = has_condition(job_status, tapi.SUCCEEDED)
        if job_failed:
            set_condition(status, kapi.FAILED, "True", "TrialFailed", "job failed")
            set_condition(status, kapi.RUNNING, "False", "TrialFailed", "")
            self.recorder.warning(trial, "TrialFailed", "underlying job failed")
            self.api.update_status(trial)
            return None
        if not job_succeeded:
            self._collect(trial, req)
            return self._maybe_early_stop(trial, status, req)

        # job done: one final collection pass, then build the observation
        # from the store (the series outlives the pods — db-manager parity)
        metric_names = self._metric_names(trial)
        self._collect(trial, req, final=True)
        obs = self.store.observation(req.name, metric_names)
        have = {m["name"] for m in obs["metrics"]}
        if trial["spec"]["objective"]["objectiveMetricName"] not in have:
            set_condition(status, kapi.FAILED, "True", "MetricsUnavailable",
                          f"objective metric not found in logs (looked for {metric_names})")
            self.api.update_status(trial)
            return None
        status["observation"] = obs
        set_condition(status, kapi.SUCCEEDED, "True", "TrialSucceeded", "")
        set_condition(status, kapi.RUNNING, "False", "TrialSucceeded", "")
        self.recorder.normal(trial, "TrialSucceeded", str(obs["metrics"]))
        self.api.update_status(trial)
        return None

    # --------------------------------------------------- early stopping

    def _maybe_early_stop(self, trial: Obj, status: dict, req: Request) -> Optional[Result]:
        """medianstop (upstream katib earlystopping): stop a running trial
        whose current objective is worse than the median of completed
        siblings' final objectives.  Queries the observation store (reconcile
        already collected any new log lines into it) — no log re-parsing."""
        es = trial["spec"].get("earlyStopping") or {}
        if es.get("algorithmName") != "medianstop":
            return None
        settings = {s["name"]: s["value"] for s in es.get("algorithmSettings", [])}
        min_trials = int(settings.get("min_trials_required", 3))

        exp_name = trial["metadata"].get("labels", {}).get(kapi.LABEL_EXPERIMENT, "")
        siblings = self.api.list(
            "Trial", namespace=req.namespace,
            label_selector={kapi.LABEL_EXPERIMENT: exp_name},
        )
        metric = trial["spec"]["objective"]["objectiveMetricName"]
        sign = 1.0 if trial["spec"]["objective"]["type"] == "maximize" else -1.0
        finals = []
        for t in siblings:
            if t["metadata"]["name"] == trial["metadata"]["name"]:
                continue
            if not has_condition(t.get("status", {}), kapi.SUCCEEDED):
                continue
            for m in t["status"].get("observation", {}).get("metrics", []):
                if m["name"] == metric:
                    finals.append(sign * float(m["latest"]))
        if len(finals) < min_trials:
            return Result(requeue_after=0.3)

        latest = self.store.latest(req.name, metric)
        if latest is None:
            return Result(requeue_after=0.3)
        current = sign * latest
        finals.sort()
        median = finals[len(finals) // 2]
        if current >= median:
            return Result(requeue_after=0.3)

        # stop: kill the job (pods cascade), keep the partial observation
        run_kind = trial["spec"]["runSpec"].get("kind", "TPUJob")
        self.api.try_delete(run_kind, req.name, req.namespace)
        status["observation"] = self.store.observation(req.name, self._metric_names(trial))
        set_condition(status, kapi.EARLY_STOPPED, "True", "TrialEarlyStopped",
                      f"{metric}={sign * current} worse than median {sign * median}")
        set_condition(status, kapi.SUCCEEDED, "True", "TrialEarlyStopped", "stopped early")
        set_condition(status, kapi.RUNNING, "False", "TrialEarlyStopped", "")
        self.recorder.normal(trial, "TrialEarlyStopped",
                             f"{metric} {sign * current} < median {sign * median}")
        self.api.update_status(trial)
        return None


def _register_push_collector_webhook(api: APIServer, store: ObservationStore) -> None:
    """The Katib pod webhook (upstream ``[U:katib/pkg/webhook/v1beta1/pod/]``):
    mutate trial-job pods whose Trial asks for ``collector.kind: "Push"`` by
    appending the metrics-collector sidecar container.  The db-manager HTTP
    service starts lazily on the first injection."""
    if getattr(api, "_katib_push_webhook", False):
        return
    api._katib_push_webhook = True
    state: dict = {"server": None}

    def _close() -> None:
        if state["server"] is not None:
            state["server"].close()
            state["server"] = None

    api.add_teardown(_close)

    def _db_address() -> str:
        if state["server"] is None:
            from .dbmanager import DBManagerServer

            state["server"] = DBManagerServer(store)
        return state["server"].address

    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

    def inject(pod: Obj) -> None:
        labels = pod.get("metadata", {}).get("labels", {})
        jname = labels.get(tapi.LABEL_JOB_NAME)
        if not jname:
            return
        trial = api.try_get("Trial", jname, pod["metadata"].get("namespace", "default"))
        if trial is None:
            return
        spec = trial.get("spec", {})
        collector = (spec.get("metricsCollectorSpec") or {}).get("collector", {})
        if collector.get("kind") != "Push":
            return
        metric_names = [spec["objective"]["objectiveMetricName"]] + list(
            spec["objective"].get("additionalMetricNames", []))
        pod["spec"]["containers"].append({
            "name": "metrics-collector",
            "command": [sys.executable, "-u", "-m",
                        "kubeflow_tpu_torch.katib.collector_main"],
            "env": [
                {"name": "PYTHONPATH",
                 "value": repo_root + os.pathsep + "$(PYTHONPATH)"},
                {"name": "KATIB_DB_MANAGER", "value": _db_address()},
                {"name": "KATIB_TRIAL", "value": jname},
                {"name": "KATIB_METRICS", "value": ",".join(metric_names)},
            ],
        })

    api.register_mutating_webhook("Pod", inject)


def install(api: APIServer, manager, log_reader: Callable[[str, str], str],
            store: Optional[ObservationStore] = None,
            store_path: Optional[str] = None):
    """Register Katib CRDs + controllers on a Manager."""
    kapi.register(api)
    if store is None:
        store = ObservationStore(store_path)
    _register_push_collector_webhook(api, store)
    exp = ExperimentController(api)
    sug = SuggestionController(api)
    trial = TrialController(api, log_reader, store)
    manager.add(exp, owns=("Trial", "Suggestion"))
    manager.add(sug, watches=((
        "Trial",
        lambda obj: Request(
            obj["metadata"].get("labels", {}).get(kapi.LABEL_EXPERIMENT, ""),
            obj["metadata"].get("namespace", "default"),
        ) if obj["metadata"].get("labels", {}).get(kapi.LABEL_EXPERIMENT) else None,
    ),))
    # "Pod" covers bare-Pod trials (runSpec kind Pod): the pod carries the
    # trial's ownerReference, so its phase flips requeue the trial the same
    # way a training job's condition flips do
    manager.add(trial, owns=tuple(tapi.JOB_KINDS) + ("Pod",))
    return exp, sug, trial
