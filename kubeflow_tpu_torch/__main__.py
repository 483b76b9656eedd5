"""``python -m kubeflow_tpu_torch`` — the kfctl/kubectl-shaped CLI.

Counterpart of ``kubeflow_tpu/__main__.py`` over the port's cluster, KfAdm
and operators.  The port schedules GPU nodes, not TPU slices:
``--gpu-node NAME:ACCELERATOR:COUNT`` adds one (as ``Cluster(gpu_nodes=…)``
does), and ``--tpu-slice`` is still parsed but refused with a message that
names ``--gpu-node``.

Upstream analogues (UNVERIFIED, SURVEY.md §3.1/§3.2): ``kfctl apply -V -f
kfdef.yaml`` deploys the platform from a KfDef spec, and ``kubectl apply -f
tfjob.yaml`` submits a workload CR that the operators reconcile.  Here both
verbs drive ONE in-process cluster session: bring it up, install the
pillars (KfAdm), apply every document in the given files, optionally wait
for each object's terminal/ready condition, print a ``kubectl get``-style
summary (and pod logs with ``--logs``), then tear the cluster down.

The session is one-shot because the "cluster" is in-process by design
(SURVEY.md §7: API simulator + local-process kubelet, no daemons); a file
can carry a whole scenario — KfDef + Profile + TPUJob + InferenceService —
as multi-doc YAML, exactly like a kubectl manifest bundle.
"""

from __future__ import annotations

import argparse
import json
import sys

from .core.conditions import get_condition
from .training import api as tapi

TRAINING_KINDS = set(tapi.JOB_KINDS)
# kinds whose wait target is a terminal Succeeded/Failed condition
TERMINAL_KINDS = TRAINING_KINDS | {"Experiment", "Trial"}
# kinds whose wait target is Ready=True (steady-state services)
READY_KINDS = {"InferenceService", "Notebook"}


def _load_docs(paths: list[str]) -> list[dict]:
    import yaml

    docs: list[dict] = []
    for path in paths:
        text = sys.stdin.read() if path == "-" else open(path).read()
        for doc in yaml.safe_load_all(text):
            if doc is None:
                continue
            if not isinstance(doc, dict) or "kind" not in doc:
                raise SystemExit(f"{path}: every document needs a 'kind' (got {type(doc).__name__})")
            docs.append(doc)
    return docs


def _parse_gpu_node(arg: str) -> tuple[str, str, int]:
    parts = arg.split(":")
    if len(parts) != 3 or not parts[2].isdigit() or int(parts[2]) < 1:
        raise SystemExit(f"--gpu-node wants NAME:ACCELERATOR:COUNT, got {arg!r}")
    return (parts[0], parts[1], int(parts[2]))


def _refuse_slices(slices: list[str]) -> None:
    if slices:
        raise SystemExit(f"--tpu-slice {slices[0]!r}: this platform schedules GPU nodes, "
                         "not TPU slices; use --gpu-node NAME:ACCELERATOR:COUNT "
                         "(e.g. gpu-a:h100:8)")


def _status_of(obj: dict) -> str:
    """One word for the summary table, kubectl-style."""
    kind = obj.get("kind", "")
    status = obj.get("status") or {}
    if kind == "Pod":
        return status.get("phase", "Pending")
    for ctype in ("Succeeded", "Failed", "Ready", "Running", "Created"):
        c = get_condition(status, ctype)
        if c is not None and c.get("status") == "True":
            return ctype
    return status.get("phase", "Applied")


def _wait_one(cluster, obj: dict, timeout: float) -> str:
    kind = obj["kind"]
    name = obj["metadata"]["name"]
    ns = obj["metadata"].get("namespace", "default")

    def fresh() -> dict:
        return cluster.api.try_get(kind, name, ns) or obj

    if kind in TERMINAL_KINDS:
        def done() -> bool:
            return _status_of(fresh()) in ("Succeeded", "Failed")
    elif kind in READY_KINDS:
        def done() -> bool:
            return _status_of(fresh()) == "Ready"
    elif kind == "Pod":
        def done() -> bool:
            return _status_of(fresh()) in ("Succeeded", "Failed")
    else:
        cluster.settle()
        return _status_of(fresh())
    cluster.wait_for(done, timeout=timeout)
    return _status_of(fresh())


def _pod_logs(cluster, obj: dict) -> dict[str, str]:
    kind, ns = obj["kind"], obj["metadata"].get("namespace", "default")
    name = obj["metadata"]["name"]
    if kind == "Pod":
        return {name: cluster.logs(name, ns)}
    if kind in TRAINING_KINDS:
        selector = {tapi.LABEL_JOB_NAME: name}
    else:
        return {}
    pods = cluster.api.list("Pod", namespace=ns, label_selector=selector)
    return {p["metadata"]["name"]: cluster.logs(p["metadata"]["name"], ns) for p in pods}


def cmd_apply(args: argparse.Namespace) -> int:
    from .core.cluster import Cluster
    from .platform.kfadm import APPLICATIONS, KfAdm, kfdef

    _refuse_slices(args.tpu_slice)
    docs = _load_docs(args.filename)
    cluster = Cluster(
        cpu_nodes=args.cpu_nodes,
        gpu_nodes=tuple(_parse_gpu_node(s) for s in args.gpu_node),
    )
    exit_code = 0
    try:
        kfadm = KfAdm(cluster)
        apps = tuple(args.apps.split(",")) if args.apps else APPLICATIONS
        # platform bringup first: either the file's own KfDef docs, or (by
        # default) everything — workload CRDs must exist before apply
        kfdef_docs = [d for d in docs if d.get("kind") == "KfDef"] or [kfdef(applications=apps)]
        for d in kfdef_docs:
            applied = kfadm.apply(d)
            for app in applied["status"]["applications"]:
                print(f"kfadm: application {app['name']}: {app['status']}")

        applied_objs = []
        for doc in docs:
            if doc.get("kind") == "KfDef":
                continue
            obj = cluster.apply(doc)
            applied_objs.append(obj)
            print(f"applied {obj['kind']}/{obj['metadata']['name']}")

        results = []
        for obj in applied_objs:
            state = _wait_one(cluster, obj, args.timeout) if args.wait else _status_of(obj)
            results.append((obj, state))

        if results:
            width = max(len(f"{o['kind']}/{o['metadata']['name']}") for o, _ in results)
            print(f"\n{'NAME':<{width + 2}}{'NAMESPACE':<14}STATUS")
            for obj, state in results:
                ident = f"{obj['kind']}/{obj['metadata']['name']}"
                ns = obj["metadata"].get("namespace", "default")
                print(f"{ident:<{width + 2}}{ns:<14}{state}")
                wait_missed = args.wait and (
                    (obj["kind"] in TERMINAL_KINDS and state not in ("Succeeded", "Failed"))
                    or (obj["kind"] in READY_KINDS and state != "Ready")
                    or (obj["kind"] == "Pod" and state not in ("Succeeded", "Failed")))
                if state == "Failed" or wait_missed:
                    exit_code = 1

        if args.logs:
            for obj, _ in results:
                for pod, text in sorted(_pod_logs(cluster, obj).items()):
                    print(f"\n--- logs {pod} ---")
                    print(text.rstrip() if text else "<no output>")
    finally:
        cluster.shutdown()
    return exit_code


def cmd_components(_args: argparse.Namespace) -> int:
    """What a KfDef can install, and the workload kinds each app serves."""
    from .platform.kfadm import APPLICATIONS

    kinds = {
        "platform": ["Profile", "Notebook", "PodDefault", "KfDef"],
        "training": sorted(TRAINING_KINDS),
        "katib": ["Experiment", "Suggestion", "Trial"],
        "serving": ["InferenceService", "ServingRuntime", "ClusterServingRuntime", "TrainedModel"],
        "pipelines": ["Pipeline", "PipelineRun (via pipelines service API)"],
    }
    print(json.dumps({app: kinds[app] for app in APPLICATIONS}, indent=2))
    return 0


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m kubeflow_tpu_torch",
        description="Kubeflow-capability platform CLI (the PyTorch/CUDA port)",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    p_apply = sub.add_parser(
        "apply", help="bring up a cluster session, apply manifests, report status")
    p_apply.add_argument("-f", "--filename", action="append", required=True,
                         help="manifest file (YAML/JSON, multi-doc; '-' = stdin); repeatable")
    p_apply.add_argument("--wait", action="store_true",
                         help="wait for terminal/ready conditions before reporting")
    p_apply.add_argument("--logs", action="store_true", help="print pod logs at the end")
    p_apply.add_argument("--timeout", type=float, default=300.0,
                         help="per-object wait timeout seconds (default 300)")
    p_apply.add_argument("--cpu-nodes", type=int, default=1)
    p_apply.add_argument("--gpu-node", action="append", default=[],
                         metavar="NAME:ACC:COUNT",
                         help="add a GPU node, e.g. gpu-a:h100:8; repeatable")
    p_apply.add_argument("--tpu-slice", action="append", default=[],
                         metavar="NAME:ACC:TOPO",
                         help="refused: this platform schedules GPU nodes (--gpu-node)")
    p_apply.add_argument("--apps", default="",
                         help="comma-separated KfDef applications (default: all)")
    p_apply.set_defaults(func=cmd_apply)

    p_comp = sub.add_parser("components", help="list installable applications and their kinds")
    p_comp.set_defaults(func=cmd_components)

    args = parser.parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
