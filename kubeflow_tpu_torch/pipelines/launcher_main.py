"""Step-pod launcher: run one component function inside its pod.

A copy of ``kubeflow_tpu/pipelines/launcher_main.py`` with the port's
``dsl`` names in scope.  It reads the ``task.json`` the workflow controller
writes into the node workspace (``functionName``, ``source``, ``defaults``,
``parameters``, ``inputArtifacts``, ``outputArtifacts``,
``outputParameters``, ``storeRoot``), stages the input artifacts from the
object store, exec's the component source, uploads the outputs and writes
``outputs.json`` (output parameters and artifact metadata) atomically.
Each staged copy is logged as one ``LAUNCHER`` line on stdout (operation,
artifact, bytes, seconds); ``outputs.json`` is the reference's.

    python -m kubeflow_tpu_torch.pipelines.launcher_main <workspace-dir>
"""

from __future__ import annotations

import json
import os
import sys
import time
import traceback


def _nbytes(path: str) -> int:
    if os.path.isfile(path):
        return os.path.getsize(path)
    return sum(os.path.getsize(os.path.join(root, f))
               for root, _, files in os.walk(path) for f in files)


def _staged(op: str, aname: str, path: str, t0: float) -> None:
    """One line per staged copy: what moved, how many bytes, in how long."""
    print(f"LAUNCHER op={op} artifact={aname} bytes={_nbytes(path)} "
          f"seconds={time.perf_counter() - t0:.6f}", flush=True)


def run(workspace: str) -> int:
    from kubeflow_tpu_torch.pipelines import dsl
    from kubeflow_tpu_torch.pipelines.artifacts import ObjectStore

    with open(os.path.join(workspace, "task.json")) as f:
        task = json.load(f)
    store = ObjectStore(task["storeRoot"])

    kwargs: dict = dict(task["defaults"])
    kwargs.update(task["parameters"])

    staged_in = os.path.join(workspace, "inputs")
    staged_out = os.path.join(workspace, "outputs")
    os.makedirs(staged_in, exist_ok=True)
    os.makedirs(staged_out, exist_ok=True)

    for aname, art in task["inputArtifacts"].items():
        cls = dsl.ARTIFACT_TYPES.get(art.get("type", "system.Artifact"), dsl.Artifact)
        a = cls(name=aname, uri=art["uri"], metadata=art.get("metadata", {}))
        t0 = time.perf_counter()
        a.path = store.get(art["uri"], os.path.join(staged_in, aname))
        _staged("get", aname, a.path, t0)
        kwargs[aname] = a

    out_objs: dict = {}
    for aname, art in task["outputArtifacts"].items():
        cls = dsl.ARTIFACT_TYPES.get(art["type"], dsl.Artifact)
        a = cls(name=aname, uri=art["uri"])
        a.path = os.path.join(staged_out, aname)
        out_objs[aname] = a
        kwargs[aname] = a

    # exec the component source with the dsl names lightweight components use
    ns: dict = {
        "dsl": dsl,
        "Input": dsl.Input,
        "Output": dsl.Output,
        "Artifact": dsl.Artifact,
        "Dataset": dsl.Dataset,
        "Model": dsl.Model,
        "Metrics": dsl.Metrics,
    }
    exec(compile(task["source"], f"<component {task['functionName']}>", "exec"), ns)
    fn = ns[task["functionName"]]

    ret = fn(**kwargs)

    outputs: dict = {"outputParameters": {}, "artifactMetadata": {}}
    if "Output" in task["outputParameters"]:
        outputs["outputParameters"]["Output"] = ret
    for aname, a in out_objs.items():
        if os.path.exists(a.path):
            t0 = time.perf_counter()
            store.put(a.uri, a.path)
            _staged("put", aname, a.path, t0)
        outputs["artifactMetadata"][aname] = a.metadata

    # tmp+os.replace: the workflow controller polls for this file — it
    # must never observe a half-written doc (graftlint atomic-write)
    out_path = os.path.join(workspace, "outputs.json")
    with open(out_path + ".tmp", "w") as f:
        json.dump(outputs, f)
    os.replace(out_path + ".tmp", out_path)
    return 0


def main() -> int:
    if len(sys.argv) != 2:
        print("usage: launcher_main <workspace>", file=sys.stderr)
        return 2
    try:
        return run(sys.argv[1])
    except Exception:
        traceback.print_exc()
        return 1


if __name__ == "__main__":
    sys.exit(main())
