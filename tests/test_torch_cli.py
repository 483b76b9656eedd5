"""Port parity: the CLI (``python -m kubeflow_tpu_torch``), the twin of
``python -m kubeflow_tpu`` (tests/test_cli.py's three tests), run as real
subprocesses that own their cluster session.

The port schedules GPU nodes: ``--gpu-node NAME:ACCELERATOR:COUNT`` adds one
to the session's ``Cluster(gpu_nodes=...)``, and ``--tpu-slice`` is parsed
and refused (exit 1) with a message that names ``--gpu-node``.  The TPUJob
apply stays in the slow lane, as the reference's does."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

DOOMED = """
apiVersion: kubeflow.org/v1
kind: TPUJob
metadata: {name: doomed}
spec:
  runPolicy: {backoffLimit: 0}
  replicaSpecs:
    Worker:
      replicas: 1
      template:
        spec:
          containers:
          - name: main
            command: [python, -c, "raise SystemExit(3)"]
"""


def _cli(*args: str, pkg: str = "kubeflow_tpu_torch", timeout: float = 180.0):
    env = dict(os.environ)
    parts = [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
    env["PYTHONPATH"] = os.pathsep.join(dict.fromkeys(parts))
    env["JAX_PLATFORMS"] = "cpu"
    env["TORCH_DEVICE"] = "cpu"
    return subprocess.run([sys.executable, "-m", pkg, *args], capture_output=True,
                          text=True, timeout=timeout, env=env, cwd=REPO)


def _manifest(text: str) -> str:
    with tempfile.NamedTemporaryFile("w", suffix=".yaml", delete=False) as f:
        f.write(text)
    return f.name


@pytest.mark.slow
def test_cli_apply_tpujob_example_succeeds():
    proc = _cli("apply", "-f", os.path.join(REPO, "examples", "tpujob.yaml"),
                "--wait", "--logs", "--apps", "training")
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = proc.stdout
    assert "kfadm: application training: Ready" in out
    assert "TPUJob/rendezvous-demo" in out and "Succeeded" in out
    assert "worker 0 of 2 coordinator" in out
    assert "worker 1 of 2 coordinator" in out


def test_cli_apply_failing_pod_exits_nonzero():
    path = _manifest(DOOMED)
    try:
        proc = _cli("apply", "-f", path, "--wait", "--apps", "training")
    finally:
        os.unlink(path)
    assert proc.returncode == 1, proc.stdout + proc.stderr[-1000:]
    assert "Failed" in proc.stdout
    assert "kfadm: application training: Ready" in proc.stdout


def test_cli_components_lists_every_pillar():
    port = _cli("components", timeout=60)
    ref = _cli("components", pkg="kubeflow_tpu", timeout=60)
    assert port.returncode == 0, port.stderr[-1000:]
    listing = json.loads(port.stdout)
    assert set(listing) == {"platform", "training", "katib", "serving", "pipelines"}
    assert "TPUJob" in listing["training"] and "InferenceService" in listing["serving"]
    assert listing == json.loads(ref.stdout)


def test_cli_refuses_a_tpu_slice_and_names_gpu_node():
    proc = _cli("apply", "-f", os.path.join(REPO, "examples", "tpujob.yaml"),
                "--tpu-slice", "slice-a:v5e:2x4", timeout=60)
    assert proc.returncode == 1
    assert "--gpu-node" in proc.stderr and "slice-a:v5e:2x4" in proc.stderr
    assert proc.stdout == ""  # refused before any cluster came up


def test_cli_document_errors_keep_the_reference_texts_and_codes(tmp_path):
    bad = tmp_path / "bad.yaml"
    bad.write_text("- just\n- a list\n")
    port = _cli("apply", "-f", str(bad), timeout=60)
    ref = _cli("apply", "-f", str(bad), pkg="kubeflow_tpu", timeout=60)
    assert port.returncode == ref.returncode == 1
    assert port.stderr.strip() == ref.stderr.strip()
    assert "every document needs a 'kind'" in port.stderr
    gpu = _cli("apply", "-f", os.path.join(REPO, "examples", "tpujob.yaml"),
               "--gpu-node", "g0:h100", timeout=60)
    assert gpu.returncode == 1 and "NAME:ACCELERATOR:COUNT" in gpu.stderr


def test_gpu_node_is_parsed_into_the_cluster(monkeypatch):
    """``--gpu-node`` reaches ``Cluster(gpu_nodes=...)`` as (name,
    accelerator, count) tuples, repeatable; the session is shut down."""
    from kubeflow_tpu_torch import __main__ as cli
    from kubeflow_tpu_torch.core import cluster as cluster_mod

    seen = {}

    class FakeCluster:
        def __init__(self, cpu_nodes=1, gpu_nodes=()):
            seen["args"] = (cpu_nodes, gpu_nodes)

        def shutdown(self):
            seen["shutdown"] = True

    class FakeKfAdm:
        def __init__(self, cluster):
            pass

        def apply(self, doc):
            return {"status": {"applications": []}}

    import kubeflow_tpu_torch.platform.kfadm as kfadm_mod

    monkeypatch.setattr(cluster_mod, "Cluster", FakeCluster)
    monkeypatch.setattr(kfadm_mod, "KfAdm", FakeKfAdm)
    path = _manifest("kind: KfDef\nmetadata: {name: k}\nspec: {}\n")
    try:
        rc = cli.main(["apply", "-f", path, "--cpu-nodes", "2",
                       "--gpu-node", "g0:h100:8", "--gpu-node", "g1:h100:2"])
    finally:
        os.unlink(path)
    assert rc == 0
    assert seen == {"args": (2, (("g0", "h100", 8), ("g1", "h100", 2))), "shutdown": True}
    with pytest.raises(SystemExit, match="NAME:ACCELERATOR:COUNT"):
        cli._parse_gpu_node("g0:h100:zero")
