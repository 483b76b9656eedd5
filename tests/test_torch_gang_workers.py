"""Port parity: the workers as gangs of processes over the mesh across
processes, on the CPU over ``gloo``.

- The twin of tests/test_training_jobs.py's
  ``test_tpujob_gang_restart_on_single_worker_failure`` on
  ``kubeflow_tpu_torch.examples.bert_worker``, through the reference
  training control plane, with that test's environment and assertions:
  worker 1 of 2 preempted at step 5 (exit 137) restarts the WHOLE gang
  (its survivor exits 143 when its collective loses the peer, retryable),
  both members resume from the same checkpoint and finish.
- The ResNet worker at world 2 x ``LOCAL_DEVICES=2`` over the global
  ``MeshConfig(data=4)``: the JAX worker's last two lines, and the loss of
  the port's one-process ``LOCAL_DEVICES=4`` run on the same global batch.
Every pod, process and wait has a timeout of its own."""

import os
import re
import subprocess
import sys

import pytest

from kubeflow_tpu.core.cluster import Cluster
from kubeflow_tpu.training import api as tapi
from kubeflow_tpu.training.api import ReplicaSpec, job
from kubeflow_tpu.training.client import TrainingClient
from kubeflow_tpu.training.frameworks import install
from test_torch_mesh_processes import free_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the worker's bf16 ResNet-50 at 32x32, 10 classes, 2 images a position
RESNET = dict(NUM_CLASSES="10", IMAGE_SIZE="32", PER_CHIP_BATCH="2", TRAIN_STEPS="1")
# SGD at 0.1 with momentum sends the loss to ~36.6 after the warm-up step;
# the two runs sum a replicated leaf's bf16 gradient in another order (the
# one process over 4 positions, each process over 2 and then across), so
# the losses part by a few bf16 roundings: 1e-3 relative to the loss
RESNET_LOSS_RTOL = 1e-3


@pytest.fixture()
def tcluster():
    c = Cluster(cpu_nodes=1, tpu_slices=(("s0", "v5e", "2x4"),))
    install(c.api, c.manager)
    yield c
    c.shutdown()


def test_tpujob_gang_restart_on_single_worker_failure(tcluster, tmp_path):
    spec = job(
        "TPUJob",
        "gangres",
        {"Worker": ReplicaSpec(
            replicas=2,
            restart_policy="ExitCode",
            command=[sys.executable, "-u", "-m", "kubeflow_tpu_torch.examples.bert_worker"],
            env={
                "TORCH_DEVICE": "cpu", "PYTHONPATH": REPO, "OMP_NUM_THREADS": "2",
                "TRAIN_STEPS": "10", "FAIL_AT_STEP": "5", "FAIL_RANK": "1",
                "FAIL_MARKER": str(tmp_path / "died"),
            },
        )},
    )
    spec["spec"]["checkpoint"] = {"dir": str(tmp_path / "ckpt"), "everySteps": 2}
    client = TrainingClient(tcluster)
    client.create_job(spec)
    assert client.wait_for_job("TPUJob", "gangres", timeout=240) == tapi.SUCCEEDED
    j = client.get_job("TPUJob", "gangres")
    assert j["status"]["restartCount"] == 1  # one gang restart, not per-pod
    events = [e.get("reason") for e in tcluster.api.list("Event")]
    assert "SliceRestarting" in events
    # BOTH workers ran twice: fresh (resumed_from=0) then resumed from a
    # durable checkpoint, the same one
    resumed = []
    for w in (0, 1):
        log = tcluster.logs(f"gangres-worker-{w}")
        resumes = [int(m) for m in re.findall(r"resumed_from=(\d+)", log)]
        assert len(resumes) == 2 and resumes[0] == 0 and resumes[1] > 0, (w, resumes)
        assert "TRAIN-DONE step=10" in log
        second = log.split(f"resumed_from={resumes[1]}", 1)[1]
        assert "step=1 " not in second and f"step={resumes[1] + 1} " in second
        resumed.append((resumes[1], [line for line in second.splitlines()
                                     if line.startswith("step=")]))
    assert resumed[0] == resumed[1]  # the same step, the same losses


def _resnet(env: dict, world: int) -> list:
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "kubeflow_tpu_torch.examples.resnet_ddp_worker"], cwd=REPO,
        env=dict(os.environ, TORCH_DEVICE="cpu", PYTHONPATH=REPO, OMP_NUM_THREADS="2",
                 MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE=str(world),
                 RANK=str(r), **RESNET, **env),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    return [out.strip().splitlines() for out, _ in outs]


def test_resnet_worker_at_world_two_on_the_global_data_mesh():
    one = _resnet({"LOCAL_DEVICES": "4"}, 1)[0]
    assert one[-2:] == ["world size=1 global devices=4", "RESNET-DDP-OK"]
    want = float(one[0].split("=")[1])
    for lines in _resnet({"LOCAL_DEVICES": "2"}, 2):
        assert lines[-2:] == ["world size=2 global devices=4", "RESNET-DDP-OK"]
        got = float(lines[0].split("=")[1])
        assert abs(got - want) <= RESNET_LOSS_RTOL * abs(want), (got, want)
