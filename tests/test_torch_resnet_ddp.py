"""The port's ResNet-50 DDP worker on both of its paths, on the CPU.

* The default path at world 2 over ``gloo``: each rank's mean-reduced
  gradient (``dist_mean`` over its local half) equals the global-batch
  gradient, and the worker's printout is the JAX worker's.
* The shim path as a PyTorchJob with Master + 1 Worker through the JAX
  package's control plane, as tests/test_transport.py drives the JAX worker
  with 4 ranks (2 here, to bound the time): both ranks print one loss,
  within 5e-2 of a single-process run on the same global batch.

Every process, pod and queue wait has a timeout of its own."""

import json
import multiprocessing as mp
import os
import random
import socket
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = [sys.executable, "-u", "-m", "kubeflow_tpu_torch.examples.resnet_ddp_worker"]
# the worker's bf16 ResNet-50 at 32x32, 10 classes, 2 images a rank
SMALL = dict(num_classes=10, image_size=32, per_chip_batch=2)
# the shim's loss against one process (tests/test_transport.py:181)
LOSS_GAP = 5e-2


def _port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _ring_master_port(world: int) -> int:
    """A MASTER_PORT whose ring ports (MASTER_PORT + 1000 + rank, the
    shim's listeners) and itself are free: below the kernel's ephemeral
    range, where no outgoing connection of a concurrent process takes a
    local port (a MASTER_PORT picked by binding port 0 is ephemeral, and so
    is its +1000), and bind-checked here."""
    lo = int(open("/proc/sys/net/ipv4/ip_local_port_range").read().split()[0])
    rng = random.Random(os.getpid() ^ time.monotonic_ns())
    for _ in range(200):
        port = rng.randrange(10000, lo - 1000 - world)
        try:
            for p in [port] + [port + 1000 + r for r in range(world)]:
                with socket.socket() as s:
                    s.bind(("", p))
        except OSError:
            continue
        return port
    raise RuntimeError("no free rendezvous ports below the ephemeral range")


def _rank_grads(rank: int, port: int, q) -> None:
    """One rank of the default path: its gradients mean-reduced over the
    group, against the gradient of the whole global batch computed here in
    one piece; returns the worst gap of each leaf relative to its largest
    entry."""
    try:
        os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE="2",
                          RANK=str(rank))
        torch.set_num_threads(2)
        from kubeflow_tpu_torch.examples import resnet_ddp_worker as W
        from kubeflow_tpu_torch.models import resnet
        from kubeflow_tpu_torch.parallel.distributed import initialize

        dev = torch.device("cpu")
        penv = initialize(device=dev)
        config, params, leaves, _, _ = W.make_model(SMALL["num_classes"], dev)

        def grads(imgs, lbls):
            loss = resnet.loss(params, config, torch.from_numpy(imgs), torch.from_numpy(lbls))
            return dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))

        b = (SMALL["per_chip_batch"], SMALL["image_size"], SMALL["num_classes"])
        local = W.dist_mean(grads(*W.local_batch(1, 2, penv.process_id, *b)))
        whole = grads(*W.local_batch(1, 1, 0, 2 * b[0], *b[1:]))
        gaps = {n: float((local[n].float() - whole[n].float()).abs().max()
                         / whole[n].float().abs().max().clamp(min=1e-30)) for n in leaves}
        torch.distributed.destroy_process_group()
        q.put((rank, gaps))
    except Exception as e:  # noqa: BLE001 — reported to the parent
        q.put((rank, f"{type(e).__name__}: {e}"))


def test_default_path_mean_reduced_grads_equal_the_global_batch_gradient():
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = _port()
    procs = [ctx.Process(target=_rank_grads, args=(r, port, q)) for r in range(2)]
    for p in procs:
        p.start()
    try:
        results = dict(q.get(timeout=300) for _ in range(2))
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
    assert all(isinstance(v, dict) for v in results.values()), results
    for rank, gaps in results.items():
        assert len(gaps) == 161  # ResNet-50's leaves
        # bf16 gradients: each half is rounded to bf16 and gloo sums the
        # halves in bf16, where the global gradient is rounded once; a leaf
        # may differ by a few bf16 ulps (2**-8 each) of its largest entry
        worst = max(gaps.values())
        assert worst <= 4 * 2.0 ** -8, (rank, sorted(gaps.items(), key=lambda kv: -kv[1])[:5])


def _env(**kw) -> dict:
    env = dict(os.environ, TORCH_DEVICE="cpu", PYTHONPATH=REPO, TRAIN_STEPS="2",
               IMAGE_SIZE=str(SMALL["image_size"]), NUM_CLASSES=str(SMALL["num_classes"]),
               OMP_NUM_THREADS="2")
    env.update({k: str(v) for k, v in kw.items()})
    return env


def _loss(stdout: str) -> float:
    return next(float(line.split("=")[1]) for line in stdout.splitlines()
                if line.startswith("loss="))


def test_default_path_prints_the_jax_lines_at_world_two():
    port = _port()
    procs = [subprocess.Popen(WORKER, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=_env(MASTER_ADDR="127.0.0.1", MASTER_PORT=port,
                                                  WORLD_SIZE=2, RANK=r, PER_CHIP_BATCH=2))
             for r in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=300)
            assert p.returncode == 0, err[-3000:]
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for out in outs:
        lines = out.strip().splitlines()
        assert [line.split("=")[0] for line in lines[:3]] == [
            "loss", "samples_per_sec", "samples_per_sec_per_chip"]
        assert lines[3:] == ["world size=2 global devices=2", "RESNET-DDP-OK"]
    assert _loss(outs[0]) == _loss(outs[1])


def test_shim_path_through_the_control_plane_matches_one_process():
    from kubeflow_tpu.core.cluster import Cluster
    from kubeflow_tpu.training import api as tapi
    from kubeflow_tpu.training.api import ReplicaSpec, job
    from kubeflow_tpu.training.client import TrainingClient
    from kubeflow_tpu.training.common import PORTS_ANNOTATION
    from kubeflow_tpu.training.frameworks import install

    wenv = {"TORCH_DEVICE": "cpu", "PYTHONPATH": REPO, "DDP_TRANSPORT": "shim",
            "TRAIN_STEPS": "2", "PER_CHIP_BATCH": "2", "IMAGE_SIZE": str(SMALL["image_size"]),
            "NUM_CLASSES": str(SMALL["num_classes"]), "OMP_NUM_THREADS": "2"}
    c = Cluster(cpu_nodes=1)
    install(c.api, c.manager)
    try:
        spec = job("PyTorchJob", "torch-resnet-shim", {
            "Master": ReplicaSpec(replicas=1, command=WORKER, env=dict(wenv)),
            "Worker": ReplicaSpec(replicas=1, command=WORKER, env=dict(wenv))})
        # the job's rendezvous port, set as the controller would pick it, so
        # that the ring's listeners do not land on an ephemeral port another
        # process of a parallel test run holds (a rendezvous failure, seen
        # under six test workers)
        spec["metadata"]["annotations"] = {PORTS_ANNOTATION: json.dumps([_ring_master_port(2)])}
        client = TrainingClient(c)
        client.create_job(spec)
        state = client.wait_for_job("PyTorchJob", "torch-resnet-shim", timeout=300)
        logs = "\n".join(client.get_job_logs("PyTorchJob", "torch-resnet-shim").values())
        assert state == tapi.SUCCEEDED, logs[-3000:]
    finally:
        c.shutdown()
    assert logs.count("transport=shim") == 2 and logs.count("RESNET-DDP-OK") == 2
    assert logs.count("world size=2 global devices=2") == 2
    shim = {float(line.split("=")[1]) for line in logs.splitlines() if line.startswith("loss=")}
    assert len(shim) == 1, f"ranks disagree: {shim}"

    # one process on the same global batch (2 ranks x 2 = 4 images)
    r = subprocess.run(WORKER, cwd=REPO, capture_output=True, text=True, timeout=300,
                       env=_env(DDP_TRANSPORT="shim", RANK=0, WORLD_SIZE=1, PER_CHIP_BATCH=4,
                                TRAIN_STEPS=2, MASTER_PORT=_port()))
    assert "RESNET-DDP-OK" in r.stdout, r.stderr[-3000:]
    gap = abs(_loss(r.stdout) - shim.pop())
    print(f"shim vs one process: loss gap {gap:.6f}")
    assert gap < LOSS_GAP, gap
