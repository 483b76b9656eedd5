"""Port parity: kubeflow_tpu_torch's ``parallel.distributed`` against the
JAX package's, and a world-2 ``gloo`` group formed through ``initialize``.

``read_env`` reads the JAX package's variables and, where no coordinator is
set, the PyTorchJob rendezvous that the JAX ResNet worker maps onto them
(``_map_torch_env``); the reference here is the JAX ``read_env`` of the
environment after that mapping."""

import multiprocessing as mp
import os
import socket

import pytest
import torch

from kubeflow_tpu.examples import resnet_ddp_worker as jworker
from kubeflow_tpu.parallel import distributed as jdist
from kubeflow_tpu_torch.parallel import distributed as tdist

ENVS = [
    {},
    {"JAX_COORDINATOR_ADDRESS": "10.0.0.1:1234", "JAX_NUM_PROCESSES": "4",
     "JAX_PROCESS_ID": "2", "MEGASCALE_NUM_SLICES": "2", "MEGASCALE_SLICE_ID": "1"},
    {"MASTER_ADDR": "job-master-0", "MASTER_PORT": "23456", "WORLD_SIZE": "3", "RANK": "1"},
    {"MASTER_ADDR": "job-master-0", "WORLD_SIZE": "2", "RANK": "0"},
    # the JAX coordinator wins over the torch rendezvous, as in the mapping
    {"MASTER_ADDR": "m", "WORLD_SIZE": "8", "RANK": "5",
     "JAX_COORDINATOR_ADDRESS": "c:1", "JAX_NUM_PROCESSES": "2", "JAX_PROCESS_ID": "1"},
]


@pytest.mark.parametrize("env", ENVS, ids=range(len(ENVS)))
def test_read_env_matches_jax(env, monkeypatch):
    mapped = dict(env)
    monkeypatch.setattr(os, "environ", mapped)
    jworker._map_torch_env()  # mutates the (patched) os.environ
    monkeypatch.undo()
    want = jdist.read_env(mapped)
    got = tdist.read_env(env)
    assert (got.coordinator_address, got.num_processes, got.process_id, got.num_slices,
            got.slice_id, got.is_distributed) == (
        want.coordinator_address, want.num_processes, want.process_id, want.num_slices,
        want.slice_id, want.is_distributed)


def test_single_process_is_a_noop_and_more_devices_are_refused(monkeypatch):
    for k in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "MASTER_ADDR", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    penv = tdist.initialize(local_device_count=1, device="cpu")
    assert not penv.is_distributed
    assert not torch.distributed.is_initialized()
    # one process: N local devices are N mesh shards on its device
    penv = tdist.initialize(local_device_count=2, device="cpu")
    assert not penv.is_distributed and not torch.distributed.is_initialized()
    assert tdist.process_count() == 1 and tdist.process_index() == 0
    # several processes with N local devices each now join a mesh across
    # processes: tests/test_torch_mesh_processes.py and
    # tests/test_torch_trainer_processes.py start such gangs


def _member(rank: int, port: int, q) -> None:
    try:
        os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE="2",
                          RANK=str(rank))
        penv = tdist.initialize(device="cpu")
        t = torch.tensor([float(rank + 1), 10.0 * (rank + 1)])
        torch.distributed.all_reduce(t)
        q.put((rank, (penv.num_processes, penv.process_id,
                      torch.distributed.get_backend(), t.tolist())))
        torch.distributed.destroy_process_group()
    except Exception as e:  # noqa: BLE001 — reported to the parent
        q.put((rank, f"{type(e).__name__}: {e}"))


def test_world_two_gloo_group_allreduces():
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [ctx.Process(target=_member, args=(r, port, q)) for r in range(2)]
    for p in procs:
        p.start()
    try:
        results = dict(q.get(timeout=90) for _ in range(2))
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
    assert results == {0: (2, 0, "gloo", [3.0, 30.0]), 1: (2, 1, "gloo", [3.0, 30.0])}
