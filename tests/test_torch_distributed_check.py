"""Port parity: ``kubeflow_tpu_torch.examples.distributed_check`` against the
JAX package's ``examples/distributed_check.py``.

- A TPUJob of 2 workers through the reference training control plane (as
  tests/test_training_jobs.py:30-49 runs the JAX module), with the port's
  module as the command and ``TORCH_DEVICE=cpu``: gloo forms the group from
  the injected rendezvous env, the cross-process sum gives 3.0 and both
  ranks print the same falling losses.
- The data-parallel step held to a JAX ``pmap`` + ``psum`` step over 2 host
  devices on the same numpy weights and data: losses and weights after 5
  steps within 1e-5 (f32)."""

import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.core.cluster import Cluster
from kubeflow_tpu.training import api as tapi
from kubeflow_tpu.training.api import ReplicaSpec, job
from kubeflow_tpu.training.client import TrainingClient
from kubeflow_tpu.training.frameworks import install
from kubeflow_tpu_torch.examples import distributed_check as DC

REPO = __file__.rsplit("/tests/", 1)[0]
F32_TOL = 1e-5


def _jax_steps(w: np.ndarray, xs: np.ndarray, ys: np.ndarray, steps: int = DC.STEPS):
    """The JAX worker's step (kubeflow_tpu/examples/distributed_check.py:
    43-54) over ``len(xs)`` host devices, one shard each."""
    n = len(xs)

    def loss_fn(w, x, y):
        return jnp.mean((x @ w - y) ** 2)

    step = jax.pmap(
        lambda w, x, y: (
            w - DC.LR * jax.lax.psum(jax.grad(loss_fn)(w, x, y), "batch"),
            jax.lax.psum(loss_fn(w, x, y), "batch"),
        ),
        axis_name="batch", devices=jax.devices("cpu")[:n])
    ws = jnp.broadcast_to(jnp.asarray(w), (n,) + w.shape)
    losses = []
    for _ in range(steps):
        ws, loss = step(ws, jnp.asarray(xs), jnp.asarray(ys))
        losses.append(float(loss[0]))
    return np.asarray(ws[0]), losses


def _two_ranks():
    """An in-place sum over two ranks run as threads of this process."""
    barrier = threading.Barrier(2)
    slots = [None, None]

    def for_rank(r):
        def all_reduce(t):
            slots[r] = t.clone()
            barrier.wait()
            total = slots[0] + slots[1]
            barrier.wait()
            t.copy_(total)
        return all_reduce

    return for_rank


def test_draws_follow_the_workers_law():
    w, x, y = DC.draw(0)
    assert (w.shape, x.shape, y.shape) == ((8, 4), (16, 8), (16, 4))
    assert w.dtype == x.dtype == y.dtype == np.float32
    np.testing.assert_array_equal(y[:, 0], np.sin(x.sum(-1)))
    assert not np.array_equal(DC.draw(1)[1], x)
    np.testing.assert_array_equal(DC.draw(1)[0], w)


@pytest.mark.parametrize("world", [1, 2])
def test_data_parallel_steps_match_jax_pmap(world):
    draws = [DC.draw(p) for p in range(world)]
    w0 = draws[0][0]
    xs = np.stack([d[1] for d in draws])
    ys = np.stack([d[2] for d in draws])
    jw, jlosses = _jax_steps(w0, xs, ys)

    results = [None] * world
    for_rank = _two_ranks() if world == 2 else (lambda r: (lambda t: None))

    def rank(r):
        results[r] = DC.train(torch.from_numpy(w0), torch.from_numpy(xs[r]),
                              torch.from_numpy(ys[r]), for_rank(r))

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    for tw, tlosses in results:
        np.testing.assert_allclose(tlosses, jlosses, rtol=F32_TOL, atol=F32_TOL)
        np.testing.assert_allclose(tw.numpy(), jw, rtol=F32_TOL, atol=F32_TOL)
    assert jlosses[-1] < jlosses[0]


@pytest.fixture()
def tcluster():
    c = Cluster(cpu_nodes=1, tpu_slices=(("s0", "v5e", "2x4"),))
    install(c.api, c.manager)
    yield c
    c.shutdown()


def test_tpujob_two_workers_over_gloo(tcluster):
    spec = job(
        "TPUJob",
        "distcheck",
        {"Worker": ReplicaSpec(
            replicas=2,
            command=[sys.executable, "-u", "-m", "kubeflow_tpu_torch.examples.distributed_check"],
            env={"TORCH_DEVICE": "cpu", "PYTHONPATH": REPO},
        )},
    )
    client = TrainingClient(tcluster)
    client.create_job(spec)
    assert client.wait_for_job("TPUJob", "distcheck", timeout=180) == tapi.SUCCEEDED
    logs = client.get_job_logs("TPUJob", "distcheck")
    assert len(logs) == 2
    draws = [DC.draw(p) for p in range(2)]
    _, jlosses = _jax_steps(draws[0][0], np.stack([d[1] for d in draws]),
                            np.stack([d[2] for d in draws]))
    for log in logs.values():
        lines = log.splitlines()
        assert "PSUM got=3.0 expected=3.0" in lines
        assert "TRAIN-OK" in lines
        assert any(line.startswith("RENDEZVOUS process=") and line.endswith(
            "/2 global_devices=2") for line in lines)
        losses = [float(line.split("loss=")[1]) for line in lines if line.startswith("STEP ")]
        # printed at 5 decimals, as the JAX worker prints them
        np.testing.assert_allclose(losses, jlosses, rtol=0, atol=F32_TOL)
