"""Port parity: kubeflow_tpu_torch's ring transport (its own copy of
``transport_core.cc``) against the collectives' numpy definitions, as
tests/test_transport.py checks the JAX package's, and ``grad_allreduce``
over a dict of tensors against the mean.

Every collective runs in real processes (spawned, so this file imports no
JAX: each child imports it).  Each wait has a timeout of its own, so a hang
fails the test instead of stalling the run."""

import multiprocessing as mp
import os
import socket

import numpy as np
import pytest
import torch

from kubeflow_tpu_torch.transport import RingTransport, grad_allreduce

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 90


def free_base_port(n: int) -> int:
    """A base port with ``n`` consecutive ports free right now, below the
    kernel's ephemeral range (where a concurrent process's outgoing
    connection can take a port between this check and the ring's bind) and
    above tests/test_transport.py's fixed ports (24800-25310, 26110-26114)."""
    lo = int(open("/proc/sys/net/ipv4/ip_local_port_range").read().split()[0])
    rng = np.random.default_rng()
    for _ in range(200):
        base = int(rng.integers(27000, lo - n))
        socks = []
        try:
            for p in range(base, base + n):
                s = socket.socket()
                socks.append(s)
                s.bind(("127.0.0.1", p))
            return base
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    raise RuntimeError("no free port range")


def _collectives(rank: int, world: int, port: int, q) -> None:
    try:
        with RingTransport(rank, world, base_port=port) as tr:
            x = np.random.default_rng(rank).standard_normal(1000).astype(np.float32)
            expect = np.sum([np.random.default_rng(r).standard_normal(1000).astype(np.float32)
                             for r in range(world)], axis=0)
            np.testing.assert_allclose(tr.allreduce(x.copy()), expect, rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(tr.allreduce(x.copy(), mean=True), expect / world,
                                       rtol=1e-5, atol=1e-5)
            rs = tr.reduce_scatter(x.copy())
            base, rem = divmod(1000, world)
            mine = (rank + 1) % world
            lo = mine * base + min(mine, rem)
            np.testing.assert_allclose(rs, expect[lo:lo + base + (1 if mine < rem else 0)],
                                       rtol=1e-5, atol=1e-5)
            ag = tr.allgather(np.array([rank, rank * 2], np.int64))
            np.testing.assert_array_equal(ag, [[r, r * 2] for r in range(world)])
            b = tr.broadcast(np.full(17, rank, np.float32) if rank == 1
                             else np.zeros(17, np.float32), root=1)
            np.testing.assert_array_equal(b, np.full(17, 1, np.float32))
            # uneven: 7 elements over the ring, every remainder chunk path
            np.testing.assert_allclose(tr.allreduce(np.full(7, float(rank + 1), np.float32)),
                                       np.full(7, world * (world + 1) / 2, np.float32))
            tr.barrier()
        q.put((rank, "ok"))
    except Exception as e:  # noqa: BLE001 — reported to the parent
        q.put((rank, f"{type(e).__name__}: {e}"))


def _grads(rank: int, world: int, port: int, q) -> None:
    try:
        g = torch.Generator().manual_seed(rank)
        # a dict in a rank-dependent order: the packing sorts by name
        names = ["w", "b", "emb"] if rank % 2 == 0 else ["emb", "w", "b"]
        shapes = {"w": (3, 4), "b": (4,), "emb": (5, 2)}
        grads = {n: torch.randn(shapes[n], generator=g).to(
            torch.bfloat16 if n == "emb" else torch.float32) for n in names}
        with RingTransport(rank, world, base_port=port) as tr:
            out = grad_allreduce(tr, grads)
        q.put((rank, {n: (t.dtype, t.float().numpy()) for n, t in out.items()}))
    except Exception as e:  # noqa: BLE001 — reported to the parent
        q.put((rank, f"{type(e).__name__}: {e}"))


def _gang(target, world: int) -> dict:
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = free_base_port(world)
    procs = [ctx.Process(target=target, args=(r, world, port, q)) for r in range(world)]
    for p in procs:
        p.start()
    try:
        results = dict(q.get(timeout=TIMEOUT_S) for _ in range(world))
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
    return results


@pytest.mark.parametrize("world", [2, 3])
def test_ring_collectives_multiprocess(world):
    results = _gang(_collectives, world)
    assert all(msg == "ok" for msg in results.values()), results


def test_grad_allreduce_over_a_dict_is_the_mean():
    world = 2
    results = _gang(_grads, world)
    assert all(isinstance(v, dict) for v in results.values()), results
    shapes = {"w": (3, 4), "b": (4,), "emb": (5, 2)}
    want = {}
    for n in shapes:
        per_rank = []
        for r in range(world):
            g = torch.Generator().manual_seed(r)
            names = ["w", "b", "emb"] if r % 2 == 0 else ["emb", "w", "b"]
            d = {m: torch.randn(shapes[m], generator=g) for m in names}
            per_rank.append(d[n].to(torch.bfloat16 if n == "emb" else torch.float32).float())
        want[n] = (sum(per_rank) / world).numpy()
    for r, out in results.items():
        assert set(out) == set(shapes)
        for n, (dtype, arr) in out.items():
            assert dtype == (torch.bfloat16 if n == "emb" else torch.float32)
            # f32 leaves: the mean to f32 rounding; the bf16 leaf: the f32
            # mean rounded once to bf16 (2**-8 relative)
            tol = 1e-6 if n != "emb" else 2.0 ** -8
            np.testing.assert_allclose(arr, want[n], rtol=tol, atol=tol, err_msg=f"{r} {n}")


def test_world_one_identity_and_env():
    with RingTransport(0, 1, base_port=free_base_port(1)) as tr:
        x = np.arange(5, dtype=np.float32)
        np.testing.assert_array_equal(tr.allreduce(x.copy()), x)
        np.testing.assert_array_equal(tr.reduce_scatter(x.copy()), x)
        tr.barrier()
        grads = {"a": torch.ones(2, 3), "b": torch.full((4,), 2.0)}
        out = grad_allreduce(tr, grads)
        assert all(torch.equal(out[k], grads[k]) for k in grads)
        assert grad_allreduce(tr, {}) == {}
    with pytest.raises(ValueError, match="hosts list"):
        RingTransport(0, 2, hosts=["127.0.0.1"])


def test_the_core_is_the_reference_core():
    """The port's copy of the C++ core keeps the reference's code byte for
    byte below its own header comment."""
    def body(path):
        with open(os.path.join(REPO, path)) as f:
            text = f.read()
        return text[text.index("#include"):]

    assert body("kubeflow_tpu_torch/transport/transport_core.cc") == body(
        "kubeflow_tpu/transport/transport_core.cc")
