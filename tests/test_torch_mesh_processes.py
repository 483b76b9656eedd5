"""Port: the mesh across processes (parallel/{distributed,mesh,sharding}.py,
ops/shard_map_compat.py), on the CPU over ``gloo``.

A gang of 2 processes, each owning 2 positions of an fsdp 2 x tensor 2 mesh
over the job's global devices (and a gang of 4 owning one each, where
every group spans processes and replicas sit in several), runs every collective (``psum``, ``pmax``,
``ppermute``, ``all_to_all``, ``axis_index``), ``ShardedTensor.shard`` /
``gather`` / ``assign_`` and ``Views`` on numpy-seeded inputs, with
gradients; the one-controller mesh of 4 positions runs the same code here.
Each process's loss covers its own positions (the one controller's sums
them all), so the gradients compare position by position.  Values and
gradients equal the one controller's exactly where a group has two members
(one sum order), else within 1e-6 relative (f32).

This file also holds the gang runner (``run_gang``) and the members' bodies
that tests/test_torch_trainer_processes.py runs: it imports no JAX, so a
spawned member starts quickly.  Every gang has a timeout of its own, and
so has the process group (``distributed.TIMEOUT_S``, lowered here)."""

import multiprocessing as mp
import os
import random
import socket
import time
import traceback

import numpy as np
import pytest
import torch

from kubeflow_tpu_torch.ops import shard_map_compat as smc
from kubeflow_tpu_torch.parallel import distributed
from kubeflow_tpu_torch.parallel.mesh import MeshConfig, build_mesh
from kubeflow_tpu_torch.parallel.sharding import P, ShardedTensor, Views

SIZES = dict(fsdp=2, tensor=2)
GANG_TIMEOUT_S = 240
F32_RTOL = 1e-6


# rendezvous ports: below the kernel's ephemeral range (where no outgoing
# connection of a concurrent process takes a local port) and clear of the
# fixed ports other tests listen on (tests/test_fleet.py 12345,
# tests/test_transport.py 24800-25310 and 26110-26114) and of
# tests/test_torch_transport.py's range
PORT_RANGE = (13000, 20000)


def free_port() -> int:
    """A rendezvous port in ``PORT_RANGE``, bind-checked here."""
    rng = random.Random(os.getpid() ^ time.monotonic_ns())
    for _ in range(200):
        port = rng.randrange(*PORT_RANGE)
        try:
            with socket.socket() as s:
                s.bind(("", port))
        except OSError:
            continue
        return port
    raise RuntimeError(f"no free rendezvous port in {PORT_RANGE}")


def _member(body, rank: int, world: int, port: int, local: int, device: str, args: tuple,
            q) -> None:
    try:
        os.environ.update(JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                          JAX_NUM_PROCESSES=str(world), JAX_PROCESS_ID=str(rank))
        torch.set_num_threads(1)
        distributed.TIMEOUT_S = 60.0
        if isinstance(local, (list, tuple)):  # positions per process, by rank
            local = local[rank]
        distributed.initialize(local_device_count=local, device=device)
        q.put((rank, "ok", body(rank, *args)))
    except BaseException:  # noqa: BLE001 — reported to the parent
        q.put((rank, "error", traceback.format_exc()))


def run_gang(body, *args, world: int = 2, local: int = 2, device: str = "cpu",
             timeout: float = GANG_TIMEOUT_S):
    """``body(rank, *args)`` in each of ``world`` spawned processes that
    joined one group with ``local`` positions each (or ``local[rank]``) on
    ``device``; their results by rank.  A member that fails (or a gang past ``timeout``) fails
    here."""
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_member,
                         args=(body, r, world, port, local, device, args, q))
             for r in range(world)]
    for p in procs:
        p.start()
    results, deadline = {}, time.monotonic() + timeout
    try:
        while len(results) < world:
            rank, status, value = q.get(timeout=max(1.0, deadline - time.monotonic()))
            if status != "ok":
                raise AssertionError(f"gang member {rank} failed:\n{value}")
            results[rank] = value
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
    return results


# ------------------------------------------------------- the collectives

SHAPE = (4, 8)


def _inputs() -> dict:
    rng = np.random.default_rng(0)
    return {"x": rng.standard_normal((4,) + SHAPE).astype(np.float32),
            "w": rng.standard_normal((4,) + SHAPE).astype(np.float32),
            "g": rng.standard_normal((8, 12)).astype(np.float32),
            "g2": rng.standard_normal((8, 12)).astype(np.float32),
            "wg": rng.standard_normal((4, 8, 12)).astype(np.float32),
            "leaf": rng.standard_normal((2, 8, 12)).astype(np.float32),
            "wv": rng.standard_normal((4, 8, 12)).astype(np.float32)}


def _out(mesh, values) -> dict:
    return {p: values[p].detach().float().numpy() for p in mesh.local_positions}


def _grads(mesh, xs, values, w) -> dict:
    """This process's loss, Σ over its positions of ``values[p] * w[p]``
    (each distinct tensor once per position), and its gradients at its
    positions' inputs."""
    loss = sum((values[p].float() * w[p]).sum() for p in mesh.local_positions)
    inputs = [xs[p] for p in mesh.local_positions]
    got = torch.autograd.grad(loss, inputs, allow_unused=True)  # a one-way ppermute's ends
    return {p: (torch.zeros_like(x) if g is None else g).numpy()
            for p, g, x in zip(mesh.local_positions, got, inputs)}


def collective_cases(mesh, procs) -> dict:
    """Every case over ``mesh``'s local positions; ``procs``: the processes
    whose losses this run adds up (all of them on the one controller)."""
    d = _inputs()
    w = {p: torch.from_numpy(d["w"][p]) for p in range(4)}
    out: dict = {}

    def fresh():
        xs = [None] * mesh.size
        for p in mesh.local_positions:
            xs[p] = torch.from_numpy(d["x"][p]).requires_grad_(True)
        return xs

    with mesh:
        for axes in ("fsdp", "tensor", ("fsdp", "tensor")):
            name = "_".join(axes) if isinstance(axes, tuple) else axes
            xs = fresh()
            ys = smc.psum(xs, axes)
            out[f"psum_{name}"] = (_out(mesh, ys), _grads(mesh, xs, ys, w))
            xs = fresh()
            ys = smc.pmax([None if x is None else x.detach() for x in xs], axes)
            out[f"pmax_{name}"] = (_out(mesh, ys), {})
        counts = [p + 1 if mesh.is_local(p) else None for p in range(mesh.size)]
        out["psum_numbers"] = ({p: np.asarray(v) for p, v in enumerate(
            smc.psum(counts, ("fsdp", "tensor"))) if v is not None}, {})
        for name, axes, perm in (("swap", "fsdp", [(0, 1), (1, 0)]),
                                 ("ring", ("fsdp", "tensor"), [(i, (i + 1) % 4) for i in range(4)])):
            xs = fresh()
            ys = smc.ppermute(xs, axes, perm)
            out[f"ppermute_{name}"] = (_out(mesh, ys), _grads(mesh, xs, ys, w))
        with torch.no_grad():
            ys = smc.ppermute(fresh(), "fsdp", [(0, 1)])
        out["ppermute_oneway"] = (_out(mesh, ys), {})
        # with gradients: a process that only sends or only receives
        xs = fresh()
        ys = smc.ppermute(xs, "fsdp", [(0, 1)])
        out["ppermute_oneway_grad"] = (_out(mesh, ys), _grads(mesh, xs, ys, w))
        for name, axes, split, concat in (("fsdp", "fsdp", 0, 1),
                                          ("all", ("fsdp", "tensor"), 1, 0)):
            xs = fresh()
            ys = smc.all_to_all(xs, axes, split, concat)
            wa = {p: torch.from_numpy(d["w"][p]).reshape(ys[p].shape) if ys[p] is not None
                  else None for p in range(4)}
            out[f"all_to_all_{name}"] = (_out(mesh, ys), _grads(mesh, xs, ys, wa))
        out["axis_index"] = ({p: np.asarray(smc.axis_index(("fsdp", "tensor"))[p])
                              for p in mesh.local_positions}, {})
        g = torch.from_numpy(d["g"])
        for name, spec in (("ft", P("fsdp", "tensor")), ("f", P("fsdp")),
                           ("t", P(None, "tensor")), ("r", P())):
            st = ShardedTensor.shard(g, mesh, spec, fresh=True)
            for t in st.locals:
                t.requires_grad_(True)
            full = st.gather()
            loss = sum((full * torch.from_numpy(d["wg"][r])).sum() for r in procs)
            # a block's gradient: this process's share, on its one tensor of
            # the block (replicas in several processes add their shares)
            blocks = {st.block(p): st.shards[p] for p in mesh.local_positions}
            got = torch.autograd.grad(loss, list(blocks.values()))
            out[f"shard_{name}"] = ({p: st.shards[p].detach().numpy()
                                     for p in mesh.local_positions}, {})
            out[f"gather_{name}"] = ({0: full.detach().numpy()},
                                     {b: v.numpy() for b, v in zip(blocks, got)})
            st.assign_(torch.from_numpy(d["g2"]))
            out[f"assign_{name}"] = ({0: st.gather().detach().numpy()}, {})
        leaf = torch.from_numpy(d["leaf"])
        for name, keep, index, dtype in (("keep_t", ("tensor",), 1, None),
                                         ("all_bf16", (), 0, torch.bfloat16)):
            st = ShardedTensor.shard(leaf, mesh, P(None, "fsdp", "tensor"), fresh=True)
            for t in st.locals:
                t.requires_grad_(True)
            views = Views(mesh)(st, keep, index, dtype)
            wv = {p: torch.from_numpy(d["wv"][p][:, :views[p].shape[1]])
                  for p in mesh.local_positions}
            loss = sum((views[p].float() * wv[p]).sum() for p in mesh.local_positions)
            locs = {p: st.shards[p] for p in mesh.local_positions}
            got = torch.autograd.grad(loss, list(locs.values()))
            out[f"views_{name}"] = (_out(mesh, views),
                                    {p: v.numpy() for p, v in zip(locs, got)})
    return out


def collectives_member(rank: int) -> dict:
    mesh = build_mesh(MeshConfig(**SIZES))
    if distributed.process_count() == 4:  # one position a process
        assert mesh.local_positions == [rank]
        return {"cases": collective_cases(mesh, [rank])}
    assert not mesh.is_fully_addressable and mesh.local_positions == [2 * rank, 2 * rank + 1]
    other = 2 * (1 - rank)
    try:
        mesh.device(other)
        raise AssertionError("a remote position resolved")
    except RuntimeError as e:
        assert f"position {other} is on process {1 - rank}" in str(e)
    return {"cases": collective_cases(mesh, [rank]), "stats": distributed.collective_stats(),
            "backend": distributed.backend(), "refused": formerly_refused(mesh),
            "devices": [(d.process, d.name) for d in distributed.devices()]}


def uneven_member(rank: int) -> dict:
    """Every case on a gang of 3 + 1 positions: process 0 holds both fsdp
    blocks (and both tensor blocks) and process 1 one of each, so a gather
    over ``fsdp`` (or ``tensor``) is one-sided: process 0 only serves it,
    process 1 only receives."""
    mesh = build_mesh(MeshConfig(**SIZES))
    assert mesh.local_positions == ([0, 1, 2] if rank == 0 else [3])
    return {"cases": collective_cases(mesh, [rank])}


def formerly_refused(mesh) -> dict:
    """GPipe over ``stages`` and the MoE FFN over ``expert``, which a mesh
    across processes refused before they were ported: ``gpipe`` of a scaled
    tanh layer on stages 2 x fsdp 2 and ``moe_ffn`` on expert 2 x fsdp 2, on
    the positions of ``mesh`` (its devices, its processes), numpy-seeded,
    their outputs whole."""
    from kubeflow_tpu_torch.ops.moe import MoEConfig, init_moe, moe_ffn
    from kubeflow_tpu_torch.parallel.pipeline import gpipe, stack_stages

    rng = np.random.default_rng(4)
    devices = [mesh.devices.flat[p] for p in range(mesh.size)]
    w = torch.from_numpy(rng.standard_normal((2, 4)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((4, 4)).astype(np.float32))
    cfg = MoEConfig(num_experts=2, top_k=1, d_model=8, d_ff=16)
    xm = torch.from_numpy(rng.standard_normal((2, 4, 8)).astype(np.float32)).bfloat16()
    out = {}
    with build_mesh(MeshConfig(stages=2, fsdp=2), devices):
        out["gpipe"] = gpipe(lambda p, xs: xs.like(smc.each(
            lambda t, lw: torch.tanh(t * lw[0]), xs.shards, Views(xs.mesh)(p["w"]))),
            stack_stages({"w": w[:, None]}, 2), x, 2).gather().numpy()
    with build_mesh(MeshConfig(expert=2, fsdp=2), devices):
        out["moe"] = moe_ffn(init_moe(cfg, "cpu"), xm, cfg)[0].float().numpy()
    return out


@pytest.fixture(scope="module")
def gang():
    return run_gang(collectives_member)


@pytest.fixture(scope="module")
def gang4():
    """4 processes of one position each: every group of the mesh spans
    processes, and the process groups of 2 of the 4 are built."""
    return run_gang(collectives_member, world=4, local=1)


@pytest.fixture(scope="module")
def gang31():
    """2 processes of 3 and 1 positions: one-sided gathers."""
    return run_gang(uneven_member, local=[3, 1])


@pytest.fixture(scope="module")
def one():
    return collective_cases(build_mesh(MeshConfig(**SIZES), ["cpu"] * 4), [0, 1])


@pytest.fixture(scope="module")
def one4():
    """The one controller adding the four processes' losses."""
    return collective_cases(build_mesh(MeshConfig(**SIZES), ["cpu"] * 4), [0, 1, 2, 3])


SPECS = ("ft", "f", "t", "r")
CASES = ([f"{op}_{a}" for op in ("psum", "pmax") for a in ("fsdp", "tensor", "fsdp_tensor")]
         + ["psum_numbers", "ppermute_swap", "ppermute_ring", "ppermute_oneway",
            "ppermute_oneway_grad",
            "all_to_all_fsdp", "all_to_all_all", "axis_index", "views_keep_t", "views_all_bf16"]
         + [f"{op}_{s}" for op in ("shard", "gather", "assign") for s in SPECS])
# f32 cases whose every sum has two terms, or none: one order on both sides
INEXACT = {"psum_fsdp_tensor"}
# a bf16 view's gradient: the receivers' bf16 gradients summed once before
# the cast back (the one controller sums them after it, in f32): one bf16
# rounding
BF16 = {"views_all_bf16": 2.0 ** -7}


@pytest.fixture(scope="module")
def seq_gang():
    return run_gang(seq_member)


@pytest.mark.parametrize("op", ["ring", "ulysses"])
def test_seq_attention_across_processes_matches_the_one_controller(seq_gang, op):
    """Ring attention (ppermute, causal, every future block folded masked
    across processes) and Ulysses (all_to_all) over seq 4 on 2 processes of
    2 positions: the output exactly, and the processes' shares of the
    gradients summed."""
    want_y, want_g = seq_cases(build_mesh(MeshConfig(fsdp=1, seq=4), ["cpu"] * 4), [0, 1])[op]
    for res in seq_gang.values():
        np.testing.assert_array_equal(res[op][0], want_y)
    for i, want in enumerate(want_g):
        np.testing.assert_array_equal(sum(res[op][1][i] for res in seq_gang.values()), want)


def test_the_gang_joins_over_gloo_with_the_global_device_list(gang):
    for rank, res in gang.items():
        assert res["backend"] == "gloo"
        assert res["devices"] == [(0, "cpu"), (0, "cpu"), (1, "cpu"), (1, "cpu")]
        assert res["stats"]["calls"] > 0 and res["stats"]["bytes"] > 0


def _check(case: str, kind: str, got: dict, want: dict, bf16: dict = BF16) -> None:
    assert got and set(got) <= set(want), (case, kind, sorted(got), sorted(want))
    for k, v in got.items():
        if kind == "grad" and case in bf16:
            tol = bf16[case]
            np.testing.assert_allclose(v, want[k], rtol=tol, atol=tol, err_msg=f"{case} {k}")
        elif case in INEXACT:
            np.testing.assert_allclose(v, want[k], rtol=F32_RTOL, atol=F32_RTOL,
                                       err_msg=f"{case} {kind} {k}")
        else:
            np.testing.assert_array_equal(v, want[k], err_msg=f"{case} {kind} {k}")


def _summed_shares(grads: list) -> dict:
    """Each block's gradient over the processes: the replicas' shares."""
    summed: dict = {}
    for g in grads:
        for b, v in g.items():
            summed[b] = summed[b] + v if b in summed else v
    return summed


@pytest.mark.parametrize("case", CASES)
def test_collective_on_four_processes_matches_the_one_controller(gang4, one4, case):
    want_vals, want_grads = one4[case]
    tol = BF16.get(case, F32_RTOL)
    for res in gang4.values():
        for k, v in res["cases"][case][0].items():
            np.testing.assert_allclose(v, want_vals[k], rtol=F32_RTOL, atol=F32_RTOL,
                                       err_msg=f"{case} value {k}")
    grads = [res["cases"][case][1] for res in gang4.values()]
    got = _summed_shares(grads) if case.startswith("gather") else {
        k: v for g in grads for k, v in g.items()}
    assert got.keys() == want_grads.keys(), case
    for k, v in got.items():
        np.testing.assert_allclose(v, want_grads[k], rtol=tol, atol=tol, err_msg=f"{case} {k}")


@pytest.mark.parametrize("what", ["gpipe", "moe"])
def test_what_is_not_ported_across_processes_is_refused(gang, what):
    """What a mesh across processes refused until GPipe and expert
    parallelism were ported: both now run across the gang and give every
    process the one controller's values."""
    want = formerly_refused(build_mesh(MeshConfig(**SIZES), ["cpu"] * 4))[what]
    for res in gang.values():
        np.testing.assert_array_equal(res["refused"][what], want)


def _matches_the_one_controller(gang, one, case, bf16: dict = BF16) -> None:
    want_vals, want_grads = one[case]
    for res in gang.values():
        _check(case, "value", res["cases"][case][0], want_vals)
    grads = [res["cases"][case][1] for res in gang.values()]
    if case.startswith("gather"):
        # each block's replicas in the two processes add their shares
        summed = _summed_shares(grads)
        _check(case, "grad", summed, want_grads)
        assert summed.keys() == want_grads.keys()
    elif want_grads:
        for g in grads:
            _check(case, "grad", g, want_grads, bf16)


@pytest.mark.parametrize("case", CASES)
def test_collective_matches_the_one_controller(gang, one, case):
    _matches_the_one_controller(gang, one, case)


# the bf16 view's gradient on 3 + 1 positions: process 0's three positions
# share one bf16 view, whose gradient autograd sums in bf16 before process 1's
# share is added, where the one controller sums its four in another order:
# one more bf16 rounding, of a partial sum of up to 8 (one ulp: 2**-5)
BF16_UNEVEN = {"views_all_bf16": 2.0 ** -5}


@pytest.mark.parametrize("case", CASES)
def test_collective_on_uneven_processes_matches_the_one_controller(gang31, one, case):
    """3 + 1 positions: the gathers over one axis (``gather_f``,
    ``gather_t``, the views) are one-sided, with gradients."""
    _matches_the_one_controller(gang31, one, case, BF16_UNEVEN)


def test_each_process_holds_its_positions_only():
    mesh = build_mesh(MeshConfig(**SIZES), ["cpu"] * 4)
    assert mesh.is_fully_addressable and mesh.local_positions == [0, 1, 2, 3]
    assert [mesh.process_of(p) for p in range(4)] == [0] * 4


def test_a_remote_device_record_is_never_resolved():
    from kubeflow_tpu_torch.parallel.distributed import JobDevice
    from kubeflow_tpu_torch.parallel.mesh import AXES, Mesh

    # "cuda:7" of another process is a name only: no card is asked for here
    arr = np.empty(4, dtype=object)
    arr[:] = [torch.device("cpu"), torch.device("cpu"), JobDevice(1, "cuda:7"),
              JobDevice(1, "cuda:7")]
    with pytest.raises(ValueError, match="mixed device types"):
        Mesh(arr.reshape((1, 1, 2, 1, 1, 2)), AXES)


# ------------------------------------- the Trainer's members (no JAX here)

TINY = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
            intermediate_size=128, max_position=64)
MAX_PRED = 5


def bert_batches(n: int, seed: int = 3) -> list:
    from kubeflow_tpu_torch.train import data as tdata

    gen = tdata.synthetic_mlm_batches(TINY["vocab_size"], 8, 16, seed=seed)
    return [next(gen) for _ in range(n)]


def bert_trainer(np_tree: dict, sizes: dict, dtype: str, devices=None, **cfg):
    """The port's mesh Trainer of tiny BERT on the carried JAX weights, over
    ``devices`` (default the job's global list)."""
    from kubeflow_tpu_torch.models import bert
    from kubeflow_tpu_torch.train.trainer import Trainer, TrainerConfig

    config = bert.BertConfig(**TINY, dtype=getattr(torch, dtype))

    def loss_fn(m, b):
        return bert.mlm_loss(m, config, b["input_ids"], b["labels"], b["attention_mask"],
                             max_predictions=MAX_PRED)

    mesh = build_mesh(MeshConfig(**sizes), devices)
    return Trainer(loss_fn, bert.params_from_jax(np_tree, "cpu"),
                   TrainerConfig(learning_rate=1e-3, warmup_steps=1, total_steps=10, **cfg),
                   mesh=mesh, rules=bert.SHARDING_RULES)


def bert_steps(trainer, steps: int) -> dict:
    got = [trainer.train_step(b) for b in bert_batches(steps)]
    shapes = {n: [None if t is None else tuple(t.shape) for t in st.shards]
              for n, st in trainer.params.items()}
    return {"loss": [m["loss"] for m in got], "grad_norm": [m["grad_norm"] for m in got],
            "shapes": shapes, "label": trainer.mfu_label,
            "params": {n: st.gather().detach().float().numpy()
                       for n, st in trainer.params.items()}}


def trainer_member(rank: int, np_tree: dict, sizes: dict, dtype: str, steps: int) -> dict:
    return bert_steps(bert_trainer(np_tree, sizes, dtype), steps)


def batch_rules_member(rank: int, np_tree: dict) -> dict:
    """``global_batch`` of each process's own rows, then ``put_batch`` (in
    ``train_step``) of a batch that differs between the processes."""
    from kubeflow_tpu_torch.train.data import global_batch

    trainer = bert_trainer(np_tree, dict(fsdp=2), "float32")
    local = np.arange(12, dtype=np.int32).reshape(4, 3) + 100 * rank
    st = global_batch({"x": local}, trainer.mesh)["x"]
    out = {"shape": tuple(st.shape), "global": st.gather().numpy(),
           "local": [None if t is None else t.numpy() for t in st.shards]}
    batch = bert_batches(1)[0]
    # the two rules give one step: the global batch, or each process's rows
    # of it assembled by global_batch
    out["global_step"] = trainer.train_step(batch)["loss"]
    rows = {k: v[4 * rank:4 * rank + 4] for k, v in batch.items()}
    again = bert_trainer(np_tree, dict(fsdp=2), "float32")
    out["local_step"] = again.train_step(global_batch(rows, again.mesh))["loss"]
    batch["input_ids"] = batch["input_ids"] + rank  # unequal on the two processes
    try:
        trainer.train_step(batch)
        out["unequal"] = "trained"
    except ValueError as e:
        out["unequal"] = str(e)
    return out


def checkpoint_member(rank: int, np_tree: dict, directory: str) -> dict:
    """Train 3 steps with a checkpoint every 2 and a last save at 3, then
    restore into a fresh trainer; which process wrote, and what each
    restored."""
    from kubeflow_tpu_torch.train import checkpoint

    writes = []
    write = checkpoint.CheckpointManager._write

    def counted(self, step, host):
        writes.append(step)
        return write(self, step, host)

    checkpoint.CheckpointManager._write = counted
    cfg = dict(checkpoint_dir=directory, checkpoint_every=2)
    trainer = bert_trainer(np_tree, dict(fsdp=2, tensor=2), "float32", **cfg)
    first = bert_steps(trainer, 3)
    trainer.save()
    trainer.finalize()
    again = bert_trainer(np_tree, dict(fsdp=2, tensor=2), "float32", **cfg)
    restored = again.restore_latest()
    return {"writes": writes, "restored": restored, "step": again.step_num,
            "trained": first["params"],
            "params": {n: st.gather().detach().numpy() for n, st in again.params.items()},
            "mu": {n: st.gather().detach().numpy() for n, st in again.opt_state["mu"].items()},
            "count": again.opt_state["count"]}


def flash_gang_member(rank: int) -> dict:
    """One BERT flash step on fsdp 2 x tensor 2 over the gang's global
    devices (the card, shared): flash launches and plain calls counted in
    this process (tests/test_torch_kernels_cuda.py)."""
    import importlib

    from kubeflow_tpu_torch.models import bert
    from kubeflow_tpu_torch.train.data import synthetic_mlm_batches
    from kubeflow_tpu_torch.train.trainer import Trainer, TrainerConfig

    fa = importlib.import_module("kubeflow_tpu_torch.ops.flash_attention")
    card = distributed.local_devices()[0]
    cfg = bert.BertConfig(vocab_size=512, hidden_size=128, num_layers=2, num_heads=4,
                          intermediate_size=256, max_position=128, attention="flash")

    def loss_fn(m, b):
        return bert.mlm_loss(m, cfg, b["input_ids"], b["labels"], b["attention_mask"])

    trainer = Trainer(loss_fn, bert.init(cfg, card, seed=0),
                      TrainerConfig(learning_rate=1e-3, warmup_steps=1, total_steps=4),
                      mesh=build_mesh(MeshConfig(**SIZES)), rules=bert.SHARDING_RULES)
    batch = next(synthetic_mlm_batches(cfg.vocab_size, 8, 128, seed=0))
    batch["attention_mask"][1, 100:] = 0
    plain = fa.flash_attention_plain
    calls = []
    fa.flash_attention_plain = lambda *a, **kw: calls.append(1) or plain(*a, **kw)
    try:
        before = fa.flash_attention.launches
        metrics = trainer.train_step(batch)
        launches = fa.flash_attention.launches - before
    finally:
        fa.flash_attention_plain = plain
    return {"launches": launches, "plain_calls": len(calls), "loss": metrics["loss"],
            "layers": cfg.num_layers, "local": len(trainer.mesh.local_positions),
            "backend": distributed.backend()}


def seq_cases(mesh, procs) -> dict:
    """Ring attention and Ulysses (dense inner) over a ``seq`` axis, f32,
    causal: the global output and each process's share of the gradients of
    its losses (Σ over ``procs`` of ``out * w[r]``) at the global q, k, v."""
    from kubeflow_tpu_torch.ops.ring_attention import ring_attention
    from kubeflow_tpu_torch.ops.ulysses import ulysses_attention

    rng = np.random.default_rng(1)
    qkv = [torch.from_numpy(rng.standard_normal((2, 16, 4, 8)).astype(np.float32))
           for _ in range(3)]
    w = rng.standard_normal((4, 2, 16, 4, 8)).astype(np.float32)
    out = {}
    for name, op in (("ring", ring_attention), ("ulysses", ulysses_attention)):
        q, k, v = (t.clone().requires_grad_(True) for t in qkv)
        y = op(q, k, v, mesh, causal=True)
        loss = sum((y * torch.from_numpy(w[r])).sum() for r in procs)
        out[name] = (y.detach().numpy(), [g.numpy() for g in torch.autograd.grad(loss, (q, k, v))])
    return out


def seq_member(rank: int) -> dict:
    return seq_cases(build_mesh(MeshConfig(fsdp=1, seq=4)), [rank])


# ------------------------------ GPipe and expert parallelism (no JAX here)

# the toy layer of tests/test_torch_gpipe.py: 4 layers of tanh(x @ w + b)
TOY_LAYERS, TOY_D, TOY_B = 4, 16, 8
TOY_RULES = [(r"^w$", P("stages", None, None)), (r"^b$", P("stages", None))]


def toy_np() -> tuple:
    rng = np.random.default_rng(0)
    return ({"w": (rng.standard_normal((TOY_LAYERS, TOY_D, TOY_D)) * 0.3).astype(np.float32),
             "b": (rng.standard_normal((TOY_LAYERS, TOY_D)) * 0.1).astype(np.float32)},
            rng.standard_normal((TOY_B, TOY_D)).astype(np.float32))


def toy_stage(lp, xmb):
    from kubeflow_tpu_torch.parallel.mesh import current_mesh

    mesh = current_mesh()
    views = Views(mesh)
    xs = xmb.shards
    for i in range(lp["w"].shape[0]):
        xs = smc.each(lambda x, w, b: torch.tanh(x @ w + b), xs, views(lp["w"], (), i),
                      views(lp["b"], (), i))
    return xmb.like(xs)


def toy_gpipe(mesh, stages: int, microbatches: int, remat: bool) -> dict:
    """The toy layer under ``gpipe`` on ``mesh``: the output, and this
    process's share of the gradients of ``sum(out ** 2)`` (seeded once over
    the job) at each block of the weights it holds and at the input."""
    from kubeflow_tpu_torch.parallel import pipeline
    from kubeflow_tpu_torch.parallel.sharding import shard_params

    params, x = toy_np()
    placed = shard_params({k: torch.from_numpy(v) for k, v in params.items()}, mesh, TOY_RULES)
    for st in placed.values():
        for t in st.locals:
            t.requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    with mesh:
        y = pipeline.gpipe(toy_stage, pipeline.stack_stages(placed, stages), tx, microbatches,
                           mb_spec=P(("data", "fsdp")), remat=remat).gather()
        smc.position0([(y ** 2).sum()] * mesh.size).backward()
    grads = {(k, st.block(p)): st.shards[p].grad.numpy()
             for k, st in placed.items() for p in mesh.local_positions}
    return {"y": y.detach().numpy(), "grads": grads, "x_grad": tx.grad.numpy(),
            "layers_held": sorted({t.shape[0] for st in placed.values() for t in st.locals})}


def toy_gpipe_member(rank: int, sizes: dict, microbatches: int, remat: bool) -> dict:
    mesh = build_mesh(MeshConfig(**sizes))
    distributed.collective_stats(reset=True)
    out = toy_gpipe(mesh, sizes["stages"], microbatches, remat)
    out["stats"] = distributed.collective_stats()
    return out


def moe_run(mesh, kw: dict, params: dict, x: np.ndarray) -> dict:
    """``moe_ffn`` on ``mesh`` (expert-parallel) in f32: the output, the aux
    values and this process's share of the gradients of tests/test_torch_moe.py's
    loss (seeded once over the job) at the weights and the input."""
    from kubeflow_tpu_torch.ops import moe

    tp = {k: torch.from_numpy(v).requires_grad_(True) for k, v in params.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    with mesh:
        out, aux = moe.moe_ffn(tp, tx, moe.MoEConfig(**kw))
        loss = (out ** 2).sum() + 0.01 * aux["load_balance_loss"] + 0.01 * aux["router_z_loss"]
        smc.position0([loss] * mesh.size).backward()
    return {"out": out.detach().numpy(), "aux": {k: float(v.detach()) for k, v in aux.items()},
            "grads": {k: t.grad.numpy() for k, t in tp.items()}, "x_grad": tx.grad.numpy()}


def moe_member(rank: int, sizes: dict, kw: dict, params: dict, x: np.ndarray) -> dict:
    mesh = build_mesh(MeshConfig(**sizes))
    return {**moe_run(mesh, kw, params, x), "local": mesh.local_positions}


# BERT under GPipe on stages 2 x fsdp 2 at tests/test_torch_gpipe.py's widths
PP_BASE = dict(vocab_size=256, hidden_size=32, num_layers=4, num_heads=4,
               intermediate_size=64, max_position=32)
PP_SIZES = dict(stages=2, fsdp=2)
PP_MICROBATCHES = 4


def pp_config(dtype: str, **kw):
    from kubeflow_tpu_torch.models import bert

    return bert.BertConfig(**PP_BASE, dtype=getattr(torch, dtype), pipeline_stages=2,
                           pipeline_microbatches=PP_MICROBATCHES, **kw)


def pp_batches(n: int) -> list:
    """MLM batches without an attention mask (pipeline parallelism refuses
    one)."""
    from kubeflow_tpu_torch.train import data as tdata

    gen = tdata.synthetic_mlm_batches(PP_BASE["vocab_size"], 8, 16, seed=3)
    return [{k: v for k, v in next(gen).items() if k != "attention_mask"} for _ in range(n)]


def pp_trainer(np_tree: dict, dtype: str, devices=None, **cfg):
    """The port's pp Trainer of that BERT on the carried JAX weights, over
    ``devices`` (default the job's global list)."""
    from kubeflow_tpu_torch.models import bert
    from kubeflow_tpu_torch.train.trainer import Trainer, TrainerConfig

    config = pp_config(dtype)

    def loss_fn(m, b):
        return bert.mlm_loss(m, config, b["input_ids"], b["labels"], max_predictions=MAX_PRED)

    return Trainer(loss_fn, bert.params_from_jax(np_tree, "cpu"),
                   TrainerConfig(learning_rate=1e-3, warmup_steps=1, total_steps=10, **cfg),
                   mesh=build_mesh(MeshConfig(**PP_SIZES), devices),
                   rules=bert.pp_sharding_rules())


def pp_steps(trainer, steps: int) -> dict:
    got = [trainer.train_step(b) for b in pp_batches(steps)]
    shapes = {n: [None if t is None else tuple(t.shape) for t in st.shards]
              for n, st in trainer.params.items()}
    return {"loss": [m["loss"] for m in got], "grad_norm": [m["grad_norm"] for m in got],
            "shapes": shapes, "label": trainer.mfu_label,
            "staged": {n: st.sharding.shard_shape(tuple(st.shape))[0]
                       for n, st in trainer.params.items() if "stages" in tuple(st.spec)},
            "params": {n: st.gather().detach().float().numpy()
                       for n, st in trainer.params.items()}}


def pp_trainer_member(rank: int, np_tree: dict, dtype: str, steps: int) -> dict:
    """``steps`` pp steps over the job's global devices; then a batch with
    an attention mask, which pipeline parallelism refuses."""
    from kubeflow_tpu_torch.models import bert

    trainer = pp_trainer(np_tree, dtype)
    out = pp_steps(trainer, steps)
    batch = pp_batches(1)[0]
    try:
        with trainer.mesh:
            bert.mlm_loss(trainer.tree, pp_config(dtype), torch.from_numpy(batch["input_ids"]),
                          torch.from_numpy(batch["labels"]),
                          torch.ones(batch["input_ids"].shape, dtype=torch.int32))
        out["mask"] = "trained"
    except ValueError as e:
        out["mask"] = str(e)
    return out


def pp_checkpoint_member(rank: int, np_tree: dict, directory: str) -> dict:
    """Train 3 pp steps with a checkpoint every 2 and a last save at 3, then
    restore into a fresh pp trainer."""
    trainer = pp_trainer(np_tree, "float32", checkpoint_dir=directory, checkpoint_every=2)
    first = pp_steps(trainer, 3)
    trainer.save()
    trainer.finalize()
    again = pp_trainer(np_tree, "float32", checkpoint_dir=directory, checkpoint_every=2)
    restored = again.restore_latest()
    return {"restored": restored, "step": again.step_num, "trained": first["params"],
            "params": {n: st.gather().detach().numpy() for n, st in again.params.items()}}


# graft_entry._dryrun_composed's MoE transformer, in f32
COMPOSED_CFG = dict(vocab_size=256, d_model=32, n_layers=4, n_heads=4, num_experts=2, top_k=1,
                    capacity_factor=4.0, pipeline_stages=2, pipeline_microbatches=2)
COMPOSED_SIZES = dict(stages=2, fsdp=1, seq=2, expert=2)


def composed_tokens() -> torch.Tensor:
    """``_dryrun_composed``'s batch."""
    g = torch.Generator().manual_seed(1)
    return torch.randint(0, COMPOSED_CFG["vocab_size"], (4, 17), generator=g, dtype=torch.int32)


def composed_grads(mesh, np_tree: dict) -> dict:
    """The f32 ``lm_loss`` of that model on ``mesh`` (the JAX weights) and
    this process's share of each gradient block it holds."""
    from kubeflow_tpu_torch.models import moe_transformer as mt
    from kubeflow_tpu_torch.parallel.sharding import shard_params
    from kubeflow_tpu_torch.train.trainer import _flatten

    cfg = mt.MoeTransformerConfig(**COMPOSED_CFG, dtype=torch.float32)
    flat = _flatten(shard_params(mt.params_from_jax(np_tree, "cpu"), mesh, mt.SHARDING_RULES))
    tree: dict = {}
    for name, st in flat.items():
        for t in st.locals:
            t.requires_grad_(True)
        *groups, leaf = name.split(".")
        node = tree
        for g in groups:
            node = node.setdefault(g, {})
        node[leaf] = st
    with mesh:
        loss = mt.lm_loss(tree, cfg, composed_tokens())
    loss.backward()
    return {"loss": float(loss.detach()),
            "grads": {(n, st.block(p)): st.shards[p].grad.numpy()
                      for n, st in flat.items() for p in mesh.local_positions}}


def composed_member(rank: int, np_tree: dict) -> dict:
    """The entry point on the job's global devices (``dryrun_multichip``:
    the sharded BERT step, then the composed step), its stdout, and the
    composed model's f32 loss and gradients on the 8-shard composed mesh."""
    import contextlib
    import io

    from kubeflow_tpu_torch import graft_entry

    n = len(distributed.devices())
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        losses = graft_entry.dryrun_multichip(n)
    return {"entry": losses, "stdout": buf.getvalue().splitlines(),
            **composed_grads(build_mesh(MeshConfig(**COMPOSED_SIZES)), np_tree)}


def flash_pp_step(card, devices=None) -> dict:
    """One step of a small BERT under GPipe with flash on stages 2 x fsdp 2
    (2 layers, 2 microbatches), over ``devices`` (default the job's global
    list): the loss, the norm, and the flash launches and plain calls counted
    in this process (tests/test_torch_kernels_cuda.py)."""
    import importlib

    from kubeflow_tpu_torch.models import bert
    from kubeflow_tpu_torch.train.data import synthetic_mlm_batches
    from kubeflow_tpu_torch.train.trainer import Trainer, TrainerConfig

    fa = importlib.import_module("kubeflow_tpu_torch.ops.flash_attention")
    cfg = bert.BertConfig(vocab_size=512, hidden_size=128, num_layers=2, num_heads=4,
                          intermediate_size=256, max_position=128, attention="flash",
                          pipeline_stages=2, pipeline_microbatches=2)

    def loss_fn(m, b):
        return bert.mlm_loss(m, cfg, b["input_ids"], b["labels"])

    trainer = Trainer(loss_fn, bert.init(cfg, card, seed=0),
                      TrainerConfig(learning_rate=1e-3, warmup_steps=1, total_steps=4),
                      mesh=build_mesh(MeshConfig(stages=2, fsdp=2), devices),
                      rules=bert.pp_sharding_rules())
    batch = {k: v for k, v in next(synthetic_mlm_batches(cfg.vocab_size, 8, 128,
                                                           seed=0)).items()
             if k != "attention_mask"}
    plain = fa.flash_attention_plain
    calls = []
    fa.flash_attention_plain = lambda *a, **kw: calls.append(1) or plain(*a, **kw)
    try:
        before = fa.flash_attention.launches
        metrics = trainer.train_step(batch)
        launches = fa.flash_attention.launches - before
    finally:
        fa.flash_attention_plain = plain
    return {"launches": launches, "plain_calls": len(calls), "loss": metrics["loss"],
            "grad_norm": metrics["grad_norm"], "backend": distributed.backend(),
            # a launch per microbatch, layer of a stage and local position
            "per_step": cfg.pipeline_microbatches * cfg.num_layers // cfg.pipeline_stages
            * len(trainer.mesh.local_positions)}


def flash_pp_gang_member(rank: int) -> dict:
    return flash_pp_step(distributed.local_devices()[0])
