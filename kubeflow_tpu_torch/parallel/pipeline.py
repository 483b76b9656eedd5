"""Pipeline parallelism: the GPipe microbatch schedule over the ``stages`` axis.

Counterpart of ``kubeflow_tpu/parallel/pipeline.py``.  The layer stacks
``[L, ...]`` are regrouped into ``[S, L/S, ...]`` (``stack_stages``); with
the model's pipeline rules the leading dim rides the ``stages`` mesh axis,
so each stage's positions hold only their own layers.  ``gpipe`` runs the
microbatches through the stages tick by tick, as the JAX schedule does.

The JAX schedule is one ``lax.scan`` over M + S - 1 ticks, each applying a
``vmap`` of the stage to the whole shift register and rolling it one stage
forward.  Here each process drives the shards it owns (``parallel/mesh.py``),
on a mesh of one process or of several:

  * stage ``s`` runs ``stage_fn`` over its sub-mesh, the positions whose
    ``stages`` coordinate is ``s`` (``Mesh.submesh``), with that sub-mesh
    current, so model code written for a mesh runs unchanged within a
    stage; its parameters are the stage's slice, ``[L/S, ...]`` leaves on
    the sub-mesh.  A process computes only the stages it holds positions
    of; every process walks the same ticks, so the hand-offs pair up;
  * microbatch ``j`` is rows ``[j·mb, (j+1)·mb)`` of the global batch, laid
    out over the stage's sub-mesh by ``mb_spec``;
  * the shift register's hand-off (``jnp.roll``, a collective-permute) is a
    ``ppermute`` over ``stages`` from each working stage to the next, and,
    as the roll wraps, from the last stage to stage 0, which so holds each
    finished microbatch (for S > 2 a second ``ppermute`` gives it to the
    stages between); the output is then laid out over the whole mesh;
  * bubble ticks are skipped: stage ``s`` works at tick ``t`` only when
    ``0 <= t - s < M``.  The JAX schedule computes them and never reads
    their outputs, so they add nothing to the result or the gradient.

Across processes a hand-off where a process only sends (the first tick's,
the last's) or only receives (an idle stage's) is one-sided: the receiving
stage's positions hold a zero placeholder drawn from the input, so the
receive is reached from the process's own parameters, and what a process
computed for a collective's sake only (a sender's token, the input it
gathered for a stage it does not hold) is tied into the output, so every
process runs the same backward (``ops/shard_map_compat.py``).

Autograd derives the reverse schedule.  With no mesh in context the same
schedule runs on one device, as the JAX one does.  ``remat=True`` wraps each
stage call in ``torch.utils.checkpoint`` (``nothing_saveable``: only the
stage's input is kept); ``remat_policy``, a selective checkpoint policy
(``models/bert.py`` builds its ``REMAT_SAVES`` policies as such), keeps what
it marks.

Bubble accounting is the GPipe classic: (S-1)/(M+S-1) of ticks are warmup/
drain.  On shards of one card the stages run one after another, so the
bubble is counted but cannot show as idle time.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Optional

import torch
from torch.utils import checkpoint as _ckpt

from ..ops.shard_map_compat import each, ppermute
from .mesh import Mesh, current_mesh
from .sharding import NamedSharding, P, ShardedTensor, sanitize_spec, tie, tree_map_with_path


def _tree_map(fn, tree: Any) -> Any:
    return tree_map_with_path(lambda _, leaf: fn(leaf), tree)


def _leaves(tree: Any) -> list:
    out: list = []
    _tree_map(out.append, tree)
    return out


def _map_locals(st: ShardedTensor, fn, shape, spec: P) -> ShardedTensor:
    """``st`` with ``fn`` applied to each distinct local (positions sharing
    a local keep sharing its image), as a leaf of ``shape`` and ``spec``."""
    return ShardedTensor(each(fn, st.shards), shape, NamedSharding(st.mesh, spec))


def num_stages(stage_params: Any) -> int:
    return _leaves(stage_params)[0].shape[0]


def stack_stages(layer_params: Any, stages: int) -> Any:
    """Regroup layer-stacked params [L, ...] → stage-stacked [S, L/S, ...].

    A ShardedTensor whose layer dim rides ``stages`` (the model's pipeline
    rules) keeps its slices: each position's ``[L/S, ...]`` becomes
    ``[1, L/S, ...]`` of a leaf whose stage dim rides ``stages``."""

    def regroup(leaf):
        l = leaf.shape[0]
        if l % stages:
            raise ValueError(f"{l} layers not divisible into {stages} stages")
        shape = (stages, l // stages, *leaf.shape[1:])
        if not isinstance(leaf, ShardedTensor):
            return leaf.reshape(shape)
        head, *rest = tuple(leaf.spec) + (None,) * (leaf.ndim - len(leaf.spec))
        blocks = leaf.shape[0] // leaf.sharding.shard_shape(tuple(leaf.shape))[0]
        if blocks == 1:
            return _map_locals(leaf, lambda t: t.reshape(stages, -1, *t.shape[1:]),
                               shape, P(None, None, *rest))
        if head not in ("stages", ("stages",)) or blocks != stages:
            raise ValueError(f"a layer dim split {blocks} ways over {head} does not "
                             f"regroup into {stages} stages")
        return _map_locals(leaf, lambda t: t.unsqueeze(0), shape, P(head, None, *rest))

    return _tree_map(regroup, layer_params)


def unstack_stages(stage_params: Any) -> Any:
    """Inverse of stack_stages: [S, L/S, ...] → [L, ...]."""

    def flat(leaf):
        shape = (leaf.shape[0] * leaf.shape[1], *leaf.shape[2:])
        if not isinstance(leaf, ShardedTensor):
            return leaf.reshape(shape)
        head, _, *rest = tuple(leaf.spec) + (None,) * (leaf.ndim - len(leaf.spec))
        return _map_locals(leaf, lambda t: t.flatten(0, 1), shape, P(head, *rest))

    return _tree_map(flat, stage_params)


def gpipe(
    stage_fn: Callable[[Any, Any], Any],
    stage_params: Any,
    x,
    num_microbatches: int,
    mb_spec: Optional[P] = None,
    remat: bool = True,
    remat_policy: Optional[Callable] = None,
):
    """Run x [B, ...] through S pipeline stages, microbatched.

    ``stage_fn(params_slice, x_mb) -> x_mb`` applies ONE stage (its params
    slice has leading dim L/S) and must be shape-preserving on x.  With no
    mesh in context ``x_mb`` is a tensor; on a mesh it is a ShardedTensor
    on the stage's sub-mesh laid out by ``mb_spec`` (default: batch over
    (data, fsdp)), the params slice holds ShardedTensors on that sub-mesh,
    and ``stage_fn`` returns a ShardedTensor of the same layout.  On a mesh
    the result is a ShardedTensor of the whole mesh laid out by ``mb_spec``
    (replicated over ``stages``)."""
    S = num_stages(stage_params)
    M = num_microbatches
    b = x.shape[0]
    if b % M:
        raise ValueError(f"batch {b} not divisible into {M} microbatches")
    mb = b // M
    if mb_spec is None:
        mb_spec = P(("data", "fsdp"))

    def call(fn, p, xm):
        if not remat:
            return fn(p, xm)
        kw: dict = {"use_reentrant": False}
        if remat_policy is not None:
            kw["context_fn"] = functools.partial(
                _ckpt.create_selective_checkpoint_contexts, remat_policy)
        return _ckpt.checkpoint(fn, p, xm, **kw)

    mesh = current_mesh()
    if mesh is None:
        params = [_tree_map(lambda leaf, s=s: leaf[s], stage_params) for s in range(S)]
        outs = _schedule(S, M, lambda j: x[j * mb:(j + 1) * mb],
                         lambda s, xm: call(stage_fn, params[s], xm), lambda ys: (ys, ys[-1]))
        return torch.cat(outs)
    return _gpipe_mesh(call, stage_fn, stage_params, x, S, M, mb, P(*tuple(mb_spec)), mesh)


def _schedule(S: int, M: int, feed, run, hand_off) -> list:
    """The GPipe ticks: at tick t stage s runs microbatch t - s (bubble
    ticks skipped); ``hand_off`` moves each working stage's output to where
    the next stage reads it and returns the register (entry s: stage s's
    output, for stage s + 1) and the microbatch that finished at this tick
    (None where the last stage is idle).  Returns those in microbatch
    order."""
    reg: list = [None] * S
    outs: list = []
    for t in range(M + S - 1):
        nxt: list = [None] * S
        for s in range(S):
            if 0 <= t - s < M:
                nxt[s] = run(s, feed(t) if s == 0 else reg[s - 1])
        reg, done = hand_off(nxt)
        if done is not None:
            outs.append(done)
    return outs


def _stage_slice(leaf, s: int, mesh: Mesh, sub: Mesh, positions: list) -> ShardedTensor:
    """Stage ``s``'s ``[L/S, ...]`` slice of a ``[S, L/S, ...]`` leaf, on the
    stage's sub-mesh (a plain tensor is taken as replicated)."""
    if not isinstance(leaf, ShardedTensor):
        leaf = ShardedTensor.shard(leaf, mesh, P())
    per_block = leaf.sharding.shard_shape(tuple(leaf.shape))[0]  # stages a local holds
    shards = each(lambda t, i: t[i], [leaf.shards[p] for p in positions],
                  [s - leaf.block(p)[0] * per_block for p in positions])
    spec = tuple(leaf.spec)[1:]
    return ShardedTensor(shards, leaf.shape[1:], NamedSharding(sub, P(*spec)))


def _gpipe_mesh(call, stage_fn, stage_params, x, S: int, M: int, mb: int, mb_spec: P,
                mesh: Mesh) -> ShardedTensor:
    n = mesh.shape["stages"]
    if n not in (1, S):
        raise ValueError(f"{S} pipeline stages on a mesh of stages={n}")
    if n == S:
        subs = [mesh.submesh("stages", s) for s in range(S)]
    else:  # every stage on the whole mesh, one after another
        subs = [(mesh, list(range(mesh.size)))] * S
    params = [_tree_map(lambda leaf, s=s: _stage_slice(leaf, s, mesh, *subs[s]), stage_params)
              for s in range(S)]
    # the reshard into microbatches of global rows (an all-to-all in GSPMD);
    # a microbatch dim the axes do not divide is replicated over them
    xg = x.gather() if isinstance(x, ShardedTensor) else x
    sub0 = subs[0][0]
    mb_shape = (mb, *xg.shape[1:])
    spec = sanitize_spec(mb_spec, mb_shape, sub0)
    # what this process computed for a collective's sake only, tied into the
    # output so that its backward runs here too
    spare = [] if sub0.local_positions else [xg]

    def feed(j):
        return ShardedTensor.shard(xg[j * mb:(j + 1) * mb], sub0, spec)

    def on_sub(s):
        def fn(p, xm):  # the sub-mesh current in the recompute too
            with subs[s][0]:
                return stage_fn(p, xm)
        return fn

    def run(s, xm):
        if not subs[s][0].local_positions:
            return xm  # a stage of other processes: its output's layout only
        return call(on_sub(s), params[s], xm)

    if n == 1:
        outs = _schedule(S, M, feed, run, lambda ys: (ys, ys[-1]))
    else:
        outs = _schedule(S, M, feed, run, _hand_off(mesh, subs, params, x, xg, mb_shape, spec, spare))
    out = tie(torch.cat([o.gather() for o in outs]), *spare)
    return ShardedTensor.shard(out, mesh, sanitize_spec(mb_spec, tuple(out.shape), mesh))


def _hand_off(mesh: Mesh, subs: list, params: list, x, xg: torch.Tensor, mb_shape: tuple,
              spec: P, spare: list):
    """The tick's hand-off over ``stages``: each working stage's output to the
    next stage, and the last stage's to stage 0 (the roll wraps), then for
    S > 2 to the stages between; returns the register and the finished
    microbatch as a ShardedTensor of the whole mesh (None where the last
    stage is idle).  A process's sending positions that receive nothing
    leave their zeros, which carry a one-sided send's token, in ``spare``."""
    S = len(subs)
    shard_shape = NamedSharding(subs[0][0], spec).shard_shape(mb_shape)
    # a receive-only hand-off's input: a local value that leads to this
    # process's parameters (the input, else a stage's weights)
    held = ((x.locals if isinstance(x, ShardedTensor) else [x])
            + [t for p in params for st in _leaves(p) for t in st.locals])
    anchor = next((t for t in held if t.requires_grad), None)

    def permute(ys: list, pairs: list) -> list:
        full: list = [None] * mesh.size
        for s, y in enumerate(ys):
            if y is not None:
                for i, pos in enumerate(subs[s][1]):
                    full[pos] = y.shards[i]
        if not mesh.is_fully_addressable:
            for _, d in pairs:  # an idle stage that receives: a placeholder
                for pos in subs[d][1]:
                    if mesh.is_local(pos) and full[pos] is None:
                        zero = torch.zeros((), dtype=xg.dtype, device=mesh.device(pos))
                        full[pos] = tie(zero.expand(shard_shape), anchor)
        got = ppermute(full, "stages", pairs, mesh)
        ends = {d for _, d in pairs}
        spare.extend(got[pos] for s, _ in pairs if s not in ends for pos in subs[s][1]
                     if mesh.is_local(pos) and got[pos].requires_grad)
        return got

    def on(s: int, full: list, like: ShardedTensor) -> ShardedTensor:
        sub, positions = subs[s]
        return ShardedTensor([full[p] for p in positions], like.shape,
                             NamedSharding(sub, like.spec))

    def hand_off(ys):
        pairs = [(s, s + 1) for s in range(S - 1) if ys[s] is not None]
        last = ys[-1]
        if last is not None:
            pairs.append((S - 1, 0))
        full = permute(ys, pairs)
        moved = [on(s + 1, full, ys[s]) if ys[s] is not None else None for s in range(S - 1)]
        if last is None:
            return moved, None
        done = list(full)
        for i, pos in enumerate(subs[-1][1]):
            done[pos] = last.shards[i]
        if S > 2:
            between = permute([None] * (S - 1) + [last], [(S - 1, s) for s in range(1, S - 1)])
            for s in range(1, S - 1):
                for pos in subs[s][1]:
                    done[pos] = between[pos]
        return moved, ShardedTensor(done, last.shape, NamedSharding(mesh, last.spec))

    return hand_off
