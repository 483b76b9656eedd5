"""``shard_map`` and its collectives, for a mesh of one process or several.

Counterpart of ``kubeflow_tpu/ops/shard_map_compat.py``, which picks the
``shard_map`` of the installed JAX.  Here each process drives the shards of
the mesh it owns in lockstep, so a per-shard value is a LIST with one entry
per mesh position (``Mesh.coords`` numbers them; None at a position of
another process), a body is written over such lists, and a collective is a
list operation: ``psum``, ``pmax``, ``ppermute``, ``all_to_all`` (tiled, as
``jax.lax.all_to_all``) and ``axis_index``, each over the mesh of the
enclosing ``shard_map`` (or ``with mesh:``).

Within a process, values move between devices with ``.to`` and every
operation is plain torch, so autograd derives the transposes (``ppermute``
the reverse permutation, ``all_to_all`` the reverse exchange, ``psum`` the
psum of the output gradients).  A group whose members sit in several
processes takes one ``torch.distributed`` call (``parallel/distributed.py``)
inside a ``torch.autograd.Function`` whose backward issues the transpose
itself, so every process issues the same collectives in the same order,
forward and backward: ``psum`` gathers the members' values and sums them in
axis order (every process gets the one-controller sum, bit for bit), then
in the backward sums each process's output gradients the same way;
``ppermute`` is a ``send``/``recv`` pair per crossing and its backward the
reverse pair; ``all_to_all`` and its reverse exchange gather the members'
values.  So every process must use such a collective's outputs alike: an
output one process leaves off its loss drops that collective's backward
from its graph, and the peer waits for it until the group's timeout
(``ops/ring_attention.py`` folds a future block masked across processes
for this reason).  A ``ppermute`` in which a process only sends gives it a
zero-element token, tied into its sending positions' zeros, so its backward
still posts the receives; one in which it only receives takes its own value
at a receiving position as an input, so its backward is reached from its
own parameters and posts the sends (a pipeline stage's hand-off,
``parallel/pipeline.py``).

Positions that share a device and hold the same value hold the same tensor
object.  ``each`` maps a per-shard function once per distinct tuple of
arguments, so work replicated over shards of one device runs once there.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch

from ..parallel import distributed
from ..parallel.mesh import Mesh, current_mesh
from ..parallel.sharding import (NamedSharding, P, ShardedTensor, as_sharded, pack, tie,
                                 unpack)


def _mesh(mesh: Optional[Mesh]) -> Mesh:
    m = mesh if mesh is not None else current_mesh()
    if m is None:
        raise ValueError("a collective outside shard_map needs a mesh (with mesh: ...)")
    return m


def _axes(axis_name) -> tuple:
    return tuple(axis_name) if isinstance(axis_name, (tuple, list)) else (axis_name,)


def _groups(mesh: Mesh, axis_name) -> list:
    """The positions grouped by their coordinates off ``axis_name``: each
    group in order of its (mixed-radix, first axis outermost) index along
    the axes."""
    axes = _axes(axis_name)
    idx = axis_index(axes, mesh)
    groups: dict = {}
    for pos in range(mesh.size):
        c = mesh.coords(pos)
        key = tuple(int(c[a]) for a in mesh.axis_names if a not in axes)
        groups.setdefault(key, []).append(pos)
    return [sorted(g, key=idx.__getitem__) for g in groups.values()]


def _crosses(mesh: Mesh, group: list) -> bool:
    return len({mesh.process_of(p) for p in group}) > 1


def _key(a):
    if isinstance(a, torch.Tensor):
        return ("t", id(a))
    if isinstance(a, tuple):
        return ("tuple",) + tuple(_key(x) for x in a)
    return ("v", a)


def _has_tensor(a) -> bool:
    return isinstance(a, torch.Tensor) or (isinstance(a, tuple) and any(map(_has_tensor, a)))


def each(fn: Callable, *lists) -> list:
    """``[fn(*args) for args in zip(*lists)]``, calling ``fn`` once per
    distinct argument tuple (tensors by identity, other values by value).
    A position whose arguments hold no tensor and some None (a position of
    another process) gives None without a call."""
    done: dict = {}
    out = []
    for args in zip(*lists):
        if any(a is None for a in args) and not any(map(_has_tensor, args)):
            out.append(None)
            continue
        k = tuple(_key(a) for a in args)
        if k not in done:
            done[k] = fn(*args)
        out.append(done[k])
    return out


def axis_index(axis_name, mesh: Optional[Mesh] = None) -> list:
    """Each position's index along ``axis_name`` (a tuple of axes counts
    mixed-radix, the first axis outermost)."""
    m = _mesh(mesh)
    sizes = m.shape
    out = []
    for pos in range(m.size):
        c, idx = m.coords(pos), 0
        for a in _axes(axis_name):
            idx = idx * sizes[a] + int(c[a])
        out.append(idx)
    return out


def axis_size(axis_name, mesh: Optional[Mesh] = None) -> int:
    m = _mesh(mesh)
    return math.prod(m.shape[a] for a in _axes(axis_name))


# ------------------------------------------------- across processes


def _like(m: Mesh, xs: Sequence) -> torch.Tensor:
    """A local value of ``xs``, one that needs a gradient where there is
    one: every member's value has its shape and dtype."""
    held = [xs[p] for p in m.local_positions if isinstance(xs[p], torch.Tensor)]
    if not held:
        raise ValueError("a collective across processes needs a tensor on a local position")
    return next((t for t in held if t.requires_grad), held[0])


def _members(m: Mesh, groups: list, xs: Sequence) -> dict:
    """Every member's value of ``groups``, by position: one all-gather over
    the mesh's processes, each sending its own members' values (uniform
    shapes and dtypes, as the positions of a per-shard list have)."""
    like = _like(m, xs)
    item = like.numel() * like.element_size()
    owned = {r: [p for g in groups for p in g if m.process_of(p) == r] for r in m.processes}
    mine = owned[distributed.process_index()]
    bufs = distributed.all_gather_bytes(pack([xs[p].to(like.device) for p in mine]),
                                        [len(owned[r]) * item for r in m.processes],
                                        m.group(m.processes))
    out = {}
    for r, buf in zip(m.processes, bufs):
        out.update(zip(owned[r], unpack(buf, like.shape, like.dtype, len(owned[r]))))
    for p in mine:
        out[p] = xs[p]
    return out


def _sum_in_order(values: list):
    total = values[0]
    for v in values[1:]:
        total = total + (v.to(total.device) if isinstance(v, torch.Tensor) else v)
    return total


class _Psum(torch.autograd.Function):
    """The sums of the groups that span processes: forward gathers every
    member's value and sums each group in axis order; backward gathers each
    process's gradient of each sum and gives every local member their sum."""

    @staticmethod
    def forward(ctx, m: Mesh, groups: list, *local):
        ctx.m, ctx.groups = m, groups
        mine = [p for g in groups for p in g if m.is_local(p)]
        xs: list = [None] * m.size
        for p, v in zip(mine, local):
            xs[p] = v
        ctx.devices = [v.device for v in local]
        got = _members(m, groups, xs)
        return tuple(_sum_in_order([got[p] for p in g]) for g in groups
                     if any(m.is_local(p) for p in g))

    @staticmethod
    def backward(ctx, *grads):
        m, groups = ctx.m, ctx.groups
        mine_groups = [i for i, g in enumerate(groups) if any(m.is_local(p) for p in g)]
        # each process's gradient of a group's sum rides on its first
        # member of the group
        reps = [[next(p for p in g if m.process_of(p) == r)
                 for r in sorted({m.process_of(p) for p in g})] for g in groups]
        gs: list = [None] * m.size
        for i, g in zip(mine_groups, grads):
            gs[next(p for p in groups[i] if m.is_local(p))] = g
        got = _members(m, reps, gs)
        out = []
        for i in mine_groups:
            total = _sum_in_order([got[p] for p in reps[i]])
            for p in groups[i]:
                if m.is_local(p):
                    out.append(total)
        return (None, None, *[g.to(dev) for g, dev in zip(out, ctx.devices)])


def _spread(m: Mesh, group: list, total, out: list) -> None:
    """Give every local member of ``group`` the group's ``total``, moved to
    its device; members on one device get one tensor."""
    moved: dict = {}
    for pos in group:
        if not m.is_local(pos):
            continue
        if isinstance(total, torch.Tensor):
            dev = m.device(pos)
            if dev not in moved:
                moved[dev] = total.to(dev)
            out[pos] = moved[dev]
        else:
            out[pos] = total


def psum(xs: Sequence, axis_name, mesh: Optional[Mesh] = None) -> list:
    """Sum each group's values along ``axis_name`` (in axis order, on the
    group's first device) and give every member the sum, moved to its
    device; members on one device get one tensor.  Python numbers sum as
    numbers (``psum(1, axis)`` is the axis size).  A group that spans
    processes takes one gather over them (``_Psum``)."""
    m = _mesh(mesh)
    if not isinstance(xs, (list, tuple)):
        xs = [xs] * m.size
    out: list = [None] * m.size
    tensors = any(isinstance(xs[p], torch.Tensor) for p in m.local_positions)
    cross, numbers = [], []
    for group in _groups(m, axis_name):
        if all(xs[p] is not None for p in group):
            # every value known here: one process's group, or numbers
            # every process holds
            if any(m.is_local(p) for p in group):
                _spread(m, group, _sum_in_order([xs[p] for p in group]), out)
        elif _crosses(m, group):
            (cross if tensors else numbers).append(group)
    if numbers:  # Python numbers of other processes' positions
        every = distributed.all_gather_object(
            {p: xs[p] for g in numbers for p in g if m.is_local(p)}, m.group(m.processes))
        got = {p: v for d in every for p, v in d.items()}
        for group in numbers:
            _spread(m, group, _sum_in_order([got[p] for p in group]), out)
    if cross:
        local = [xs[p] for g in cross for p in g if m.is_local(p)]
        totals = iter(_Psum.apply(m, cross, *local))
        for g in cross:
            if any(m.is_local(p) for p in g):
                _spread(m, g, next(totals), out)
    return out


def pmax(xs: Sequence, axis_name, mesh: Optional[Mesh] = None) -> list:
    """The elementwise maximum of each group's values along ``axis_name``,
    given to every member as ``psum`` gives the sum.  Across processes it
    takes values off the graph only (the models' ``pmax`` is the
    log-sum-exp's shift, ``models/_mesh.py``): a value that needs a gradient
    there raises."""
    m = _mesh(mesh)
    out: list = [None] * m.size
    cross = []
    for group in _groups(m, axis_name):
        if _crosses(m, group):
            cross.append(group)
            continue
        if not m.is_local(group[0]):
            continue  # another process's group
        top = xs[group[0]]
        for pos in group[1:]:
            top = torch.maximum(top, xs[pos].to(top.device))
        _spread(m, group, top, out)
    if cross:
        if any(xs[p].requires_grad for g in cross for p in g if m.is_local(p)):
            raise ValueError("pmax across processes takes values off the graph (detach them)")
        got = _members(m, cross, xs)
        for group in cross:
            top = got[group[0]]
            for pos in group[1:]:
                top = torch.maximum(top, got[pos].to(top.device))
            _spread(m, group, top, out)
    return out


class _Permute(torch.autograd.Function):
    """The crossings of a ``ppermute``: forward a send per crossing this
    process sources and a receive per crossing it ends; backward the same
    pairs reversed.  ``pairs`` lists (source position, destination
    position) in one order on every process; ``like`` is a local value
    (the received values' shape and dtype), an input of the node, so a
    process that only receives reaches this backward from its own graph.
    A process that receives nothing gets a zero-element token instead."""

    @staticmethod
    def forward(ctx, m: Mesh, pairs: list, like: torch.Tensor, *sent):
        ctx.m, ctx.pairs, ctx.like = m, pairs, (like.shape, like.dtype)
        got = _Permute.exchange(m, pairs, list(sent), ctx.like)
        return got or (like.new_empty(0),)

    @staticmethod
    def exchange(m: Mesh, pairs: list, sent: list, like: tuple) -> tuple:
        shape, dtype = like
        sends = [(t, m.process_of(d)) for t, (_, d) in
                 zip(sent, [pr for pr in pairs if m.is_local(pr[0])])]
        recvs = [(torch.empty(shape, dtype=dtype, device=m.device(d)),
                  m.process_of(s)) for s, d in pairs if m.is_local(d)]
        distributed.send_recv(sends, recvs)
        return tuple(t for t, _ in recvs)

    @staticmethod
    def backward(ctx, *grads):
        m, pairs = ctx.m, ctx.pairs
        if not any(m.is_local(d) for _, d in pairs):
            grads = ()  # the token's
        got = _Permute.exchange(m, [(d, s) for s, d in pairs], list(grads), ctx.like)
        return (None, None, None, *got)


def ppermute(xs: Sequence, axis_name, perm: Sequence, mesh: Optional[Mesh] = None) -> list:
    """Send each member's value along ``axis_name`` by ``perm`` (pairs of
    source, destination index); a member no pair names receives zeros, or
    None where it holds None (a pipeline stage idle at this tick).  A pair
    whose ends sit in two processes is a send and a receive (``_Permute``);
    both sides read from ``perm`` whether a tensor crosses.  A process that
    receives across processes holds a value at some position (its shape
    and dtype are the received ones; where it only receives, the node's
    input: one that needs a gradient, for its backward to run); where it
    only sends, its token is tied into the zeros its positions get."""
    m = _mesh(mesh)
    idx = axis_index(axis_name, m)
    out: list = [None] * m.size
    crossing = []
    for group in _groups(m, axis_name):
        by_idx = {idx[p]: p for p in group}
        for src, dst in perm:
            s, d = by_idx[src], by_idx[dst]
            if m.process_of(s) != m.process_of(d):
                crossing.append((s, d))
            elif m.is_local(d):
                out[d] = xs[s].to(m.device(d))
    token = None
    if any(m.is_local(s) or m.is_local(d) for s, d in crossing):
        sent = [xs[s] for s, _ in crossing if m.is_local(s)]
        got = _Permute.apply(m, crossing, _like(m, xs), *sent)
        ends = [d for _, d in crossing if m.is_local(d)]
        for d, t in zip(ends, got):
            out[d] = t
        token = None if ends else got[0]
    for p in m.local_positions:
        if out[p] is None and xs[p] is not None:
            out[p] = tie(torch.zeros_like(xs[p]), token)
    return out


def _a2a(m: Mesh, groups: list, xs: Sequence, split_axis: int, concat_axis: int,
         out: list) -> None:
    """``all_to_all`` over ``groups`` that span processes, off the graph:
    the members' values gathered, each local member concatenating its
    chunks."""
    got = _members(m, groups, xs)
    for group in groups:
        n = len(group)
        for j, p in enumerate(group):
            if m.is_local(p):
                dev = m.device(p)
                out[p] = torch.cat([got[q].chunk(n, dim=split_axis)[j].to(dev) for q in group],
                                   dim=concat_axis)


class _AllToAll(torch.autograd.Function):
    """``all_to_all`` of the groups that span processes; its backward is
    the reverse exchange (``split_axis`` and ``concat_axis`` swapped)."""

    @staticmethod
    def forward(ctx, m: Mesh, groups: list, split_axis: int, concat_axis: int, *local):
        ctx.args = (m, groups, split_axis, concat_axis)
        return _AllToAll.run(m, groups, local, split_axis, concat_axis)

    @staticmethod
    def run(m: Mesh, groups: list, local, split_axis: int, concat_axis: int) -> tuple:
        mine = [p for g in groups for p in g if m.is_local(p)]
        xs: list = [None] * m.size
        for p, v in zip(mine, local):
            xs[p] = v
        out: list = [None] * m.size
        _a2a(m, groups, xs, split_axis, concat_axis, out)
        return tuple(out[p] for p in mine)

    @staticmethod
    def backward(ctx, *grads):
        m, groups, split_axis, concat_axis = ctx.args
        return (None, None, None, None,
                *_AllToAll.run(m, groups, grads, concat_axis, split_axis))


def all_to_all(xs: Sequence, axis_name, split_axis: int, concat_axis: int,
               tiled: bool = True, mesh: Optional[Mesh] = None) -> list:
    """``jax.lax.all_to_all(..., tiled=True)``: member i splits its value
    into n chunks along ``split_axis`` and sends chunk j to member j, which
    concatenates the chunks it receives, in member order, along
    ``concat_axis``.  Groups that span processes exchange through
    ``_AllToAll``."""
    if not tiled:
        raise NotImplementedError("all_to_all: only tiled=True")
    m = _mesh(mesh)
    out: list = [None] * m.size
    cross = []
    for group in _groups(m, axis_name):
        n = len(group)
        for p in group:
            if xs[p] is not None and xs[p].shape[split_axis] % n:
                raise ValueError(f"all_to_all: dim {split_axis} does not split {n} ways")
        if _crosses(m, group):
            cross.append(group)
            continue
        if not m.is_local(group[0]):
            continue  # another process's group
        chunks = [xs[p].chunk(n, dim=split_axis) for p in group]
        for j, p in enumerate(group):
            dev = m.device(p)
            out[p] = torch.cat([chunks[i][j].to(dev) for i in range(n)], dim=concat_axis)
    if cross:
        mine = [p for g in cross for p in g if m.is_local(p)]
        for p, t in zip(mine, _AllToAll.apply(m, cross, split_axis, concat_axis,
                                               *(xs[p] for p in mine))):
            out[p] = t
    return out


class _FirstSeed(torch.autograd.Function):
    """The identity whose backward passes zero: a replica's gradient seed
    on a process that does not own position 0."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return torch.zeros_like(g)


def position0(xs: Sequence, mesh: Optional[Mesh] = None):
    """Position 0's value of ``xs``, a value every position holds alike
    (a sum over the mesh: a loss).  In one process ``xs[0]``.  On a mesh
    across processes each process reads its first local position's replica,
    and a process that does not own position 0 reads it through an identity
    whose backward passes zero: every process runs the same backward (and
    its collectives), and the gradient is seeded once over the job, as
    position 0's alone is in one process."""
    m = _mesh(mesh)
    if m.is_local(0):
        return xs[0]
    x = xs[m.local_positions[0]]
    return _FirstSeed.apply(x) if isinstance(x, torch.Tensor) and x.requires_grad else x


def shard_map(f: Callable, mesh: Mesh, in_specs: Sequence, out_specs,
              check_vma: bool = False) -> Callable:
    """``f`` over per-shard lists, called on global tensors: each argument
    is split by its spec (a ShardedTensor of the mesh passes its shards as
    they are), ``f`` runs with the mesh current, and each returned list is
    reassembled into a global tensor by its out spec (on this process's
    first shard's device; over an axis the spec does not name, the first
    member's value, as JAX takes the replicas to agree).  ``check_vma`` is
    accepted for the JAX signature and ignored."""
    del check_vma

    def run(*args):
        lists = [as_sharded(a, mesh, spec).shards for a, spec in zip(args, in_specs)]
        with mesh:
            outs = f(*lists)
        if isinstance(out_specs, tuple) and not isinstance(out_specs, P):
            return tuple(_assemble(o, mesh, s) for o, s in zip(outs, out_specs))
        return _assemble(outs, mesh, out_specs)

    return run


def _assemble(shards: list, mesh: Mesh, spec: P) -> torch.Tensor:
    """A global tensor from per-position slices laid out by ``spec``."""
    spec = P(*tuple(spec))
    first = shards[mesh.local_positions[0]]
    ndim = first.ndim
    sizes = mesh.shape
    shape = list(first.shape)
    for d, e in enumerate(tuple(spec)[:ndim]):
        if e is not None:
            shape[d] *= math.prod(sizes[a] for a in (e if isinstance(e, tuple) else (e,)))
    return ShardedTensor(shards, shape, NamedSharding(mesh, spec)).gather()
