"""``shard_map`` and its collectives, for a single-controller mesh.

Counterpart of ``kubeflow_tpu/ops/shard_map_compat.py``, which picks the
``shard_map`` of the installed JAX.  Here one controller drives every shard
of the mesh in lockstep, so a per-shard value is a LIST with one entry per
mesh position (``Mesh.coords`` numbers them), a body is written over such
lists, and a collective is a list operation: ``psum``, ``ppermute``,
``all_to_all`` (tiled, as ``jax.lax.all_to_all``) and ``axis_index``, each
over the mesh of the enclosing ``shard_map`` (or ``with mesh:``).  Values
move between devices with ``.to``; nothing uses ``torch.distributed``.
Every operation is plain torch, so autograd derives the transposes
(``ppermute`` the reverse permutation, ``all_to_all`` the reverse exchange,
``psum`` the broadcast).

Positions that share a device and hold the same value hold the same tensor
object.  ``each`` maps a per-shard function once per distinct tuple of
arguments, so work replicated over shards of one device runs once there.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch

from ..parallel.mesh import Mesh, current_mesh
from ..parallel.sharding import NamedSharding, P, ShardedTensor, as_sharded


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


def _key(a):
    if isinstance(a, torch.Tensor):
        return ("t", id(a))
    if isinstance(a, tuple):
        return ("tuple",) + tuple(_key(x) for x in a)
    return ("v", a)


def each(fn: Callable, *lists) -> list:
    """``[fn(*args) for args in zip(*lists)]``, calling ``fn`` once per
    distinct argument tuple (tensors by identity, other values by value)."""
    done: dict = {}
    out = []
    for args in zip(*lists):
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


def psum(xs: Sequence, axis_name, mesh: Optional[Mesh] = None) -> list:
    """Sum each group's values along ``axis_name`` (in axis order, on the
    group's first device) and give every member the sum, moved to its
    device; members on one device get one tensor.  Python numbers sum as
    numbers (``psum(1, axis)`` is the axis size)."""
    m = _mesh(mesh)
    if not isinstance(xs, (list, tuple)):
        xs = [xs] * m.size
    out: list = [None] * m.size
    for group in _groups(m, axis_name):
        total = xs[group[0]]
        for pos in group[1:]:
            x = xs[pos]
            total = total + (x.to(total.device) if isinstance(x, torch.Tensor) else x)
        moved: dict = {}
        for pos in group:
            if isinstance(total, torch.Tensor):
                dev = m.device(pos)
                if dev not in moved:
                    moved[dev] = total.to(dev)
                out[pos] = moved[dev]
            else:
                out[pos] = total
    return out


def pmax(xs: Sequence, axis_name, mesh: Optional[Mesh] = None) -> list:
    """The elementwise maximum of each group's values along ``axis_name``,
    given to every member as ``psum`` gives the sum."""
    m = _mesh(mesh)
    out: list = [None] * m.size
    for group in _groups(m, axis_name):
        top = xs[group[0]]
        for pos in group[1:]:
            top = torch.maximum(top, xs[pos].to(top.device))
        moved: dict = {}
        for pos in group:
            dev = m.device(pos)
            if dev not in moved:
                moved[dev] = top.to(dev)
            out[pos] = moved[dev]
    return out


def ppermute(xs: Sequence, axis_name, perm: Sequence, mesh: Optional[Mesh] = None) -> list:
    """Send each member's value along ``axis_name`` by ``perm`` (pairs of
    source, destination index); a member no pair names receives zeros, or
    None where it holds None (a pipeline stage idle at this tick)."""
    m = _mesh(mesh)
    idx = axis_index(axis_name, m)
    out: list = [None] * m.size
    for group in _groups(m, axis_name):
        by_idx = {idx[p]: p for p in group}
        for src, dst in perm:
            d = by_idx[dst]
            out[d] = xs[by_idx[src]].to(m.device(d))
        for p in group:
            if out[p] is None and xs[p] is not None:
                out[p] = torch.zeros_like(xs[p])
    return out


def all_to_all(xs: Sequence, axis_name, split_axis: int, concat_axis: int,
               tiled: bool = True, mesh: Optional[Mesh] = None) -> list:
    """``jax.lax.all_to_all(..., tiled=True)``: member i splits its value
    into n chunks along ``split_axis`` and sends chunk j to member j, which
    concatenates the chunks it receives, in member order, along
    ``concat_axis``."""
    if not tiled:
        raise NotImplementedError("all_to_all: only tiled=True")
    m = _mesh(mesh)
    out: list = [None] * m.size
    for group in _groups(m, axis_name):
        n = len(group)
        chunks = [xs[p].chunk(n, dim=split_axis) for p in group]
        if any(len(c) != n or c[0].shape[split_axis] * n != xs[p].shape[split_axis]
               for c, p in zip(chunks, group)):
            raise ValueError(f"all_to_all: dim {split_axis} does not split {n} ways")
        for j, p in enumerate(group):
            dev = m.device(p)
            out[p] = torch.cat([chunks[i][j].to(dev) for i in range(n)], dim=concat_axis)
    return out


def shard_map(f: Callable, mesh: Mesh, in_specs: Sequence, out_specs,
              check_vma: bool = False) -> Callable:
    """``f`` over per-shard lists, called on global tensors: each argument
    is split by its spec (a ShardedTensor of the mesh passes its shards as
    they are), ``f`` runs with the mesh current, and each returned list is
    reassembled into a global tensor by its out spec (on the first shard's
    device; over an axis the spec does not name, the first member's value,
    as JAX takes the replicas to agree).  ``check_vma`` is accepted for the
    JAX signature and ignored."""
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
    ndim = shards[0].ndim
    sizes = mesh.shape
    shape = list(shards[0].shape)
    for d, e in enumerate(tuple(spec)[:ndim]):
        if e is not None:
            shape[d] *= math.prod(sizes[a] for a in (e if isinstance(e, tuple) else (e,)))
    return ShardedTensor(shards, shape, NamedSharding(mesh, spec)).gather()
