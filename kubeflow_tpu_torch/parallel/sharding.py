"""Path-rule sharding: map parameter tree paths to PartitionSpecs.

Counterpart of ``kubeflow_tpu/parallel/sharding.py``.  Models ship a list of
``(path-regex, PartitionSpec)`` rules; ``shard_params`` resolves every leaf
to a ``NamedSharding`` on the mesh and splits it into a ``ShardedTensor``.

PyTorch has no GSPMD partitioner, so a sharded leaf is held explicitly: a
``ShardedTensor`` records its global shape, its spec and its mesh, and holds
one local tensor per mesh position.  Positions that share a device and a
slice share one tensor (one storage), as one device of a JAX mesh holds one
buffer for each of its shards' slices; so a leaf replicated over four shards
of one card is one tensor there, and a parameter's gradient from every
shard that reads it accumulates into that one tensor.  The rule holds per
process: on a mesh across processes a ShardedTensor holds this process's
positions only (None at the others'), and each process holds one tensor per
device and slice of its own.

Where XLA would insert an all-gather (an ``fsdp`` dim before its matmul,
the vocabulary on ``tensor`` before a lookup), model code asks ``Views``
for each shard's view: its own slice on the dims it computes split, the
rest gathered.  The gather is plain ``torch.cat`` of the local slices, so it is
differentiable, and its backward is a slice per shard and, for replicas, a
sum: the reduce-scatter XLA inserts for ``fsdp``.  A slice that only
another process holds is fetched over ``torch.distributed`` by ``_Fetch``,
whose backward sends each receiver's gradient back to the slice's holder and
sums them there, the same reduce-scatter across processes.  Where a process
only serves a fetch (it needs no slice from the others), its ``_Fetch``
returns a zero-element token that ``tie`` hooks into what it returns, so its
backward still takes part; where it only receives, one of its own slices is
the node's input, so its backward is reached from its own parameters.
"""

from __future__ import annotations

import math
import re
from typing import Any, Iterable, Optional

import torch
from torch import nn

from . import distributed
from .mesh import Mesh


class P(tuple):
    """PartitionSpec: one entry per leading dim, each None (replicated), an
    axis name, or a tuple of axis names (the dim split over their product,
    the first axis outermost)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


Rules = Iterable[tuple[str, P]]


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def path_of(keypath) -> str:
    """``("layers", "attn_qkv_kernel")`` -> ``"layers/attn_qkv_kernel"``."""
    return "/".join(str(k) for k in keypath)


def spec_for(path: str, rules: Rules, ndim: int) -> P:
    for pattern, spec in rules:
        if re.search(pattern, path):
            tup = tuple(spec)
            if len(tup) < ndim:  # pad leading dims (e.g. layer-stacked leaves)
                tup = (None,) * (ndim - len(tup)) + tup
            return P(*tup)
    return P()


def param_tree(module: nn.Module) -> dict:
    """A module's parameters as a nested dict, split on the dots of their
    names (``embeddings.word`` -> ``{"embeddings": {"word": ...}}``)."""
    tree: dict = {}
    for name, p in module.named_parameters():
        *groups, leaf = name.split(".")
        node = tree
        for g in groups:
            node = node.setdefault(g, {})
        node[leaf] = p
    return tree


def tree_map_with_path(fn, tree: Any, path: tuple = ()) -> Any:
    """``fn(path, leaf)`` over a nested dict / list / tuple (a module reads
    as its ``param_tree``)."""
    if isinstance(tree, nn.Module):
        tree = param_tree(tree)
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree))
    return fn(path, tree)


def tree_specs(tree: Any, rules: Rules) -> Any:
    """PartitionSpec tree matching ``tree``'s structure."""
    rules = tuple(rules)
    return tree_map_with_path(
        lambda kp, leaf: spec_for(path_of(kp), rules, getattr(leaf, "ndim", 0)), tree)


def sanitize_spec(spec: P, shape: tuple, mesh: Mesh) -> P:
    """Drop axes from dims they don't divide (e.g. vocab 30522 on tensor=4):
    replication is the safe default."""
    sizes = mesh.shape
    out = []
    for d, entry in enumerate(tuple(spec)):
        if entry is None or d >= len(shape):
            out.append(None)
            continue
        total = math.prod(sizes.get(a, 1) for a in _axes(entry))
        out.append(entry if shape[d] % total == 0 else None)
    return P(*out)


class NamedSharding:
    """A spec on a mesh (``jax.sharding.NamedSharding``)."""

    def __init__(self, mesh: Mesh, spec: P):
        self.mesh, self.spec = mesh, P(*tuple(spec))

    def _entries(self, ndim: int) -> list:
        spec = tuple(self.spec)
        return [_axes(spec[d]) if d < len(spec) else () for d in range(ndim)]

    def shard_shape(self, shape) -> tuple:
        """The shape of one shard's slice of a ``shape`` leaf."""
        sizes = self.mesh.shape
        out = []
        for n, axes in zip(shape, self._entries(len(shape))):
            k = math.prod(sizes[a] for a in axes)
            if n % k:
                raise ValueError(f"dim {n} of {tuple(shape)} does not divide over "
                                 f"{axes} ({k} shards)")
            out.append(n // k)
        return tuple(out)

    def __eq__(self, other) -> bool:
        return (isinstance(other, NamedSharding) and other.mesh is self.mesh
                and tuple(other.spec) == tuple(self.spec))

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"


class ShardedTensor:
    """A global tensor split over a mesh by a spec: ``shards[pos]`` is mesh
    position ``pos``'s slice, one tensor object per distinct (device,
    slice).  Build one with ``ShardedTensor.shard`` (a differentiable split
    of a global tensor, or fresh leaves with ``fresh=True``) or from
    per-position tensors."""

    def __init__(self, shards: list, shape, sharding: NamedSharding):
        self.shards = list(shards)
        self.shape = torch.Size(shape)
        self.sharding = sharding
        self.mesh = sharding.mesh
        self.spec = sharding.spec
        self._entries = sharding._entries(len(self.shape))

    # -------------------------------------------------------------- layout

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.locals[0].dtype

    @property
    def locals(self) -> list:
        """The distinct local tensors, in position order."""
        return list({id(t): t for t in self.shards if t is not None}.values())

    def split_axes(self, dim: int) -> tuple:
        """The axes of size > 1 that split dim ``dim``."""
        sizes = self.mesh.shape
        return tuple(a for a in self._entries[dim] if sizes[a] > 1)

    def block(self, pos: int) -> tuple:
        """Position ``pos``'s block index on each dim."""
        coords, sizes = self.mesh.coords(pos), self.mesh.shape
        out = []
        for axes in self._entries:
            idx = 0
            for a in axes:
                idx = idx * sizes[a] + int(coords[a])
            out.append(idx)
        return tuple(out)

    def _narrow(self, t: torch.Tensor, block: tuple) -> torch.Tensor:
        sizes = self.mesh.shape
        for d, (axes, b) in enumerate(zip(self._entries, block)):
            if axes:
                n = self.shape[d] // math.prod(sizes[a] for a in axes)
                t = t.narrow(d, b * n, n)
        return t

    @classmethod
    def shard(cls, t: torch.Tensor, mesh: Mesh, spec: P, fresh: bool = False) -> "ShardedTensor":
        """Split the global ``t`` by ``spec`` onto the mesh (every split dim
        must divide; ``shard_params`` sanitizes its specs first).  By
        default the split is a differentiable view and move of ``t``;
        ``fresh=True`` makes every local a new contiguous leaf (parameters
        and optimizer state)."""
        sharding = NamedSharding(mesh, spec)
        sharding.shard_shape(tuple(t.shape))  # raises on a dim that does not divide
        out = cls([None] * mesh.size, t.shape, sharding)
        made: dict = {}
        for pos in mesh.local_positions:
            dev, blk = mesh.device(pos), out.block(pos)
            if (dev, blk) not in made:
                part = out._narrow(t, blk).to(dev)
                if fresh:
                    part = part.detach().clone(memory_format=torch.contiguous_format)
                made[(dev, blk)] = part
            out.shards[pos] = made[(dev, blk)]
        return out

    def like(self, shards: list) -> "ShardedTensor":
        """Another tensor of this one's shape and layout (``shards`` one per
        position)."""
        return ShardedTensor(shards, self.shape, self.sharding)

    # -------------------------------------------------------------- gather

    def _sources(self, pos: int, dims: list) -> list:
        """The positions whose slices assemble ``pos``'s view gathered over
        ``dims``, in concatenation order: ``pos`` with the coordinates of
        each gathered dim's axes run through every block (the other axes,
        ``data`` for an fsdp gather, kept: a gather within the group)."""
        sizes = self.mesh.shape
        coords = [self.mesh.coords(pos)]
        for d in dims:
            axes = self._entries[d]
            nxt = []
            for c in coords:
                for b in range(math.prod(sizes[a] for a in axes)):
                    c2 = dict(c)
                    for a in reversed(axes):
                        c2[a], b = b % sizes[a], b // sizes[a]
                    nxt.append(c2)
            coords = nxt
        return [self.mesh.position(c) for c in coords]

    def _gathered_dims(self, keep: tuple) -> list:
        # a dim split over axes of size 1 (``stages`` on a stage's
        # sub-mesh) is whole in every slice: nothing to gather
        sizes = self.mesh.shape
        return [d for d, axes in enumerate(self._entries)
                if axes and not set(axes) <= set(keep)
                and math.prod(sizes[a] for a in axes) > 1]

    def _base(self, q: int, fetched: dict):
        """The tensor this process reads for source position ``q`` (its own
        slice, else a local replica of ``q``'s block, else the fetched
        copy), and whether ``index`` and ``dtype`` are still to be applied
        (the fetched copy comes with them applied)."""
        t = self.shards[q]
        if t is not None:
            return t, True
        blk = self.block(q)
        for p in self.mesh.local_positions:
            if self.block(p) == blk:
                return self.shards[p], True
        return fetched[(self.mesh.process_of(q), blk)], False

    def _assemble(self, sources: list, dims: list, dev, index, dtype,
                  fetched: Optional[dict] = None) -> torch.Tensor:
        parts = []
        for q in sources:
            t, raw = self._base(q, fetched)
            if raw and index is not None:
                t = t[index]
            if raw and dtype is not None:
                t = t.to(dtype)
            parts.append(t.to(dev))
        shift = 0 if index is None else 1
        sizes = self.mesh.shape
        for d in reversed(dims):  # innermost gathered dim first
            k = math.prod(sizes[a] for a in self._entries[d])
            parts = [torch.cat(parts[i:i + k], dim=d - shift) for i in range(0, len(parts), k)]
        return parts[0]

    def gather(self, device=None) -> torch.Tensor:
        """The global tensor, on ``device`` (default this process's first
        shard's); where nothing is split and the local lives there already,
        the local itself.  On a mesh across processes every process gets
        it, the slices it lacks fetched from their holders."""
        dims = self._gathered_dims(())
        mesh = self.mesh
        dev = mesh.device(mesh.local_positions[0]) if device is None else device
        firsts = {}
        for pos in range(mesh.size):
            firsts.setdefault(mesh.process_of(pos), pos)
        # each process gathers its first position's view of the whole
        fetched, token = self._fetch({r: self._sources(p, dims) for r, p in firsts.items()},
                                     None, None, dev)
        return tie(self._assemble(self._sources(mesh.local_positions[0], dims), dims, dev,
                                  None, None, fetched), token)

    def _fetch(self, want: dict, index, dtype, dev) -> tuple:
        """The source positions each process reads (``want``: process ->
        positions, the same on every process) whose block it holds no slice
        of, fetched from the process of each such position: this
        process's, keyed by (that process, block), with ``index`` and
        ``dtype`` applied by the sender, on ``dev``; and the token to
        ``tie`` into what the caller returns where this process only serves
        a differentiable fetch (else None).  Empty on a one-process mesh."""
        mesh = self.mesh
        if mesh.is_fully_addressable:
            return {}, None
        holds = {r: {self.block(p) for p in range(mesh.size) if mesh.process_of(p) == r}
                 for r in mesh.processes}
        need = {r: sorted({(mesh.process_of(q), self.block(q)) for q in want.get(r, ())
                           if self.block(q) not in holds[r]}) for r in mesh.processes}
        if not any(need.values()):
            return {}, None
        sends = {r: sorted({b for q in mesh.processes for s, b in need[q] if s == r})
                 for r in mesh.processes}
        me = distributed.process_index()
        local = {}
        for b in sends[me]:
            t = self.shards[next(p for p in mesh.local_positions if self.block(p) == b)]
            if index is not None:
                t = t[index]
            local[b] = t if dtype is None else t.to(dtype)
        shape = self.sharding.shard_shape(tuple(self.shape))[0 if index is None else 1:]
        plan = _FetchPlan(mesh, need, sends, shape, dtype or self.dtype, dev)
        sent = [local[b] for b in sends[me]]
        anchor = next((t for t in self.locals if t.requires_grad), None)
        if torch.is_grad_enabled() and anchor is not None:
            got = _Fetch.apply(plan, anchor, *sent)
            if not need[me]:  # this process only serves: its token
                return {}, got[0]
            return dict(zip(need[me], got)), None
        with torch.no_grad():
            return dict(zip(need[me], _Fetch.exchange(plan, sent))), None

    @torch.no_grad()
    def assign_(self, t: torch.Tensor) -> "ShardedTensor":
        """Copy the global ``t`` into every local slice, in place."""
        if tuple(t.shape) != tuple(self.shape):
            raise ValueError(f"assign_: shape {tuple(t.shape)} into {tuple(self.shape)}")
        done = {id(None)}
        for pos, local in enumerate(self.shards):
            if id(local) not in done:
                local.copy_(self._narrow(t, self.block(pos)))
                done.add(id(local))
        return self

    def __repr__(self) -> str:
        return (f"ShardedTensor(shape={tuple(self.shape)}, spec={self.spec!r}, "
                f"dtype={self.dtype}, locals={len(self.locals)})")


def pack(tensors) -> torch.Tensor:
    """Tensors of one dtype as one 1-D uint8 buffer (empty for none)."""
    flat = [t.contiguous().reshape(-1).view(torch.uint8) for t in tensors]
    return torch.cat(flat) if flat else torch.empty(0, dtype=torch.uint8)


def unpack(buf: torch.Tensor, shape, dtype, n: int) -> list:
    """``n`` tensors of ``shape`` and ``dtype`` packed in ``buf``."""
    size = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
    return [buf[i * size:(i + 1) * size].view(dtype).reshape(shape) for i in range(n)]


class _FetchPlan:
    """Who sends which blocks of one fetch, and the wire layout."""

    def __init__(self, mesh: Mesh, need: dict, sends: dict, shape, dtype, dev):
        self.procs = mesh.processes
        self.group = mesh.group(self.procs)
        self.need, self.sends = need, sends
        self.shape, self.dtype, self.dev = tuple(shape), dtype, dev
        self.item = math.prod(shape) * torch.empty((), dtype=dtype).element_size()


class _Fetch(torch.autograd.Function):
    """Forward: one all-gather in which each process sends the blocks it
    serves (``plan.sends``) and keeps those it needs (``plan.need``: pairs
    of the serving process and the block).
    Backward, its transpose: one all-gather of each receiver's gradients,
    each sender summing, in process order, what every receiver sent back
    for its blocks (the reduce-scatter across processes).
    ``anchor``, one of this process's own slices, keeps the node on the
    path to its parameters where it only receives; where it needs nothing
    the output is a zero-element token, for the caller to ``tie``."""

    @staticmethod
    def forward(ctx, plan: _FetchPlan, anchor: torch.Tensor, *sent):
        ctx.plan = plan
        got = _Fetch.exchange(plan, sent)
        return got or (anchor.new_empty(0),)

    @staticmethod
    def exchange(plan: _FetchPlan, sent) -> tuple:
        me = distributed.process_index()
        bufs = distributed.all_gather_bytes(
            pack(sent).to(plan.dev), [len(plan.sends[r]) * plan.item for r in plan.procs],
            plan.group)
        served = {r: dict(zip(plan.sends[r], unpack(buf, plan.shape, plan.dtype,
                                                      len(plan.sends[r]))))
                  for r, buf in zip(plan.procs, bufs)}
        return tuple(served[s][b].clone() for s, b in plan.need[me])

    @staticmethod
    def backward(ctx, *grads):
        plan = ctx.plan
        me = distributed.process_index()
        if not plan.need[me]:
            grads = ()  # the token's
        bufs = distributed.all_gather_bytes(
            pack([g.to(plan.dtype) for g in grads]).to(plan.dev),
            [len(plan.need[r]) * plan.item for r in plan.procs], plan.group)
        back = {r: dict(zip(plan.need[r], unpack(buf, plan.shape, plan.dtype,
                                                   len(plan.need[r]))))
                for r, buf in zip(plan.procs, bufs)}
        # each block's gradients summed in f32, in process order
        out = []
        for b in plan.sends[me]:
            total = None
            for r in plan.procs:
                if (me, b) in back[r]:
                    g = back[r][(me, b)].float()
                    total = g if total is None else total + g
            out.append(total.to(plan.dtype))
        return (None, None, *out)


class _Tie(torch.autograd.Function):
    """``x`` itself, with ``others`` in its graph: the backward passes
    ``x``'s gradient through and gives each of ``others`` a zero gradient (a
    broadcast zero, no memory), so their nodes run in this process's
    backward too.  A defined gradient on their device, not None: a node
    whose gradients are all undefined runs on the host's ready queue, out of
    order with the card's, and its collectives would pair up wrongly."""

    @staticmethod
    def forward(ctx, x, *others):
        ctx.metas = [(o.shape, o.dtype, o.device) for o in others]
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (g, *[torch.zeros((), dtype=dt, device=dev).expand(shape)
                     for shape, dt, dev in ctx.metas])


def tie(x: torch.Tensor, *others) -> torch.Tensor:
    """``x``, with the tensors of ``others`` that need a gradient hooked into
    its graph (None entries skipped): a value a process computed for a
    collective's sake only (a token of a fetch or a ``ppermute`` it only
    serves, a gather it does not read) reaches the loss through ``x``, so
    its backward, and the collectives there, run in every process alike."""
    others = [o for o in others if isinstance(o, torch.Tensor) and o.requires_grad]
    if not others or not torch.is_grad_enabled():
        return x
    return _Tie.apply(x, *others)


class Views:
    """Per-call cache of per-position views of a ShardedTensor (``keep``:
    the axes whose split the caller computes, every other sharded dim
    gathered; ``index`` picks one entry of the unsharded leading dim first,
    ``dtype`` casts each slice before the gather): the positions that would
    assemble the same slices on one device share one tensor, so a gather
    (and the work downstream of it) runs once per device and block.  Make
    one per forward call: a cached view belongs to that call's graph.  The
    cache keys tensors by ``id``, so it holds every tensor it was asked
    about: a freed one's id could name the next."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self._cache: dict = {}
        self._held: dict = {}

    def __call__(self, t: ShardedTensor, keep: tuple = (), index: Optional[int] = None,
                 dtype: Optional[torch.dtype] = None) -> list:
        dims = t._gathered_dims(keep)
        if index is not None and 0 in dims:
            raise ValueError("index on a gathered leading dim")
        self._held[id(t)] = t
        mesh = self.mesh
        fetched, token = {}, None
        if not mesh.is_fully_addressable:
            fkey = ("fetch", id(t), tuple(dims), index, dtype)
            if fkey not in self._cache:
                want: dict = {}
                for pos in range(mesh.size):
                    want.setdefault(mesh.process_of(pos), set()).update(t._sources(pos, dims))
                self._cache[fkey] = t._fetch(want, index, dtype,
                                             mesh.device(mesh.local_positions[0]))
            fetched, token = self._cache[fkey]
        out: list = [None] * mesh.size
        for pos in mesh.local_positions:
            dev = mesh.device(pos)
            src = t._sources(pos, dims)
            key = (id(t), dev, tuple(id(t._base(q, fetched)[0]) for q in src), index, dtype)
            if key not in self._cache:
                # a fetch this process only serves: its token in every view
                self._cache[key] = tie(t._assemble(src, dims, dev, index, dtype, fetched), token)
            out[pos] = self._cache[key]
        return out


def tree_shardings(tree: Any, mesh: Mesh, rules: Rules) -> Any:
    """A NamedSharding tree matching ``tree``: each leaf's resolved spec,
    sanitized against its shape."""
    rules = tuple(rules)

    def sharding(kp, leaf):
        shape = tuple(getattr(leaf, "shape", ()))
        spec = spec_for(path_of(kp), rules, len(shape))
        return NamedSharding(mesh, sanitize_spec(spec, shape, mesh))

    return tree_map_with_path(sharding, tree)


def _place(params: Any, mesh: Mesh, rules: Rules, fresh: bool) -> Any:
    rules = tuple(rules)

    def place(kp, leaf):
        if not isinstance(leaf, (torch.Tensor, ShardedTensor)):
            return leaf
        spec = sanitize_spec(spec_for(path_of(kp), rules, leaf.ndim), tuple(leaf.shape), mesh)
        if isinstance(leaf, ShardedTensor):
            if (not fresh and leaf.mesh is mesh
                    and leaf._entries == NamedSharding(mesh, spec)._entries(leaf.ndim)):
                return leaf
            leaf = leaf.gather()  # placed otherwise: re-split by the rules
        return ShardedTensor.shard(leaf.detach() if fresh else leaf, mesh, spec, fresh=fresh)

    return tree_map_with_path(place, params)


def shard_params(params: Any, mesh: Mesh, rules: Rules) -> Any:
    """Every tensor leaf as a ``ShardedTensor`` of fresh locals placed by its
    resolved spec (a module reads as its ``param_tree``); other leaves (a
    step count) stay as they are: replicated scalars."""
    return _place(params, mesh, rules, fresh=True)


def place_params(params: Any, mesh: Mesh, rules: Rules) -> Any:
    """Every tensor leaf in the layout its resolved spec gives, as model
    code on a mesh computes it: a ShardedTensor already so placed as it
    is, a plain tensor (or one placed otherwise) split as a differentiable
    view, so its gradients reach it."""
    return _place(params, mesh, rules, fresh=False)


def batch_spec(mesh: Mesh) -> P:
    """Input batch sharding: batch dim over (data, fsdp)."""
    return P(("data", "fsdp"))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, batch_spec(mesh))


def as_sharded(t, mesh: Mesh, spec: P) -> ShardedTensor:
    """``t`` as a ShardedTensor on ``mesh``: split by ``spec`` when it is a
    plain tensor (GSPMD reshards an unsharded operand the same way)."""
    if isinstance(t, ShardedTensor):
        if t.mesh is not mesh:
            raise ValueError("a ShardedTensor of another mesh")
        return t
    return ShardedTensor.shard(torch.as_tensor(t), mesh, spec)
