"""Tensor-parallel sharding for the serving engine.

Counterpart of ``kubeflow_tpu/serving/engine/sharding.py``.  The JAX
package places the params and the KV pool with ``NamedSharding``s over a
1-D ``tensor`` mesh and lets GSPMD partition the same jitted computations,
inserting the all-reduces after ``wo`` and ``w2``.  PyTorch has no such
partitioner, so the port splits by hand, with the same layout (the Megatron
split):

  * wq/wk/wv: column-parallel  [L, D, H*hd] -> each shard its own heads;
  * wo:       row-parallel     [L, H*hd, D] -> each shard its heads' rows;
  * w1/w3:    column-parallel  [L, D, F]    -> each shard F/N columns;
  * w2:       row-parallel     [L, F, D];
  * embed/unembed + norms: replicated;
  * k_pool/v_pool: split on the KV-head axis and allocated per shard, so no
    device ever holds the whole pool.

A mesh is an explicit list of N devices, one per shard, in KV-head order.
A device may repeat: N shards may share one card (or ``"cpu"``), each
still holding only its own slice of the weights and the pool and getting
its own kernel launches, as the JAX package's tests run N shards on a
forced multi-device CPU host.  Sharded params and pools are LISTS, one
entry per shard; a replicated leaf is one tensor per distinct device,
shared by the shards placed there.  ``all_reduce_sum`` is the one
collective: the model runs it after ``wo`` and ``w2``.  It sums on the first
shard's device and copies to the others, with no ``torch.distributed``
(one controller drives every shard, as one JAX process drives its mesh).

``n_kv_heads``, ``n_heads`` and ``d_ff`` must divide the tensor size.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ...utils.device import resolve_device
from .kvstore import BF16Bits, bf16_bits

# param name -> the axis of the stacked [L, ...] leaf split over ``tensor``
# (None = replicated): the JAX package's PARAM_SPECS as axis numbers
PARAM_SPECS = {
    "embed": None,
    "wq": 2,
    "wk": 2,
    "wv": 2,
    "wo": 1,
    "w1": 2,
    "w3": 2,
    "w2": 1,
    "ln_attn": None,
    "ln_mlp": None,
    "ln_out": None,
    "unembed": None,
}

# pool: [L, P, Hkv, page_size, hd] — KV heads on tensor
POOL_SPEC = 2


class TensorMesh:
    """A 1-D ``tensor`` mesh: one device per shard, in KV-head order.
    Devices may repeat (N shards on one card)."""

    def __init__(self, devices: Sequence):
        self.devices = tuple(resolve_device(d) for d in devices)
        if not self.devices:
            raise ValueError("a tensor mesh needs at least one device")

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> dict:
        return {"tensor": self.size}

    @property
    def distinct_devices(self) -> list:
        """The mesh's devices without repeats, in first-use order."""
        return list(dict.fromkeys(self.devices))

    def __repr__(self) -> str:
        return f"TensorMesh({[str(d) for d in self.devices]})"


def tensor_mesh(n: int, devices: Optional[Sequence] = None) -> TensorMesh:
    """A 1-D tensor-parallel mesh of ``n`` shards.  By default over the first
    n cards, ``cuda:0 … cuda:n-1``, refusing with fewer (the JAX package's
    message); an explicit ``devices`` list (one per shard) may repeat a
    device, ``"cpu"`` included."""
    if devices is None:
        have = torch.cuda.device_count()
        if have < n:
            raise ValueError(
                f"tensor_parallel={n} needs {n} devices, have {have} — "
                "refusing to silently run at a lower degree")
        devices = [f"cuda:{i}" for i in range(n)]
    if len(devices) != n:
        raise ValueError(f"tensor_parallel={n} needs one device per shard, "
                         f"got {len(devices)}")
    return TensorMesh(devices)


def validate_config(config, mesh: TensorMesh) -> None:
    tp = mesh.shape["tensor"]
    if config.n_kv_heads % tp or config.n_heads % tp:
        raise ValueError(
            f"tensor={tp} must divide n_heads={config.n_heads} and "
            f"n_kv_heads={config.n_kv_heads}")
    if config.d_ff % tp:
        raise ValueError(f"tensor={tp} must divide d_ff={config.d_ff}")


def _scale_spec(spec: Optional[int], s_shape: tuple) -> Optional[int]:
    """The split axis of an int8 weight's scale tensor: the weight's, except
    where the scale keeps a singleton (the contraction axis of a
    row-parallel weight), which stays unsplit — a dim of 1 can't split."""
    return None if spec is None or s_shape[spec] == 1 else spec


def _split(t: torch.Tensor, axis: Optional[int], mesh: TensorMesh,
           replicas: dict) -> list:
    """``t`` cut into the mesh's shards along ``axis`` (each its own
    contiguous tensor on its shard's device), or replicated once per
    distinct device when ``axis`` is None."""
    if axis is None:
        for dev in mesh.distinct_devices:
            if (id(t), dev) not in replicas:
                replicas[(id(t), dev)] = t.to(dev)
        return [replicas[(id(t), dev)] for dev in mesh.devices]
    n = t.shape[axis] // mesh.size
    return [t.narrow(axis, i * n, n).to(dev).contiguous()
            for i, dev in enumerate(mesh.devices)]


def shard_params(params: dict, mesh: TensorMesh) -> list:
    """Engine params -> one params dict per shard, each leaf cut by
    ``PARAM_SPECS``.  int8 weights (``{"q", "s"}`` leaves) split q by the
    weight's axis and s by the singleton-adjusted one (``_scale_spec``)."""
    out: list = [dict() for _ in mesh.devices]
    replicas: dict = {}
    for name, value in params.items():
        spec = PARAM_SPECS[name]
        if isinstance(value, dict):
            qs = _split(value["q"], spec, mesh, replicas)
            ss = _split(value["s"], _scale_spec(spec, tuple(value["s"].shape)), mesh,
                        replicas)
            for shard, q, s in zip(out, qs, ss):
                shard[name] = {"q": q, "s": s}
        else:
            for shard, t in zip(out, _split(value, spec, mesh, replicas)):
                shard[name] = t
    return out


def shard_lora(adapters: dict, mesh: TensorMesh) -> list:
    """A LoRA table (lora.py: ``{proj: {"A": [n, L, in, r], "B": [n, L, r,
    out]}}``) -> one table per shard: ``B``'s output columns split for the
    column-parallel targets (each shard's delta is its own columns), ``A``'s
    input rows split for the row-parallel ones (each shard's delta is a
    partial sum, reduced with the weight's); the other factor replicated."""
    out: list = [dict() for _ in mesh.devices]
    replicas: dict = {}
    for name, ad in adapters.items():
        col = PARAM_SPECS[name] == 2
        As = _split(ad["A"], None if col else 2, mesh, replicas)
        Bs = _split(ad["B"], 3 if col else None, mesh, replicas)
        for shard, a, b in zip(out, As, Bs):
            shard[name] = {"A": a, "B": b}
    return out


def alloc_pool(shape: tuple, mesh: TensorMesh, dtype=None, quant=None) -> list:
    """Allocate a zeroed pool ``shape`` ([L, P, Hkv, page_size, hd]) split
    on the KV-head axis, each shard allocated directly on its device — no
    device ever holds the full pool.  ``quant='int8'`` gives each shard the
    ``{"q", "s"}`` pool of model.py; ``dtype`` (default bf16) sets a plain
    pool's element type."""
    from .model import make_kv_pool

    local = list(shape)
    local[POOL_SPEC] //= mesh.size
    if quant is not None or dtype in (None, torch.bfloat16):
        return [make_kv_pool(tuple(local), quant, device=dev) for dev in mesh.devices]
    return [torch.zeros(tuple(local), dtype=dtype, device=dev) for dev in mesh.devices]


# ------------------------------------------- shard-native snapshot / scatter
#
# The KV data plane (session save/restore, swap park, handoff export, fabric
# publish) moves pool pages host <-> device through these primitives.  A
# TP-N pool is snapshotted as N per-shard host blocks, each 1/N of the
# KV-head axis read from its own shard, and restored shard to shard: no
# pool-sized gathered buffer ever exists on the host, and no shard's bytes
# pass through another shard's device.


def leaf_to_host(t: torch.Tensor) -> np.ndarray:
    """One device slab as a KV blob leaf on the host (a blocking copy): bf16
    as its raw bits (kvstore.BF16Bits), other dtypes as they are."""
    t = t.cpu()
    if t.dtype == torch.bfloat16:
        return bf16_bits(t.view(torch.int16).numpy())
    return t.numpy()


def leaf_to_tensor(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A KV blob leaf as a tensor on ``device``; bf16 bits (BF16Bits, or an
    ml_dtypes bfloat16 array) come back by a view, bit for bit."""
    bf16 = isinstance(arr, BF16Bits) or arr.dtype.name == "bfloat16"
    a = np.asarray(arr)
    if bf16:
        a = a.view(np.int16)
    if not (a.flags.writeable and a.flags.c_contiguous):
        a = np.array(a, order="C")  # e.g. read back from a page file
    t = torch.from_numpy(a)
    return (t.view(torch.bfloat16) if bf16 else t).to(device)


def shard_order(leaf: list) -> list:
    """A sharded pool leaf's per-shard tensors in KV-head order (shard i of a
    sharded KVPG frame is always the i-th block of the KV-head axis); the
    port keeps them in that order, so this checks their shapes agree."""
    shapes = {tuple(s.shape) for s in leaf}
    if len(shapes) != 1:
        raise ValueError(f"shards of one pool leaf disagree in shape: {shapes}")
    return list(leaf)


def _page_index(pages, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(pages, np.int64)).to(device)


def snapshot_shards(leaf: list, pages) -> list:
    """Per-shard host snapshot of ``pages`` (axis 1) -> one numpy block per
    shard, in KV-head order.  Each shard's page gather runs on its own
    device over its own heads; only those pages cross to the host."""
    return [leaf_to_host(s[:, _page_index(pages, s.device)]) for s in shard_order(leaf)]


def scatter_shards(leaf: list, pages, blocks: list) -> list:
    """Write per-shard host ``blocks`` into the sharded pool leaf at
    ``pages`` (axis 1), in place, shard to shard: each block goes to its own
    shard's device only.  Returns the (same) leaf."""
    for s, block in zip(shard_order(leaf), blocks):
        s[:, _page_index(pages, s.device)] = leaf_to_tensor(block, s.device)
    return leaf


# ------------------------------------------------------------- the collective


def all_reduce_sum(partials: list, mesh: Optional[TensorMesh]) -> list:
    """Sum the row-parallel partials (one per shard) and put the result on
    every shard's device.  The partials are the bf16 outputs of each
    shard's ``h @ W`` (plus its LoRA delta, in y's dtype, as the JAX
    ``_proj`` adds it); they are summed in that dtype, in shard order, on
    the first shard's device.  Where shards share a device no copy is
    made: they all get the one result tensor."""
    if mesh is None or len(partials) == 1:
        return list(partials)
    total = partials[0]
    for p in partials[1:]:
        total = total + p.to(total.device)
    return [total.to(dev) for dev in mesh.devices]
