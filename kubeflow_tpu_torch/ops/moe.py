"""Mixture-of-Experts FFN with expert parallelism (``expert`` mesh axis).

Counterpart of ``kubeflow_tpu/ops/moe.py``.  Switch-Transformer-style top-k
routing with capacity, in the JAX package's dense one-hot formulation (its
einsums have no Pallas kernel, so ``torch.einsum`` is their port):

  * the router and its softmax in f32; the k choices by masked argmax (the
    first index on ties), each token's slot in its expert the running count
    of earlier tokens in (b, s) order, tokens past ``cap`` dropped (the
    residual passes them through);
  * dispatch, expert FFN (tanh GELU) and combine as dense einsums over the
    ``[T, E, cap]`` one-hot tensors;
  * aux: the Switch load-balance loss, the router z-loss and the fraction
    of dropped assignments.

On a mesh (``with mesh:``) and ``shard=True`` the work splits as GSPMD
splits the JAX op.  The tokens keep their layout (batch over ``("data",
"fsdp")``, the sequence over ``seq``); each expert shard runs its experts'
slice of ``wi`` and ``wo`` (``d_ff`` split over ``tensor``).  Capacity is
global: the routing runs over the call's whole token count in global (b, s)
order, from the router logits of every token shard gathered (``[T, E]``
f32, small), so a batch × seq split drops exactly the tokens the unsharded
op drops.  Each slot is filled by one token, so an expert shard's dispatched
buffer is the ``psum`` over the token axes of the per-shard dispatch; the
combine is each expert shard's partial (f32), summed by ``psum`` over
``expert`` (and ``tensor``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from ..parallel.mesh import current_mesh
from ..parallel.sharding import (NamedSharding, P, ShardedTensor, Views, as_sharded,
                                 place_params)
from ..utils.device import resolve_device
from .shard_map_compat import each, psum


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    d_model: int = 512
    d_ff: int = 2048


def init_moe(config: MoEConfig, device=None, seed: int = 0) -> dict:
    """Random weights from an explicit ``torch.Generator`` (drawn on the
    CPU): the router N(0, 0.02²) in f32, ``wi`` and ``wo`` scaled normals in
    bf16, as the JAX package draws them (not its numbers: use
    ``params_from_jax`` for those)."""
    dev = resolve_device(device)
    g = torch.Generator().manual_seed(seed)
    E, d, f = config.num_experts, config.d_model, config.d_ff
    return {
        "router": (torch.randn((d, E), generator=g) * 0.02).to(dev),
        "wi": (torch.randn((E, d, f), generator=g) * d ** -0.5).to(dev, torch.bfloat16),
        "wo": (torch.randn((E, f, d), generator=g) * f ** -0.5).to(dev, torch.bfloat16),
    }


def params_from_jax(np_tree: dict, device=None) -> dict:
    """The JAX package's MoE params as numpy arrays -> tensors on ``device``
    (default ``"cuda"``), bit for bit."""
    from ..models._tree import tensor_from_numpy

    dev = resolve_device(device)
    return {k: tensor_from_numpy(v).to(dev) for k, v in np_tree.items()}


# the expert split of the op's own params on a mesh: experts over `expert`,
# d_ff over `tensor`, the router replicated
_RULES = ((r"^router$", P()), (r"^wi$", P("expert", None, "tensor")),
          (r"^wo$", P("expert", "tensor", None)))
# the token layout of a plain input on a mesh
_ACT_SPEC = P(("data", "fsdp"), "seq", None)


def _gelu(x):
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def _einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.einsum`` on mixed dtypes: both operands in their promoted dtype."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(eq, a.to(dt), b.to(dt))


def capacity(config: MoEConfig, tokens: int) -> int:
    """Slots per expert for a call over ``tokens`` tokens."""
    return max(1, int(config.capacity_factor * tokens * config.top_k / config.num_experts))


def _route(logits: torch.Tensor, k: int, cap: int) -> tuple:
    """The JAX top-k loop over ``[T, E]`` f32 logits: (probs, one (gate [T],
    slot [T, E], keep [T, E]) per choice)."""
    probs = torch.softmax(logits, dim=-1)
    E = probs.shape[1]
    fills = torch.zeros(E, dtype=torch.int64, device=probs.device)
    masked = probs
    choices = []
    for _ in range(k):
        choice = masked.argmax(dim=-1)
        gate = torch.gather(masked, 1, choice[:, None])[:, 0]
        onehot = F.one_hot(choice, E)
        pos = fills[None, :] + torch.cumsum(onehot, dim=0) - onehot  # position within expert
        keep = (pos < cap) & (onehot > 0)
        choices.append((gate, pos.clamp(0, cap - 1), keep))
        fills = fills + (onehot * keep).sum(dim=0)
        masked = masked * (1.0 - onehot)
    return probs, tuple(choices)


def _slots(choices: list, cap: int) -> tuple:
    """(combine [t, e, cap] f32, dispatch [t, e, cap] bool) of the choices'
    rows and experts."""
    slots = torch.arange(cap, device=choices[0][0].device)
    combine = dispatch = None
    for gate, pos, keep in choices:
        oh_cap = (pos[..., None] == slots) & keep[..., None]
        term = oh_cap * gate[:, None, None]
        combine = term if combine is None else combine + term
        dispatch = oh_cap if dispatch is None else dispatch | oh_cap
    return combine, dispatch


def _aux(logits: torch.Tensor, probs: torch.Tensor, choices: list, k: int) -> dict:
    T, E = probs.shape
    top1 = F.one_hot(probs.argmax(dim=-1), E).float()
    load_balance = E * torch.sum(top1.mean(dim=0) * probs.mean(dim=0))
    z_loss = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    # assignments kept per token (a kept slot with a zero gate is no
    # assignment, as the JAX package counts ``combine > 0``)
    routed = sum((keep.any(dim=-1) & (gate > 0)).sum() for gate, _, keep in choices)
    return {"load_balance_loss": load_balance, "router_z_loss": z_loss,
            "fraction_dropped": 1.0 - routed / (T * k)}


def moe_ffn(params: dict, x, config: MoEConfig, shard: bool = True) -> tuple:
    """Returns (output [B,S,d], aux {load_balance_loss, router_z_loss,
    fraction_dropped}).  On a mesh with ``shard=True``, ``x`` may be a
    ShardedTensor (its layout kept; a plain tensor is laid out batch over
    ``("data", "fsdp")``, sequence over ``seq``, and the output gathered)."""
    mesh = current_mesh()
    if shard and mesh is not None:
        params = place_params(params, mesh, _RULES)
        out, aux = mesh_moe(as_sharded(x, mesh, _ACT_SPEC), config, params["router"],
                            params["wi"], params["wo"])
        return (out if isinstance(x, ShardedTensor) else out.gather()), aux
    b, s, d = x.shape
    T = b * s
    cap = capacity(config, T)
    xt = x.reshape(T, d)
    logits = xt.float() @ params["router"]
    probs, choices = _route(logits, config.top_k, cap)
    combine, dispatch = _slots(choices, cap)
    expert_in = _einsum("tec,td->ecd", dispatch.to(x.dtype), xt)       # [E, cap, d]
    h = _gelu(_einsum("ecd,edf->ecf", expert_in, params["wi"]))
    expert_out = _einsum("ecf,efd->ecd", h, params["wo"])               # [E, cap, d]
    out = _einsum("tec,ecd->td", combine.to(x.dtype), expert_out)
    return out.reshape(b, s, d), _aux(logits, probs, choices, config.top_k)


def mesh_moe(x: ShardedTensor, config: MoEConfig, router: ShardedTensor, wi: ShardedTensor,
             wo: ShardedTensor, index: Optional[int] = None,
             dtype: Optional[torch.dtype] = None) -> tuple:
    """The op over the shards of ``x``'s mesh: ``x`` the tokens ``[B, S, d]``
    (d whole); ``router``, ``wi`` and ``wo`` the weight leaves on that mesh
    (``index`` picks one entry of a leading layer dim, ``dtype`` casts
    ``wi`` and ``wo`` per use), each position computing the experts and the
    ``d_ff`` columns of its ``wi`` slice, whose splitting axes the partials
    are summed over.  Returns (out, a ShardedTensor of ``x``'s layout;
    aux)."""
    mesh = x.mesh
    B, S, d = x.shape
    T, E, k = B * S, config.num_experts, config.top_k
    cap = capacity(config, T)
    lead = 0 if index is None else 1
    tok_axes = x.split_axes(0) + x.split_axes(1)
    sum_axes = wi.split_axes(lead) + wi.split_axes(lead + 2)
    views = Views(mesh)
    wis = views(wi, sum_axes, index, dtype)
    wos = views(wo, sum_axes, index, dtype)
    e_per = wi.sharding.shard_shape(tuple(wi.shape))[lead]
    firsts = [wi.block(p)[lead] * e_per for p in range(mesh.size)]
    rows = [x.block(p)[:2] for p in range(mesh.size)]
    b_l, s_l = x.shards[0].shape[:2]

    # routing over every token in global (b, s) order, once per device
    logits = each(lambda xl, r: xl.float() @ r, x.shards, views(router, (), index))
    spec = P(*(tuple(x.spec) + (None,) * 3)[:2], None)
    glob = views(ShardedTensor(logits, (B, S, E), NamedSharding(mesh, spec)))
    routes = each(lambda g: _route(g.reshape(T, E), k, cap), glob)

    def local(route, blk, e0):
        """A position's rows of the routing, its experts' columns."""
        i, j = blk
        pick = [tuple(t.reshape(B, S, *t.shape[1:])[i * b_l:(i + 1) * b_l, j * s_l:(j + 1) * s_l]
                      .reshape(b_l * s_l, *t.shape[1:]) for t in c) for c in route[1]]
        return _slots([(g, pos[:, e0:e0 + e_per], keep[:, e0:e0 + e_per])
                       for g, pos, keep in pick], cap)

    slots = each(local, routes, rows, firsts)
    parts = each(lambda xl, sl: _einsum("tec,td->ecd", sl[1].to(x.dtype), xl.reshape(-1, d)),
                 x.shards, slots)
    expert_in = psum(parts, tok_axes, mesh) if tok_axes else parts

    def expert(ei, w_in, w_out, sl):
        """The position's experts on its slots; the combine's partial in
        f32 (the unsharded op's products, summed once after the psum)."""
        eo = _einsum("ecf,efd->ecd", _gelu(_einsum("ecd,edf->ecf", ei, w_in)), w_out)
        return torch.einsum("tec,ecd->td", sl[0].to(x.dtype).float(), eo.float())

    outs = each(expert, expert_in, wis, wos, slots)
    if sum_axes:
        outs = psum(outs, sum_axes, mesh)
    dt = torch.promote_types(torch.promote_types(x.dtype, wis[0].dtype), wos[0].dtype)
    outs = each(lambda o: o.to(dt).reshape(b_l, s_l, d), outs)
    probs, choices = routes[0]
    return x.like(outs), _aux(glob[0].reshape(T, E), probs, choices, k)
