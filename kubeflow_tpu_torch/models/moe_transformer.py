"""Composed-parallelism flagship: MoE transformer using EVERY mesh axis.

Counterpart of ``kubeflow_tpu/models/moe_transformer.py``.  One training
step of this model runs

  * ``stages``  — GPipe over the block stack (``parallel/pipeline.py``),
  * ``seq``     — sequence parallelism: activations split on the sequence
                  dim between blocks, each seq shard's queries attending to
                  the K/V gathered over ``seq`` under a causal mask offset
                  by the shard's start,
  * ``expert``  — the MoE FFN with expert-split weights (``ops/moe.py``),
  * ``tensor``  — the heads of ``wqkv``/``wo`` and the MoE ``d_ff``, the
                  partials added by ``psum``,
  * ``fsdp``/``data`` — the batch, with the embeddings' width on ``fsdp``
                  gathered before use,

on a mesh (``with mesh:``) with the parameters placed by
``SHARDING_RULES``; with no mesh, the same math on one device.  Numerics
follow the JAX package: f32 master weights cast to ``config.dtype`` per use,
RMS norm in f32 (eps 1e-6), dense causal attention, the MoE router in f32,
the loss an f32 cross entropy averaged over every predicted token.

Capacity is counted per MoE call, as in the JAX package: over the whole
batch without pipelining, per microbatch under it (``_block`` runs inside
each stage call), so the two agree only where no token is dropped.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..ops.attention import multihead_attention
from ..ops.moe import MoEConfig, mesh_moe, moe_ffn
from ..ops.shard_map_compat import each, psum
from ..parallel.mesh import Mesh, current_mesh
from ..parallel.pipeline import gpipe, stack_stages
from ..parallel.sharding import (NamedSharding, P, ShardedTensor, Views, place_params,
                                 sanitize_spec)
from ..utils.device import resolve_device
from ._tree import tensor_from_numpy


@dataclass(frozen=True)
class MoeTransformerConfig:
    vocab_size: int = 512
    d_model: int = 64
    n_layers: int = 2
    n_heads: int = 4
    num_experts: int = 4
    top_k: int = 1
    capacity_factor: float = 2.0
    max_position: int = 64
    dtype: torch.dtype = torch.bfloat16
    pipeline_stages: int = 1
    pipeline_microbatches: int = 2

    @property
    def d_ff(self) -> int:
        return self.d_model * 4

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def moe(self) -> MoEConfig:
        return MoEConfig(num_experts=self.num_experts, top_k=self.top_k,
                         capacity_factor=self.capacity_factor,
                         d_model=self.d_model, d_ff=self.d_ff)


SHARDING_RULES = (
    (r"^embed$", P(None, "fsdp")),
    (r"^unembed$", P("fsdp", "tensor")),
    # layer-stacked [L, ...]: leading dim rides `stages`
    (r"layers/wqkv", P("stages", None, None, "tensor", None)),     # [L,d,3,nh,hd]
    (r"layers/wo$", P("stages", "tensor", None, None)),            # [L,nh,hd,d]
    (r"layers/router", P("stages", None, None)),                   # [L,d,E]
    (r"layers/wi_moe", P("stages", "expert", None, "tensor")),     # [L,E,d,f]
    (r"layers/wo_moe", P("stages", "expert", "tensor", None)),     # [L,E,f,d]
    (r".*", P()),
)

# activations between blocks: batch over (data, fsdp), sequence over seq
_ACT = P(("data", "fsdp"), "seq", None)


class MoeTransformer(nn.Module):
    """The parameter tree as a module: ``embed``, ``pos`` and ``unembed`` at
    the top, the layer-stacked leaves under ``layers``, read as
    ``model["layers"]["wqkv"]`` like the JAX dict."""

    def __init__(self, tree: dict):
        super().__init__()
        for name, leaf in tree.items():
            if isinstance(leaf, dict):
                self.add_module(name, MoeTransformer(leaf))
            else:
                self.register_parameter(name, nn.Parameter(leaf))

    def __getitem__(self, name: str):
        return getattr(self, name)


def init(config: MoeTransformerConfig, device=None, seed: int = 0) -> MoeTransformer:
    """Random f32 weights from an explicit ``torch.Generator`` (drawn on the
    CPU, so a seed gives the same weights on any device), scaled as the JAX
    package scales them (not its numbers: use ``params_from_jax``)."""
    dev = resolve_device(device)
    d, nh, hd, l = config.d_model, config.n_heads, config.head_dim, config.n_layers
    E, f = config.num_experts, config.d_ff
    g = torch.Generator().manual_seed(seed)
    s = d ** -0.5

    def normal(*shape, scale):
        return (torch.randn(shape, generator=g) * scale).to(dev)

    return MoeTransformer({
        "embed": normal(config.vocab_size, d, scale=0.02),
        "pos": normal(config.max_position, d, scale=0.02),
        "layers": {
            "wqkv": normal(l, d, 3, nh, hd, scale=s),
            "wo": normal(l, nh, hd, d, scale=s),
            "ln1": torch.ones((l, d), device=dev),
            "ln2": torch.ones((l, d), device=dev),
            "router": normal(l, d, E, scale=0.02),
            "wi_moe": normal(l, E, d, f, scale=s),
            "wo_moe": normal(l, E, f, d, scale=f ** -0.5),
        },
        "unembed": normal(d, config.vocab_size, scale=s),
    })


def params_from_jax(np_tree: dict, device=None) -> MoeTransformer:
    """The JAX package's param dict as numpy arrays -> ``MoeTransformer`` on
    ``device`` (default ``"cuda"``), name for name and bit for bit."""
    dev = resolve_device(device)

    def conv(tree):
        return {k: conv(v) if isinstance(v, dict) else tensor_from_numpy(v).to(dev)
                for k, v in tree.items()}

    return MoeTransformer(conv(np_tree))


def _rms(x, scale):
    x32 = x.float()
    n = x32 * torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + 1e-6)
    return (n * scale).to(x.dtype)


def _block(config: MoeTransformerConfig, x, lp):
    """One transformer block: causal attention + MoE FFN (shape-preserving)."""
    dt = config.dtype
    xn = _rms(x, lp["ln1"])
    qkv = torch.einsum("bsd,dknh->bsknh", xn, lp["wqkv"].to(dt))
    attn = multihead_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], causal=True)
    x = x + torch.einsum("bsnh,nhd->bsd", attn, lp["wo"].to(dt))
    xn = _rms(x, lp["ln2"])
    moe_params = {"router": lp["router"], "wi": lp["wi_moe"].to(dt),
                  "wo": lp["wo_moe"].to(dt)}
    out, aux = moe_ffn(moe_params, xn, config.moe, shard=False)
    return x + out, aux


def _layer(lp, i: int) -> dict:
    return {k: lp[k][i] for k in ("wqkv", "wo", "ln1", "ln2", "router", "wi_moe", "wo_moe")}


def forward(params, config: MoeTransformerConfig, tokens) -> torch.Tensor:
    """[B, S] ids → [B, S, V] logits (aux losses dropped — dryrun/throughput
    path); on a mesh a ShardedTensor laid out batch over ``("data",
    "fsdp")``, sequence over ``seq``."""
    if isinstance(tokens, ShardedTensor):
        tokens = tokens.gather()
    mesh = current_mesh()
    if mesh is not None:
        return _mesh_forward(params, config, mesh, tokens)
    dt = config.dtype
    s = tokens.shape[1]
    x = (params["embed"][tokens.long()] + params["pos"][None, :s]).to(dt)
    lp = params["layers"]
    if config.pipeline_stages > 1:
        def stage(lps, xmb):
            for i in range(lps["ln1"].shape[0]):
                xmb, _ = _block(config, xmb, _layer(lps, i))
            return xmb

        x = gpipe(stage, stack_stages(lp, config.pipeline_stages), x,
                  config.pipeline_microbatches, mb_spec=_ACT)
    else:
        for i in range(config.n_layers):
            x, _ = _block(config, x, _layer(lp, i))
    return torch.einsum("bsd,dv->bsv", x, params["unembed"].to(dt))


def lm_loss(params, config: MoeTransformerConfig, tokens) -> torch.Tensor:
    """Next-token cross entropy in f32, the mean over every predicted token."""
    if isinstance(tokens, ShardedTensor):
        tokens = tokens.gather()
    inputs, targets = tokens[:, :-1], tokens[:, 1:].long()
    logits = forward(params, config, inputs)
    if isinstance(logits, ShardedTensor):
        mesh = logits.mesh
        tgt = ShardedTensor.shard(targets, mesh, _act_spec(mesh, tuple(targets.shape)))
        sums = each(lambda lg, t: _xent(lg, t).sum(), logits.shards, tgt.shards)
        return psum(sums, logits.split_axes(0) + logits.split_axes(1), mesh)[0] / targets.numel()
    return _xent(logits, targets).mean()


def _xent(logits, targets):
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.take_along_dim(logp, targets[..., None], dim=-1)[..., 0]


# ------------------------------------------------------------ on a mesh


def _act_spec(mesh: Mesh, shape: tuple) -> P:
    return sanitize_spec(P(*tuple(_ACT)[:len(shape)]), shape, mesh)


def _mesh_forward(params, config: MoeTransformerConfig, mesh: Mesh,
                  tokens: torch.Tensor) -> ShardedTensor:
    dt = config.dtype
    if config.n_heads % mesh.shape["tensor"]:
        raise ValueError(f"tensor={mesh.shape['tensor']} must divide "
                         f"n_heads={config.n_heads}")
    params = place_params(params, mesh, SHARDING_RULES)
    b, s = tokens.shape
    toks = ShardedTensor.shard(tokens, mesh, _act_spec(mesh, (b, s)))
    s_l = toks.shards[0].shape[1]
    starts = [toks.block(p)[1] * s_l for p in range(mesh.size)]
    views = Views(mesh)
    xs = each(lambda t, emb, pos, j: (emb[t.long()] + pos[None, j:j + t.shape[1]]).to(dt),
              toks.shards, views(params["embed"]), views(params["pos"]), starts)
    x = ShardedTensor(xs, (b, s, config.d_model),
                      NamedSharding(mesh, _act_spec(mesh, (b, s, config.d_model))))
    lp = params["layers"]
    if config.pipeline_stages > 1:
        def stage(lps, xmb):
            for i in range(lps["ln1"].shape[0]):
                xmb = _mesh_block(config, xmb, lps, i)
            return xmb

        x = gpipe(stage, stack_stages(lp, config.pipeline_stages), x,
                  config.pipeline_microbatches, mb_spec=_ACT)
    else:
        for i in range(config.n_layers):
            x = _mesh_block(config, x, lp, i)
    logits = each(lambda xl, w: torch.einsum("bsd,dv->bsv", xl, w), x.shards,
                  views(params["unembed"], (), None, dt))
    return ShardedTensor(logits, (b, s, config.vocab_size),
                         NamedSharding(mesh, P(*tuple(x.spec)[:2], None)))


def _mesh_block(config: MoeTransformerConfig, x: ShardedTensor, lp, i: int) -> ShardedTensor:
    """``_block`` over the shards of ``x``'s mesh (a pipeline stage's
    sub-mesh under pp): each tensor shard its heads, each seq shard its
    queries against the K/V gathered over ``seq``, the causal mask offset by
    the shard's start; the ``wo`` partials added by ``psum`` over
    ``tensor``; then the expert-parallel MoE FFN."""
    mesh, dt = x.mesh, config.dtype
    views = Views(mesh)
    b, s, d = x.shape
    hd = config.head_dim
    xn = each(_rms, x.shards, views(lp["ln1"], (), i))
    qkv = each(lambda xl, w: torch.einsum("bsd,dknh->bsknh", xl, w), xn,
               views(lp["wqkv"], ("tensor",), i, dt))
    heads = P(*tuple(x.spec)[:2], "tensor", None)

    def gathered(c):
        st = ShardedTensor(each(lambda t: t[:, :, c], qkv), (b, s, config.n_heads, hd),
                           NamedSharding(mesh, heads))
        return views(st, keep=tuple(a for a in mesh.axis_names if a != "seq"))

    s_l = x.shards[0].shape[1]
    starts = [x.block(p)[1] * s_l for p in range(mesh.size)]

    def attend(t, k, v, j):
        q = t[:, :, 0]
        causal = (torch.arange(j, j + q.shape[1], device=q.device)[:, None]
                  >= torch.arange(k.shape[1], device=q.device)[None, :])
        return multihead_attention(q, k, v, mask=causal[None, None])

    attn = each(attend, qkv, gathered(1), gathered(2), starts)
    parts = each(lambda a, w: torch.einsum("bsnh,nhd->bsd", a, w), attn,
                 views(lp["wo"], ("tensor",), i, dt))
    if mesh.shape["tensor"] > 1:
        parts = psum(parts, "tensor", mesh)
    xs = each(lambda xl, a: xl + a, x.shards, parts)
    xn = each(_rms, xs, views(lp["ln2"], (), i))
    out, _ = mesh_moe(x.like(xn), config.moe, lp["router"], lp["wi_moe"], lp["wo_moe"], i, dt)
    return x.like(each(lambda xl, o: xl + o, xs, out.shards))
