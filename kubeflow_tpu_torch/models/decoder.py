"""Trainable decoder LM family: Llama-3 / Gemma-class (BASELINE configs 3, 4).

Counterpart of ``kubeflow_tpu/models/decoder.py``.  The architecture (GQA +
RoPE + RMSNorm + SwiGLU or GeGLU) is the serving engine's: this module sits
over the port's ``serving/engine/model.py`` ``init`` and ``forward_full``, so
the weights trained here serve there unchanged.  ``forward_full`` was written
as the engine's oracle; nothing on its default path breaks autograd (no
in-place write into a saved tensor, no ``no_grad``, no int8 or LoRA branch
without int8 leaves or an adapter table).

``gemma_7b`` uses the Gemma-1 semantics: GeGLU, sqrt(d_model) input-embedding
scaling and a decoupled head_dim of 256.

On a mesh (``with mesh:``, ``parallel/mesh.py``), with the parameters placed
by ``SHARDING_RULES`` (the JAX package's rules, verbatim), ``lm_loss`` and
``forward_full`` split their work the way GSPMD partitions the JAX model:
the batch over ``("data", "fsdp")``; Megatron on ``tensor``, each tensor
shard taking its whole query heads' columns of ``wq`` and its ``d_ff``
columns of ``w1`` / ``w3``, the rows of ``wo`` and ``w2`` giving partials
that ``psum`` adds; the ``fsdp`` dims gathered at use (``Views``).  The
vocabulary is split over ``tensor`` on both ends: the embedding is a masked
lookup per vocabulary block summed over ``tensor`` (Gemma's scale after the
sum), and the logits stay split, their cross entropy reduced over
``tensor`` (``models/_mesh.py``) without a ``[B, S, V]`` gather.  Where a
tensor shard's query heads read KV heads that ``wk`` / ``wv`` split
mid-head (``tensor`` > ``n_kv_heads``, since ``sanitize_spec`` drops only an
axis that does not divide), the shard gathers the KV columns over
``tensor`` and forms the K and V of the heads it reads.  The loss is the
exact global mean: the ``psum`` of the token-loss sums over the ``psum`` of
the counts.  Attention stays dense, as in the reference.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.shard_map_compat import axis_index, each, psum
from ..parallel.mesh import Mesh, current_mesh
from ..parallel.sharding import P, Views, place_params
from ..serving.engine import model as _engine
from ..serving.engine.model import DecoderConfig, init, params_from_jax  # noqa: F401
from . import _mesh

# params are layer-stacked ([n_layers, ...] leading dim, engine init layout)
SHARDING_RULES = (
    (r"^embed$", P("tensor", "fsdp")),
    (r"^w[qkv]$", P(None, "fsdp", "tensor")),
    (r"^wo$", P(None, "tensor", "fsdp")),
    (r"^w[13]$", P(None, "fsdp", "tensor")),
    (r"^w2$", P(None, "tensor", "fsdp")),
    (r"^unembed$", P("fsdp", "tensor")),
    (r".*", P()),
)


def gemma_7b() -> DecoderConfig:
    return DecoderConfig(
        vocab_size=256128, d_model=3072, n_layers=28, n_heads=16,
        n_kv_heads=16, d_ff=24576, rope_theta=10000.0,
        head_dim_override=256, act="gelu_tanh", scale_embed=True,
        norm_eps=1e-6,
    )


def tiny(vocab_size: int = 512) -> DecoderConfig:
    """Test-scale config (same family)."""
    return DecoderConfig(vocab_size=vocab_size, d_model=64, n_layers=2,
                         n_heads=4, n_kv_heads=2, d_ff=128)


def forward_full(params, config: DecoderConfig, tokens, lora_params=None, adapter_ids=None):
    """The serving engine's ``forward_full``: [B, S] tokens -> [B, S, V] f32
    logits.  On a mesh, a ShardedTensor split over the batch and, where the
    rules split the vocabulary, over ``tensor`` on its last dim."""
    mesh = current_mesh()
    if mesh is None:
        return _engine.forward_full(params, config, tokens, lora_params, adapter_ids)
    if lora_params is not None:
        raise ValueError("forward_full on a mesh: LoRA adapters are served, not trained")
    params = _placed(params, mesh)
    (toks,) = _mesh.batch_lists(mesh, tokens)
    logits, split = _mesh_logits(params, config, mesh, toks)
    return _mesh.split_logits(mesh, logits, tokens.shape[0], config.vocab_size, split)


def lm_loss(params: dict, config: DecoderConfig, tokens: torch.Tensor) -> torch.Tensor:
    """Next-token cross-entropy over [B, S] token ids (causal shift inside),
    on f32 logits (``optax.softmax_cross_entropy_with_integer_labels``)."""
    mesh = current_mesh()
    if mesh is not None:
        return _mesh_lm_loss(params, config, mesh, tokens)
    logits = forward_full(params, config, tokens[:, :-1])       # [B, S-1, V] f32
    targets = tokens[:, 1:].long()
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]), targets.reshape(-1))


def train_flops(config: DecoderConfig, batch: int, seq_len: int) -> float:
    """6·N·D matmul FLOPs (fwd+bwd) + attention term, for MFU accounting."""
    n = config.param_count() - config.vocab_size * config.d_model  # embed lookup is free
    # per token QK^T+PV over the ATTENTION width (n_heads*head_dim, not
    # d_model: gemma-7b decouples them, 4096 vs 3072)
    attn = config.n_layers * 2 * seq_len * config.n_heads * config.head_dim
    return 6 * batch * seq_len * (n + attn / 2)


def synthetic_lm_batches(vocab_size: int, batch_size: int, seq_len: int,
                         seed: int = 0) -> Iterator[dict]:
    """Markov-ish synthetic token stream (learnable: next = current + 0, 1
    or 2, mod vocab), drawn with numpy from ``seed``.  The JAX package draws
    with ``jax.random``: other numbers, the same law."""
    rng = np.random.default_rng(seed)
    while True:
        start = rng.integers(0, vocab_size, (batch_size, 1))
        steps = rng.integers(0, 3, (batch_size, seq_len - 1))
        toks = np.concatenate([start, np.cumsum(steps, axis=1) + start], axis=1) % vocab_size
        yield {"tokens": toks.astype(np.int32)}


# ------------------------------------------------------------ on a mesh


def _placed(params, mesh: Mesh) -> dict:
    if any(isinstance(v, dict) for v in params.values()):
        raise ValueError("the decoder's mesh path takes dense leaves, not int8 ones")
    return place_params(params, mesh, SHARDING_RULES)


def _mesh_lm_loss(params, config: DecoderConfig, mesh: Mesh, tokens) -> torch.Tensor:
    """``lm_loss`` over the mesh: each batch shard's token-loss sum on its
    vocabulary-split logits, the global mean over the batch shards."""
    params = _placed(params, mesh)
    (toks,) = _mesh.batch_lists(mesh, tokens)
    logits, split = _mesh_logits(params, config, mesh, each(lambda t: t[:, :-1], toks))
    targets = each(lambda t: t[:, 1:], toks)
    sums = _mesh.xent_sums(mesh, logits, targets,
                           _mesh.class_starts(mesh, params["unembed"], 1), split)
    return _mesh.global_mean(mesh, sums, each(torch.numel, targets))


def _mesh_logits(params: dict, config: DecoderConfig, mesh: Mesh, toks: list) -> tuple:
    """Per-position f32 logits ``[b, S, V or V/tensor]`` of the batch
    shards ``toks``, and whether they are split over ``tensor``."""
    c = config
    tp = mesh.shape["tensor"]
    if c.n_heads % tp or c.d_ff % tp:
        raise ValueError(f"tensor={tp} must divide n_heads={c.n_heads} and d_ff={c.d_ff}")
    views = Views(mesh)
    keep = ("tensor",)
    emb = params["embed"]
    starts = _mesh.class_starts(mesh, emb, 0)
    split_in = "tensor" in emb.split_axes(0)

    def lookup(t, table, lo):
        if not split_in:
            return table[t.long()]
        local = t.long() - lo
        hit = (local >= 0) & (local < table.shape[0])
        rows = table[local.clamp(0, table.shape[0] - 1)]
        return torch.where(hit[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                               device=rows.device))

    xs = each(lookup, toks, views(emb, keep), starts)
    if split_in:
        xs = psum(xs, "tensor", mesh)
    if c.scale_embed:
        xs = each(lambda x: x * float(np.sqrt(c.d_model)), xs)
    positions = each(lambda t: torch.arange(t.shape[1], device=t.device)[None, :].expand(
        t.shape[0], t.shape[1]), toks)
    masks = each(lambda t: torch.ones((t.shape[1], t.shape[1]), dtype=torch.bool,
                                      device=t.device).tril()[None].expand(
        t.shape[0], t.shape[1], t.shape[1]), toks)
    kv = _kv_plan(params, c, mesh)
    for l in range(c.n_layers):
        xs = _mesh_layer(params, l, c, mesh, views, xs, positions, masks, kv)
    hs = each(lambda x, ln: _engine._rms_norm(x, ln, c.norm_eps), xs,
              views(params["ln_out"]))
    unembed = params["unembed"]
    logits = each(lambda h, w: (h @ w).float(), hs, views(unembed, keep))
    return logits, "tensor" in unembed.split_axes(1)


def _kv_plan(params: dict, config: DecoderConfig, mesh: Mesh) -> list:
    """Per position, how it forms the K and V of the KV heads its query
    heads read: None where ``wk`` / ``wv`` hold exactly those heads on its
    tensor shard (``tensor`` divides ``n_kv_heads`` and splits them), else
    ``(first, last)`` KV head (the columns taken from the weights gathered
    over ``tensor``) and each local query head's KV head among them."""
    c = config
    tp = mesh.shape["tensor"]
    if tp == 1 or (c.n_kv_heads % tp == 0 and "tensor" in params["wk"].split_axes(2)
                   and "tensor" in params["wv"].split_axes(2)):
        return [None] * mesh.size
    nq, group = c.n_heads // tp, c.n_heads // c.n_kv_heads
    plans = {}
    for t in range(tp):
        heads = [(t * nq + j) // group for j in range(nq)]
        first = heads[0]
        plans[t] = (first, heads[-1] + 1, torch.tensor([h - first for h in heads]))
    return [plans[t] for t in axis_index("tensor", mesh)]


def _mesh_layer(params: dict, l: int, config: DecoderConfig, mesh: Mesh, views: Views,
                xs: list, positions: list, masks: list, kv: list) -> list:
    """Block ``l`` over the mesh's shards: each tensor shard its query heads
    (with the KV heads they read) and its ``d_ff`` columns, the weights'
    ``fsdp`` dims gathered, the ``wo`` and ``w2`` partials added by ``psum``
    over ``tensor``."""
    c = config
    hd, eps = c.head_dim, c.norm_eps
    keep = ("tensor",)
    hs = each(lambda x, ln: _engine._rms_norm(x, ln, eps), xs, views(params["ln_attn"], (), l))
    # a plan reads its KV columns from the weights gathered over tensor too
    kv_keep = () if any(kv) else keep

    def attention(h, pos, mask, wq, wk, wv, plan, wo):
        b, s = h.shape[:2]
        q = _engine._rope((h @ wq).reshape(b, s, -1, hd), pos, c.rope_theta)
        if plan is not None:
            lo, hi, _ = plan
            wk, wv = wk[:, lo * hd:hi * hd], wv[:, lo * hd:hi * hd]
        k = _engine._rope((h @ wk).reshape(b, s, -1, hd), pos, c.rope_theta)
        v = (h @ wv).reshape(b, s, -1, hd)
        if plan is not None:  # one KV head per local query head
            idx = plan[2].to(k.device)
            k, v = k.index_select(2, idx), v.index_select(2, idx)
        a = _engine._attn(q, k, v, mask)
        return a.reshape(b, s, -1) @ wo

    parts = each(attention, hs, positions, masks, views(params["wq"], keep, l),
                 views(params["wk"], kv_keep, l), views(params["wv"], kv_keep, l), kv,
                 views(params["wo"], keep, l))
    xs = each(torch.add, xs, psum(parts, "tensor", mesh))
    hs = each(lambda x, ln: _engine._rms_norm(x, ln, eps), xs, views(params["ln_mlp"], (), l))
    act = _engine._act(c)
    parts = each(lambda h, w1, w3, w2: (act(h @ w1) * (h @ w3)) @ w2, hs,
                 views(params["w1"], keep, l), views(params["w3"], keep, l),
                 views(params["w2"], keep, l))
    return each(torch.add, xs, psum(parts, "tensor", mesh))
