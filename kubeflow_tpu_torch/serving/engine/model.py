"""Llama-class decoder in PyTorch with a paged KV cache.

Counterpart of ``kubeflow_tpu/serving/engine/model.py``, function for
function, so each entry point can be held against its JAX twin:

  * params are a plain dict of tensors with the JAX package's names and
    layouts (stacked ``[L, ...]`` per-layer weights, right-multiplied
    projections), so ``params_from_jax`` carries weights across unchanged;
  * KV lives in a page pool ``[layers, num_pages, kv_heads, page_size, hd]``
    (head BEFORE token-in-page: the paged kernel reads one head's page as a
    contiguous ``[page_size, hd]`` tile), bf16 or int8 with per-token
    scales; page bookkeeping is in the C++ core (native.py);
  * the JAX package's cast points are kept: f32 variance in ``_rms_norm``,
    f32 RoPE, f32 scores with bf16 probabilities in ``_attn``, bf16 unembed
    then ``.float()``;
  * pools are updated IN PLACE (``index_put_``) where the JAX functions
    donate and return them: the entry points still return the pools, which
    are the very tensors passed in;
  * decode attention goes through ``paged_attention`` (a hand-written Hopper
    kernel on the card) with ``paged=True``, or through the gather path that
    matches the JAX engine's default with ``paged=False``.  Prefill attention
    is plain tensor code, as it is XLA code in the JAX package;
  * the pipelined loop's fused steps (``decode_step_sample``, and for
    speculative decoding ``decode_step_k``, ``decode_step_verify_sample``
    and ``decode_step_sample_packed``) sample and guard on the device and
    return one small int32 output per slot, so a tick copies back only
    tokens.  The verify steps run K query rows per slot, through the paged
    kernel at K > 1 with ``paged=True``.  A ``token_mask`` (grammar-legal
    tokens) sets every other logit to the finite ``-1e30`` after the NaN
    guard has read the raw logits;
  * weights may be int8 (``quantize_weights_int8``: ``{"q", "s"}`` leaves,
    dequantized per use by ``_w`` and ``_embed_rows``), and every
    projection adds a per-row LoRA delta when an adapter table is passed
    (``lora_params``, ``adapter_ids``; lora.py).  Both are plain tensor
    code, as they are XLA code in the JAX package;
  * ``mesh=`` (sharding.TensorMesh) runs an entry point tensor-parallel
    over per-shard params and pools, as GSPMD partitions the JAX
    functions: each shard its own heads and d_ff columns, the ``wo`` and
    ``w2`` partials summed by ``sharding.all_reduce_sum``, decode
    attention through one paged-kernel launch per shard.

Every function takes the device from its inputs; ``init`` and
``load_params`` take an explicit ``device`` (default ``"cuda"``, which
raises on a machine without a card).
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ...utils.device import resolve_device
from .hf_convert import is_hf_config
from .paged_attention import paged_attention
from .sharding import all_reduce_sum


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    vocab_size: int = 2048
    d_model: int = 256
    n_layers: int = 4
    n_heads: int = 8
    n_kv_heads: int = 4
    d_ff: int = 688
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    # Gemma-family deltas from the Llama block: explicit head_dim (0 =
    # d_model // n_heads); MLP activation ("silu" = SwiGLU, "gelu_tanh" =
    # GeGLU); sqrt(d_model) input-embedding scaling
    head_dim_override: int = 0
    act: str = "silu"
    scale_embed: bool = False

    @property
    def head_dim(self) -> int:
        return self.head_dim_override or self.d_model // self.n_heads

    @staticmethod
    def llama3_8b() -> "DecoderConfig":
        return DecoderConfig(vocab_size=128256, d_model=4096, n_layers=32,
                             n_heads=32, n_kv_heads=8, d_ff=14336, rope_theta=500000.0)

    @staticmethod
    def from_dir(model_dir: str) -> Optional["DecoderConfig"]:
        path = os.path.join(model_dir, "config.json")
        if not os.path.exists(path):
            return None
        with open(path) as f:
            raw = json.load(f)
        if is_hf_config(raw):
            # a transformers config: vocab_size matches our field name but
            # hidden_size/num_hidden_layers don't, so silently filtering
            # would produce a config with DEFAULT dims and garbage serving
            raise ValueError(
                f"{path} is a HuggingFace config — convert the checkpoint "
                "first (kubeflow_tpu_torch.serving.engine.hf_convert; the "
                "JetStream runtime auto-converts on load)")
        fields = {f.name for f in dataclasses.fields(DecoderConfig)}
        return DecoderConfig(**{k: v for k, v in raw.items() if k in fields})

    def param_count(self) -> int:
        hd = self.head_dim
        per_layer = (
            self.d_model * self.n_heads * hd          # wq
            + 2 * self.d_model * self.n_kv_heads * hd  # wk, wv
            + self.n_heads * hd * self.d_model         # wo
            + 3 * self.d_model * self.d_ff             # w1, w2, w3
            + 2 * self.d_model                         # norms
        )
        return self.vocab_size * self.d_model * 2 + self.n_layers * per_layer + self.d_model

    # analytical FLOPs model: matmul FLOPs only, 2*mul-adds (norms, RoPE,
    # softmax and activations are noise next to the matmuls)

    def matmul_flops_per_token(self) -> int:
        """Forward matmul FLOPs for ONE token through every projection +
        the unembed — everything except attention-score/value math."""
        hd = self.head_dim
        per_layer = 2 * (
            self.d_model * self.n_heads * hd           # wq
            + 2 * self.d_model * self.n_kv_heads * hd  # wk, wv
            + self.n_heads * hd * self.d_model         # wo
            + 3 * self.d_model * self.d_ff             # w1, w3, w2
        )
        return self.n_layers * per_layer + 2 * self.d_model * self.vocab_size

    def attn_flops_per_token(self, context: int) -> int:
        """Attention score (QK^T) + value (AV) FLOPs for one token
        attending over ``context`` positions, all layers: 2*2*S*hd per
        query head per layer."""
        return self.n_layers * 4 * self.n_heads * self.head_dim * context


# --------------------------------------------------------------------- params

_INIT_CHUNK = 1 << 24  # elements per f32 transient while initialising


def _randn_into(out: torch.Tensor, gen: torch.Generator, fan_in: float) -> torch.Tensor:
    """Fill ``out`` with N(0, 1/fan_in) draws, row block by row block, so the
    f32 transient stays a few tens of MB and no f32 copy of the model ever
    exists (llama3-8b is 16 GB in bf16)."""
    rows = out.view(-1, out.shape[-1])
    step = max(1, _INIT_CHUNK // rows.shape[1])
    for lo in range(0, rows.shape[0], step):
        blk = rows[lo:lo + step]
        blk.copy_(torch.randn(blk.shape, generator=gen, device=out.device,
                              dtype=torch.float32) / math.sqrt(fan_in))
    return out


def init(config: DecoderConfig, device=None, seed: int = 0,
         dtype: torch.dtype = torch.bfloat16) -> dict:
    """Random-init params with a ``torch.Generator`` seeded by ``seed``.

    Same names, shapes and scales as the JAX package's ``init``; the draws
    differ (another generator), which random-weight benches don't care
    about.  ``device`` defaults to ``"cuda"``."""
    c = config
    hd = c.head_dim
    n = c.n_layers
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def w(*shape, fan_in):
        return _randn_into(torch.empty(shape, dtype=dtype, device=dev), gen, fan_in)

    return {
        "embed": w(c.vocab_size, c.d_model, fan_in=1.0),
        "wq": w(n, c.d_model, c.n_heads * hd, fan_in=c.d_model),
        "wk": w(n, c.d_model, c.n_kv_heads * hd, fan_in=c.d_model),
        "wv": w(n, c.d_model, c.n_kv_heads * hd, fan_in=c.d_model),
        "wo": w(n, c.n_heads * hd, c.d_model, fan_in=c.n_heads * hd),
        "w1": w(n, c.d_model, c.d_ff, fan_in=c.d_model),
        "w3": w(n, c.d_model, c.d_ff, fan_in=c.d_model),
        "w2": w(n, c.d_ff, c.d_model, fan_in=c.d_ff),
        "ln_attn": torch.ones((n, c.d_model), dtype=dtype, device=dev),
        "ln_mlp": torch.ones((n, c.d_model), dtype=dtype, device=dev),
        "ln_out": torch.ones((c.d_model,), dtype=dtype, device=dev),
        "unembed": w(c.d_model, c.vocab_size, fan_in=c.d_model),
    }


def _tensor_from_numpy(arr) -> torch.Tensor:
    """numpy array -> CPU tensor.  bf16 arrays (numpy has no bf16 of its
    own; JAX hands out ml_dtypes.bfloat16) travel bit-exactly through an
    int16 view, recognised by dtype name so nothing imports ml_dtypes."""
    arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:  # e.g. a view of a JAX buffer: never alias it
        arr = arr.copy()
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def params_from_jax(np_params: dict, device=None) -> dict:
    """The weight carrier: a dict of numpy arrays (``np.asarray`` of the JAX
    package's params) -> a dict of tensors on ``device`` (default
    ``"cuda"``), dtypes unchanged.  An int8 leaf ``{"q", "s"}`` (the JAX
    package's ``quantize_weights_int8``) keeps its int8 payload and its bf16
    scales bit for bit."""
    dev = resolve_device(device)
    out = {}
    for name, arr in np_params.items():
        if isinstance(arr, dict):
            out[name] = {k: _tensor_from_numpy(arr[k]).to(dev) for k in ("q", "s")}
        else:
            out[name] = _tensor_from_numpy(arr).to(dev)
    return out


def param_leaves(params: dict) -> list:
    """Every tensor of a params dict (an int8 leaf is its ``q`` and ``s``)."""
    return [t for v in params.values()
            for t in (v.values() if isinstance(v, dict) else (v,))]


def param_bytes(params: dict) -> int:
    """Bytes the params take on their device."""
    return sum(t.numel() * t.element_size() for t in param_leaves(params))


def load_params(model_dir: str, config: DecoderConfig, device=None) -> dict:
    """Load weights from model_dir/params.npz (cast to bf16) if present,
    else random init (seed 0)."""
    path = os.path.join(model_dir, "params.npz")
    if os.path.exists(path):
        dev = resolve_device(device)
        raw = np.load(path)
        return {k: _tensor_from_numpy(raw[k]).to(dev, torch.bfloat16)
                for k in raw.files}
    return init(config, device)


# ------------------------------------------------ int8 weight quantization
#
# Weight-only int8: each matmul weight becomes {"q": int8, "s": bf16 scales}
# with one scale per OUTPUT channel (the contraction axis is reduced over,
# so the matmul stays exact up to int8 rounding); the embedding table gets
# one scale per row.  At-rest weight bytes halve.  ``_w`` dequantizes
# (``q.to(bf16) * s``) at each use, as the JAX package's ``_w`` does inside
# its jit.  The numerics are the JAX package's to the bit: the scale is
# computed in f32, the payload rounded half to even from the f32 quotient,
# and only then is the scale stored as bf16.

_QUANT_KEYS = ("wq", "wk", "wv", "wo", "w1", "w2", "w3", "embed", "unembed")


def _quant_f32(blk: torch.Tensor, axis: int = -2):
    """Quantize one f32 block, scales reduced over ``axis``: -2 (default)
    per output channel, for the matmul weights; -1 per row, for the
    embedding table (each token's row carries its own scale, so one outlier
    row does not degrade every other token).  Returns (q int8, s bf16)."""
    s = blk.abs().amax(dim=axis, keepdim=True).clamp(min=1e-8) / 127.0
    q = torch.round(blk / s).clamp(-127, 127).to(torch.int8)
    return q, s.to(torch.bfloat16)


def quantize_weights_int8(params: dict, col_chunk: int = 2048) -> dict:
    """Matmul and embedding weights -> {"q": int8, "s": bf16} (norms stay
    dense), on each weight's own device, chunked over output columns (over
    vocab rows for ``embed``): the int8 leaves are allocated once and filled
    block by block, so the peak transient is one f32 block and no dense f32
    copy of the model ever exists.  Leaves already quantized pass
    through."""
    out = {}
    for name, w in params.items():
        if name not in _QUANT_KEYS or isinstance(w, dict):
            out[name] = w
            continue
        rows = name == "embed"  # per-row: chunk over vocab rows instead
        q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
        s_shape = (w.shape[0], 1) if rows else tuple(w.shape[:-2]) + (1, w.shape[-1])
        s = torch.empty(s_shape, dtype=torch.bfloat16, device=w.device)
        n = w.shape[0] if rows else w.shape[-1]
        for lo in range(0, n, col_chunk):
            if rows:
                q[lo:lo + col_chunk], s[lo:lo + col_chunk] = _quant_f32(
                    w[lo:lo + col_chunk].float(), axis=-1)
            else:
                q[..., lo:lo + col_chunk], s[..., lo:lo + col_chunk] = _quant_f32(
                    w[..., lo:lo + col_chunk].float())
        out[name] = {"q": q, "s": s}
    return out


def init_int8(config: DecoderConfig, device=None, seed: int = 0) -> dict:
    """Random-init DIRECTLY into int8 weights, one layer (and, for the
    embedding tables, one block) at a time, so the dense bf16 model never
    exists.  Same names, shapes, scales and quantization as ``init`` then
    ``quantize_weights_int8``, from a ``torch.Generator`` seeded by
    ``seed``; as in the JAX package, the draws are laid out per layer and
    per block, so they differ from ``init``'s, which random-weight benches
    don't care about.  ``device`` defaults to ``"cuda"``."""
    c = config
    hd = c.head_dim
    n = c.n_layers
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def draw(shape, fan_in):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32) / math.sqrt(fan_in)

    def q2(rows, cols, fan_in, per_row=False):
        q = torch.empty((rows, cols), dtype=torch.int8, device=dev)
        s = torch.empty((rows, 1) if per_row else (1, cols),
                        dtype=torch.bfloat16, device=dev)
        step = 2048
        for lo in range(0, rows if per_row else cols, step):
            if per_row:
                q[lo:lo + step], s[lo:lo + step] = _quant_f32(
                    draw((min(step, rows - lo), cols), fan_in), axis=-1)
            else:
                q[:, lo:lo + step], s[:, lo:lo + step] = _quant_f32(
                    draw((rows, min(step, cols - lo)), fan_in))
        return {"q": q, "s": s}

    def q3(in_dim, out_dim, fan_in):
        q = torch.empty((n, in_dim, out_dim), dtype=torch.int8, device=dev)
        s = torch.empty((n, 1, out_dim), dtype=torch.bfloat16, device=dev)
        for l in range(n):
            q[l], s[l] = _quant_f32(draw((in_dim, out_dim), fan_in))
        return {"q": q, "s": s}

    bf16 = torch.bfloat16
    return {
        "embed": q2(c.vocab_size, c.d_model, 1.0, per_row=True),
        "wq": q3(c.d_model, c.n_heads * hd, c.d_model),
        "wk": q3(c.d_model, c.n_kv_heads * hd, c.d_model),
        "wv": q3(c.d_model, c.n_kv_heads * hd, c.d_model),
        "wo": q3(c.n_heads * hd, c.d_model, c.n_heads * hd),
        "w1": q3(c.d_model, c.d_ff, c.d_model),
        "w3": q3(c.d_model, c.d_ff, c.d_model),
        "w2": q3(c.d_ff, c.d_model, c.d_ff),
        "ln_attn": torch.ones((n, c.d_model), dtype=bf16, device=dev),
        "ln_mlp": torch.ones((n, c.d_model), dtype=bf16, device=dev),
        "ln_out": torch.ones((c.d_model,), dtype=bf16, device=dev),
        "unembed": q2(c.d_model, c.vocab_size, c.d_model),
    }


def _w(p, l=None):
    """Weight leaf -> bf16 dense slice (dequantizing {"q", "s"} per use)."""
    if isinstance(p, dict):
        q, s = (p["q"], p["s"]) if l is None else (p["q"][l], p["s"][l])
        return q.to(torch.bfloat16) * s
    return p if l is None else p[l]


def _embed_rows(p, tokens):
    """Embedding gather that dequantizes AFTER the row gather (dequantizing
    the whole [V, D] table first would materialize it dense); the per-row
    scales are gathered alongside the rows."""
    if isinstance(p, dict):
        return p["q"][tokens].to(torch.bfloat16) * p["s"][tokens]
    return p[tokens]


# --------------------------------------------------------------------- blocks


def _embed(params, config, tokens):
    """Input embedding incl. Gemma's sqrt(d_model) input-side scaling."""
    x = _embed_rows(params["embed"], tokens)
    if config.scale_embed:
        x = x * float(np.sqrt(config.d_model))
    return x


def _rms_norm(x, scale, eps):
    var = x.float().square().mean(-1, keepdim=True)
    return (x * torch.rsqrt(var + eps).to(x.dtype)) * scale


def _rope(x, positions, theta):
    """x: [..., S, H, hd]; positions: [..., S]."""
    hd = x.shape[-1]
    freqs = theta ** (-torch.arange(0, hd // 2, dtype=torch.float32,
                                    device=x.device) / (hd // 2))
    angles = positions[..., None, None].float() * freqs  # [..., S, 1, hd/2]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _attn(q, k, v, mask):
    """q: [B,S,Hq,hd], k/v: [B,T,Hkv,hd], mask: [B,S,T] bool (True=visible)."""
    group = q.shape[2] // k.shape[2]
    k = k.repeat_interleave(group, dim=2)
    v = v.repeat_interleave(group, dim=2)
    scores = torch.einsum("bshd,bthd->bhst", q.float(), k.float())
    scores = scores / math.sqrt(q.shape[-1])
    scores = torch.where(mask[:, None, :, :], scores, -1e30)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhst,bthd->bshd", probs.to(v.dtype), v)


def _proj(params, l, name, h, lora=None):
    """h @ W[name][l], plus the per-row LoRA delta when an adapter table is
    live: ``lora`` = (adapters, adapter_ids) where adapters[name] holds
    stacked {"A": [n_adapters, L, in, r], "B": [n_adapters, L, r, out]}
    (adapter 0 is all zeros = "no adapter", so a row without one multiplies
    by zeros instead of branching) and adapter_ids is [B] selecting each
    batch row's adapter."""
    y = h @ _w(params[name], l)
    if lora is not None and name in lora[0]:
        ad, aids = lora[0][name], lora[1]
        A = ad["A"][aids, l]   # [B, in, r]: a small gather, r is 8-64
        Bm = ad["B"][aids, l]  # [B, r, out]
        delta = torch.einsum("bsr,bro->bso", torch.einsum("bsd,bdr->bsr", h, A), Bm)
        y = y + delta.to(y.dtype)
    return y


def _lora(lora_params, adapter_ids):
    """The ``lora`` argument of ``_proj``: None without an adapter table."""
    if lora_params is None:
        return None
    return lora_params, adapter_ids.long()


def _act(config):
    """The MLP activation of ``config.act``."""
    if config.act == "silu":
        return F.silu
    if config.act == "gelu_tanh":
        return lambda t: F.gelu(t, approximate="tanh")
    # a typo'd config must not silently serve wrong math
    raise ValueError(f"unknown act {config.act!r} (silu | gelu_tanh)")


def _kv_proj(params, l, config, h, positions, lora=None):
    """This shard's new K (roped) and V, ``[B, S, Hkv/N, hd]``."""
    c = config
    B, S = h.shape[:2]
    k = _proj(params, l, "wk", h, lora).reshape(B, S, -1, c.head_dim)
    v = _proj(params, l, "wv", h, lora).reshape(B, S, -1, c.head_dim)
    k = _rope(k, positions, c.rope_theta)
    return k, v


# ------------------------------------------------------------ tensor parallel
#
# Every entry point takes ``mesh`` (sharding.TensorMesh, default None).
# With a mesh, ``params`` is the per-shard list of sharding.shard_params,
# each pool a per-shard list of sharding.alloc_pool and ``lora_params`` the
# per-shard list of sharding.shard_lora; without one they are a single dict,
# pool and table, run as a mesh of one shard through the same code.  Each
# shard computes its own query and KV heads and its own d_ff columns; the
# row-parallel ``wo`` and ``w2`` partials meet in sharding.all_reduce_sum,
# the only collective (the two GSPMD inserts in the JAX package).
# Replicated work (norms, residual adds) runs once per distinct device; the
# embedding, the final norm and the unembed run on the first shard's
# device, where the logits are sampled.


def _shards(mesh, *trees) -> list:
    """Each of ``trees`` as a per-shard list (a one-element one without a
    mesh)."""
    return [t if mesh is not None else [t] for t in trees]


def _devices(mesh, home: torch.device) -> list:
    return list(mesh.devices) if mesh is not None else [home]


def _rep(t, devs: list) -> list:
    """``t`` on each shard's device (the one tensor where devices repeat)."""
    return [t.to(d) for d in devs]


def _each(fn, *per_shard) -> list:
    """``fn`` over the shards' replicas of replicated values, once per
    distinct set of inputs: shards on one device hold the same tensors, so
    their replicated work runs once."""
    memo: dict = {}
    out = []
    for args in zip(*per_shard):
        key = tuple(id(a) for a in args)
        if key not in memo:
            memo[key] = fn(*args)
        out.append(memo[key])
    return out


def _shard_lora(lora, s: int, device):
    """Shard ``s``'s ``lora`` argument of ``_proj`` on its device."""
    if lora is None:
        return None
    tables, aids = lora
    return (tables[s] if isinstance(tables, list) else tables), aids.to(device)


def _layer(shards, l, config, xs, positions, write_kv, attend, lora, mesh):
    """One transformer block on every shard.  ``xs`` and ``positions`` are
    the shards' replicas of the residual stream ``[B, S, D]`` and of the
    token positions; ``write_kv(s, k, v)`` stores shard s's new KV (its own
    heads) before attention, and ``attend(qs)`` maps the shards' roped
    queries ``[B, S, Hq/N, hd]`` to their attention outputs (the hook where
    the gather path and the paged kernel diverge).  Returns the shards'
    replicas of the block's output."""
    c = config
    eps = c.norm_eps
    hs = _each(lambda x, ln: _rms_norm(x, ln[l], eps), xs, [p["ln_attn"] for p in shards])
    los = [_shard_lora(lora, s, h.device) for s, h in enumerate(hs)]
    qs = []
    for s, (p, h, lo) in enumerate(zip(shards, hs, los)):
        B, S = h.shape[:2]
        k, v = _kv_proj(p, l, c, h, positions[s], lo)
        write_kv(s, k, v)
        q = _proj(p, l, "wq", h, lo).reshape(B, S, -1, c.head_dim)
        qs.append(_rope(q, positions[s], c.rope_theta))
    outs = attend(qs)
    partials = [_proj(p, l, "wo", a.reshape(a.shape[0], a.shape[1], -1), lo)
                for p, a, lo in zip(shards, outs, los)]
    xs = _each(torch.add, xs, all_reduce_sum(partials, mesh))
    hs = _each(lambda x, ln: _rms_norm(x, ln[l], eps), xs, [p["ln_mlp"] for p in shards])
    act = _act(c)
    partials = [_proj(p, l, "w2", act(_proj(p, l, "w1", h, lo)) * _proj(p, l, "w3", h, lo), lo)
                for p, h, lo in zip(shards, hs, los)]
    return _each(torch.add, xs, all_reduce_sum(partials, mesh))


def _logits(shards, config, x):
    """Final norm and unembed on the first shard's device, f32."""
    x = _rms_norm(x, shards[0]["ln_out"], config.norm_eps)
    return (x @ _w(shards[0]["unembed"])).float()


def _dense_attend(qs, caches, masks):
    """The gather path's attention: each shard's queries over its own
    contiguous ``[B, T, Hkv/N, hd]`` cache."""
    return [_attn(q, k, v, m) for q, (k, v), m in zip(qs, caches, masks)]


def _paged_attend(qs, k_pools, v_pools, l, page_table, seq_lens, page_size, mesh):
    """The paged kernel over layer ``l`` of each shard's pool: one launch
    per shard (``paged_attention``'s mesh wrapper), or one call without a
    mesh."""
    kls = [pool_layer(kp, l) for kp in k_pools]
    vls = [pool_layer(vp, l) for vp in v_pools]
    if mesh is None:
        return [paged_attention(qs[0], kls[0], vls[0], page_table, seq_lens, page_size)]
    return paged_attention(qs, kls, vls, page_table, seq_lens, page_size, mesh=mesh)


def _gather_cache(pool, l, rows, T, hd):
    """Pool pages ``rows`` [B, n] of layer ``l`` as a token-major cache
    ``[B, n * page, Hkv/N, hd]``."""
    B = rows.shape[0]
    return pool_get(pool, (l, rows)).permute(0, 1, 3, 2, 4).reshape(B, T, -1, hd)


# ------------------------------------------------------------------- KV pools
#
# A pool is either a bf16 tensor [L, P, Hkv, page_size, hd] or, with int8
# KV-cache quantization, a dict {"q": int8 same-shape, "s": bf16 per
# (head, token) scales [L, P, Hkv, page_size, 1]}.  Only the read/write
# sites below branch on the representation.


def make_kv_pool(shape, quant: Optional[str] = None, device=None):
    """Allocate one zeroed KV pool. ``quant``: None (bf16) or "int8"."""
    dev = resolve_device(device)
    if quant is None:
        return torch.zeros(shape, dtype=torch.bfloat16, device=dev)
    if quant != "int8":
        raise ValueError(f"unsupported kv_quant {quant!r} (None or 'int8')")
    return {"q": torch.zeros(shape, dtype=torch.int8, device=dev),
            "s": torch.zeros(tuple(shape[:-1]) + (1,), dtype=torch.bfloat16,
                             device=dev)}


def pool_page_size(pool) -> int:
    return (pool["q"] if isinstance(pool, dict) else pool).shape[3]


def _quantize_kv(x):
    """Per-(token,head) symmetric int8: scale = amax/127 over head_dim.
    Quantization divides by the bf16-ROUNDED scale (what pool_get will
    multiply by), so storage rounding doesn't bias every element of a row."""
    x32 = x.float()
    amax = x32.abs().amax(-1, keepdim=True)
    scale = (amax / 127.0).clamp(min=1e-8).to(torch.bfloat16)
    q = torch.round(x32 / scale.float()).clamp(-127, 127).to(torch.int8)
    return q, scale


def pool_set(pool, idx, x):
    """pool[idx] = x IN PLACE, quantizing on write when the pool is int8.
    Returns the (same) pool, mirroring the JAX functional signature."""
    if isinstance(pool, dict):
        q, s = _quantize_kv(x)
        pool["q"][idx] = q
        pool["s"][idx] = s
    else:
        pool[idx] = x.to(pool.dtype)
    return pool


def pool_get(pool, idx):
    """Gather pool[idx], dequantizing to bf16 when the pool is int8."""
    if isinstance(pool, dict):
        return pool["q"][idx].to(torch.bfloat16) * pool["s"][idx]
    return pool[idx]


def pool_layer(pool, l):
    """One layer's slice of a pool (a view), preserving the int8 dict shape
    (the form paged_attention consumes)."""
    if isinstance(pool, dict):
        return {"q": pool["q"][l], "s": pool["s"][l]}
    return pool[l]


def _lengths(lengths, B, device):
    """Per-row lengths as a [B] long tensor (a scalar broadcasts)."""
    return torch.as_tensor(lengths, device=device).long().reshape(-1).expand(B)


# -------------------------------------------------------------------- prefill


def prefill(params, config: DecoderConfig, tokens, lengths, page_size: int,
            lora_params=None, adapter_ids=None, mesh=None):
    """Process a batch of same-bucket prompts in one call.

    tokens: [B, S] int (each row padded to the shared bucket S); lengths:
    [B] int per-row prompt lengths (a scalar broadcasts); adapter_ids: [B]
    per-row LoRA adapter, so mixed-adapter groups still share a call.  Returns
    (logits_last [B, vocab] f32, paged_k, paged_v) where paged_k/v are
    [layers, B, S/page_size, Hkv, page_size, hd] — ready to scatter into the
    page pool at each row's page ids via ``write_pages``.  With ``mesh``,
    paged_k/v are per-shard lists, each holding that shard's KV heads."""
    c = config
    B, S = tokens.shape
    dev = tokens.device
    (shards,) = _shards(mesh, params)
    lora = _lora(lora_params, adapter_ids)
    devs = _devices(mesh, dev)
    tokens = tokens.long()
    lengths = _lengths(lengths, B, dev)
    pos_row = torch.arange(S, device=dev)
    positions = _rep(pos_row[None, :].expand(B, S), devs)
    causal = torch.ones((S, S), dtype=torch.bool, device=dev).tril()[None]
    valid = pos_row[None, None, :] < lengths[:, None, None]
    masks = _rep(causal & valid, devs)  # [B, S, S]
    xs = _rep(_embed(shards[0], c, tokens), devs)
    ks = [[] for _ in shards]
    vs = [[] for _ in shards]
    kv: list = [None] * len(shards)

    def write_kv(s, k, v):
        ks[s].append(k)
        vs[s].append(v)
        kv[s] = (k, v)

    for l in range(c.n_layers):
        xs = _layer(shards, l, c, xs, positions, write_kv,
                    lambda qs: _dense_attend(qs, kv, masks), lora, mesh)
    # logits at each row's last REAL token (lengths-1)
    logits = _logits(shards, c, xs[0][torch.arange(B, device=dev), lengths - 1])
    n_pages = S // page_size

    def paged(per_layer):  # -> [L, B, n_pages, Hkv/N, ps, hd]
        t = torch.stack(per_layer)
        return (t.reshape(c.n_layers, B, n_pages, page_size, t.shape[3], c.head_dim)
                .permute(0, 1, 2, 4, 3, 5))

    paged_k = [paged(k) for k in ks]
    paged_v = [paged(v) for v in vs]
    if mesh is None:
        return logits, paged_k[0], paged_v[0]
    return logits, paged_k, paged_v


def write_pages(k_pool, v_pool, paged_k, paged_v, page_ids, mesh=None):
    """Scatter prefilled KV into the pools at page_ids, in place.

    Batched form: paged_k/v [layers, B, n, Hkv, page_size, hd] with
    page_ids [B, n] (rows route unowned tail pages to the reserved trash
    page 0).  The single-prompt form (paged [layers, n, ...], page_ids [n])
    also works.  With ``mesh``, pools and paged_k/v are per-shard lists and
    each shard writes its own heads.  Returns the (same) pools."""
    if page_ids.ndim == 2:
        page_ids = page_ids.reshape(-1)
    kps, vps, pks, pvs = _shards(mesh, k_pool, v_pool, paged_k, paged_v)
    for kp, vp, pk, pv in zip(kps, vps, pks, pvs):
        L = pk.shape[0]
        idx = (slice(None), page_ids.to(pk.device).long())
        pool_set(kp, idx, pk.reshape((L, -1) + tuple(pk.shape[-3:])))
        pool_set(vp, idx, pv.reshape((L, -1) + tuple(pv.shape[-3:])))
    return k_pool, v_pool


def prefill_chunk(params, config: DecoderConfig, tokens, start, lengths,
                  chunk_page_ids, hist_page_ids, k_pool, v_pool, page_size: int,
                  lora_params=None, adapter_ids=None, mesh=None):
    """Advance a BATCH of long prompts one page-aligned chunk each, in one
    call against the page pool (chunked prefill: a long prompt never
    head-of-line-blocks the decode steps of other slots).

    tokens: [B, C] int chunks (padded past each prompt end); start: shared
    offset of this chunk in the prompts; lengths: [B] per-row total prompt
    lengths (scalar broadcasts); chunk_page_ids: [B, C/page_size] pool pages
    to scatter each row's chunk KV into (unowned tail slots point at the
    trash page 0); hist_page_ids: [B, H] pool pages covering positions
    [0, start+C) per row; adapter_ids: [B] per-row LoRA adapter.  Pools
    are written in place (with ``mesh``, each shard its own).

    Returns (logits [B, vocab] at each row's position length-1 — garbage
    unless that row's final chunk — , k_pool, v_pool)."""
    c = config
    B, C = tokens.shape
    dev = tokens.device
    shards, k_pools, v_pools = _shards(mesh, params, k_pool, v_pool)
    lora = _lora(lora_params, adapter_ids)
    devs = _devices(mesh, dev)
    tokens = tokens.long()
    start = int(start)
    lengths = _lengths(lengths, B, dev)
    if chunk_page_ids.ndim == 1:  # legacy batch-1 call shape
        chunk_page_ids = chunk_page_ids[None, :].expand(B, -1)
    if hist_page_ids.ndim == 1:
        hist_page_ids = hist_page_ids[None, :].expand(B, -1)
    chunk_ids = _rep(chunk_page_ids.long(), devs)
    hist_ids = _rep(hist_page_ids.long(), devs)
    H = hist_page_ids.shape[1]
    T = H * page_size
    n_chunk = C // page_size
    pos = start + torch.arange(C, device=dev)[None, :].expand(B, C)
    positions = _rep(pos, devs)
    t_range = torch.arange(T, device=dev)
    # causal across chunks + clipped to each row's real prompt
    masks = _rep((t_range[None, None, :] <= pos[:, :, None])
                 & (t_range[None, None, :] < lengths[:, None, None]), devs)
    xs = _rep(_embed(shards[0], c, tokens), devs)
    for l in range(c.n_layers):
        caches: list = [None] * len(shards)

        def write_kv(s, k, v, l=l, caches=caches):
            for pool, new in ((k_pools[s], k), (v_pools[s], v)):
                pool_set(pool, (l, chunk_ids[s]),
                         new.reshape(B, n_chunk, page_size, -1, c.head_dim)
                         .permute(0, 1, 3, 2, 4))  # [B, n, Hkv/N, ps, hd]
            # gather [B, H, Hkv/N, ps, hd] -> [B, T, Hkv/N, hd]
            caches[s] = (_gather_cache(k_pools[s], l, hist_ids[s], T, c.head_dim),
                         _gather_cache(v_pools[s], l, hist_ids[s], T, c.head_dim))

        xs = _layer(shards, l, c, xs, positions, write_kv,
                    lambda qs, caches=caches: _dense_attend(qs, caches, masks), lora, mesh)
    last = (lengths - 1 - start).clamp(0, C - 1)
    logits = _logits(shards, c, xs[0][torch.arange(B, device=dev), last])
    return logits, k_pool, v_pool


def sample_tokens(logits, generator: Optional[torch.Generator] = None,
                  temperature: float = 0.0):
    """[B, V] logits -> [B] int32 tokens on the logits' device.

    Greedy at temperature 0: ties break DETERMINISTICALLY to the lowest
    token id (max, then a min-reduce over the matching indices — not
    ``argmax``, whose tie order is the backend's); a row with no finite max
    (all NaN) matches nothing and clamps to V-1, garbage the NaN guard
    discards.  Else categorical at ``logits / temperature`` drawn from
    ``generator`` (not the JAX package's bits: compare distributions)."""
    if temperature <= 0.0:
        V = logits.shape[-1]
        top = logits.amax(-1, keepdim=True)
        ids = torch.arange(V, device=logits.device).expand_as(logits)
        low = torch.where(logits == top, ids, V).amin(-1)
        return low.clamp(max=V - 1).to(torch.int32)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)


# --------------------------------------------------------------------- decode


def _pool_step(shards, config, tokens, pos, mask, seq_lens, page_table, k_pools,
               v_pools, paged, lora, mesh):
    """The layers of a decode (``pos`` [B, 1]) or verify (``pos`` [B, K])
    step over the page pools: each row's new KV is written into its page
    slot first, then attention runs over the pool, through the paged
    kernel or the gather path under ``mask`` [B, K, T].  Returns the
    residual stream after the last layer, on the first shard's device,
    [B, K, D]."""
    c = config
    dev = tokens.device
    devs = _devices(mesh, dev)
    page_size = pool_page_size(k_pools[0])
    max_pages = page_table.shape[1]
    T = max_pages * page_size
    page_of = pos // page_size
    # a row stepped past its page table (a decode row, or a draft near the
    # slot's capacity) routes its KV write to the trash page 0 explicitly:
    # indexing past the table would raise here, and an index clipped to
    # the last page would alias the row's last owned page and corrupt
    # committed KV
    page_ids = torch.where(
        page_of < max_pages,
        page_table.long().gather(1, page_of.clamp(max=max_pages - 1)), 0)
    slots = _rep(torch.stack([page_ids, pos % page_size]), devs)
    tables = _rep(page_table.long(), devs)
    positions = _rep(pos, devs)
    masks = _rep(mask, devs)
    xs = _rep(_embed(shards[0], c, tokens.long()), devs)  # [B, K, D]
    for l in range(c.n_layers):
        caches: list = [None] * len(shards)

        def write_kv(s, k, v, l=l, caches=caches):
            # [B, K] page ids and offsets around the head slice: the
            # broadcast [B, K] axes lead, matching k's [B, K, Hkv/N, hd]
            idx = (l, slots[s][0], slice(None), slots[s][1])
            pool_set(k_pools[s], idx, k)
            pool_set(v_pools[s], idx, v)
            if not paged:
                # gather each slot's pages -> [B, T, Hkv/N, hd]
                caches[s] = (_gather_cache(k_pools[s], l, tables[s], T, c.head_dim),
                             _gather_cache(v_pools[s], l, tables[s], T, c.head_dim))

        if paged:
            def attend(qs, l=l):
                return _paged_attend(qs, k_pools, v_pools, l, page_table, seq_lens,
                                     page_size, mesh)
        else:
            def attend(qs, caches=caches):
                return _dense_attend(qs, caches, masks)
        xs = _layer(shards, l, c, xs, positions, write_kv, attend, lora, mesh)
    return xs[0]


def _decode_core(params, config: DecoderConfig, tokens, seq_lens, page_table,
                 k_pool, v_pool, paged: bool = False,
                 lora_params=None, adapter_ids=None, mesh=None):
    """Body of the single-token decode step (``decode_step``)."""
    shards, k_pools, v_pools = _shards(mesh, params, k_pool, v_pool)
    seq_lens = seq_lens.to(torch.int32)
    page_table = page_table.to(torch.int32)
    pos = (seq_lens.long() - 1).clamp(min=0)[:, None]  # current token's position
    T = page_table.shape[1] * pool_page_size(k_pools[0])
    t_range = torch.arange(T, device=tokens.device)
    mask = (t_range[None, :] < seq_lens[:, None])[:, None, :]  # [B, 1, T]
    x = _pool_step(shards, config, tokens[:, None], pos, mask, seq_lens, page_table,
                   k_pools, v_pools, paged, _lora(lora_params, adapter_ids), mesh)
    return _logits(shards, config, x[:, 0]), k_pool, v_pool


def decode_step(params, config: DecoderConfig, tokens, seq_lens, page_table,
                k_pool, v_pool, paged: bool = False,
                lora_params=None, adapter_ids=None, mesh=None):
    """One decode step for ALL slots.

    tokens: [B] int current token per slot; seq_lens: [B] int length
    INCLUDING the current token; page_table: [B, max_pages] int; k_pool /
    v_pool: [L, P, Hkv, page_size, hd] (updated in place).  Returns
    (logits [B, vocab] f32, k_pool, v_pool).

    The current token's KV is written into its page slot BEFORE attention,
    so attention covers positions [0, seq_len).  Inactive slots (seq_len==0)
    are clamped to position 0 and produce garbage logits that the caller
    ignores.

    ``paged=True`` runs attention through ``paged_attention`` directly over
    the pool (the Hopper kernel on CUDA tensors) instead of gathering each
    slot's pages into a contiguous cache first; it reads int8 pools
    natively.  ``lora_params`` / ``adapter_ids`` ([B]): the LoRA table and
    each slot's adapter (lora.py).  ``mesh``: run tensor-parallel over the
    shards of ``params`` and the pools (the tensor-parallel section above);
    ``paged=True`` then launches the kernel once per shard and layer."""
    return _decode_core(params, config, tokens, seq_lens, page_table,
                        k_pool, v_pool, paged=paged,
                        lora_params=lora_params, adapter_ids=adapter_ids, mesh=mesh)


def decode_step_sample(params, config: DecoderConfig, tokens, seq_lens,
                       page_table, k_pool, v_pool, generator=None, poison=None,
                       temperature: float = 0.0, guard: bool = True,
                       paged: bool = False, lora_params=None, adapter_ids=None,
                       token_mask=None, mesh=None):
    """Decode step with sampling and the NaN guard in one call: the
    pipelined engine loop's tick body.

    Same decode as ``decode_step`` (shared ``_decode_core``), then
    ``poison`` ([B] bool or None) overwrites selected rows' logits with
    NaN, and the token is sampled by ``sample_tokens``.  Returns (guarded
    [B] int32, k_pool, v_pool): ``guarded[b]`` is the sampled token when
    row b's logits are all finite and ``-token - 1`` (always negative) when
    the guard tripped, so the caller reads ``ok = guarded >= 0`` from the
    one small output it copies back.  ``guard=False`` returns the raw
    sample.

    ``tokens`` may hold a negative id (the previous tick's guard-tripped
    row, fed back on the device): it is clamped to 0 before the embedding
    gather, where an out-of-range index would be a device-side assert on
    the card.  That row stays garbage in, garbage out; the engine fails it
    at the next commit.

    ``token_mask`` ([B, V] bool or None) constrains sampling to
    grammar-legal tokens: illegal logits become the finite ``-1e30`` (never
    -inf, which would turn a fully masked row into a spurious guard trip).
    The guard reads the RAW (poisoned, unmasked) logits, so masking never
    hides a non-finite row; and where the raw argmax is legal the masked
    argmax is the same token (the mask only removes, never reorders)."""
    logits, k_pool, v_pool = _decode_core(
        params, config, tokens.clamp(min=0), seq_lens, page_table,
        k_pool, v_pool, paged=paged, lora_params=lora_params,
        adapter_ids=adapter_ids, mesh=mesh)
    if poison is not None:
        logits = torch.where(poison[:, None], float("nan"), logits)
    raw = logits
    if token_mask is not None:
        logits = torch.where(token_mask, logits, -1e30)
    sampled = sample_tokens(logits, generator, temperature)
    if guard:
        ok = torch.isfinite(raw).all(dim=-1)
        sampled = torch.where(ok, sampled, -sampled - 1)
    return sampled, k_pool, v_pool


def _last_accepted(prev_packed):
    """The last non-sentinel entry of each packed ``[B, K]`` row (packed
    rows are leading-accepted); an all-``-1`` row yields -1."""
    n_prev = (prev_packed >= 0).sum(dim=1)
    return prev_packed.gather(1, (n_prev - 1).clamp(min=0)[:, None])[:, 0]


def decode_step_sample_packed(params, config: DecoderConfig, prev_packed,
                              seq_lens, page_table, k_pool, v_pool,
                              generator=None, poison=None,
                              temperature: float = 0.0, guard: bool = True,
                              paged: bool = False, lora_params=None,
                              adapter_ids=None, token_mask=None, mesh=None):
    """No-draft tick of the pipelined speculative loop: the single-token
    step of ``decode_step_sample`` wearing ``decode_step_verify_sample``'s
    packed ``[B, K]`` edge on both sides.  The input token is the last
    accepted entry of the previous tick's packed row (an all-``-1`` row
    gives -1, which ``decode_step_sample`` clamps); the output is
    ``[tok, -1, ...]``, so a guard-tripped (negative) sample leaves no
    leading non-negative entry, the verify path's NaN encoding."""
    B, K = prev_packed.shape
    sampled, k_pool, v_pool = decode_step_sample(
        params, config, _last_accepted(prev_packed), seq_lens, page_table,
        k_pool, v_pool, generator, poison, temperature, guard, paged,
        lora_params, adapter_ids, token_mask, mesh)
    pad = torch.full((B, K - 1), -1, dtype=torch.int32, device=sampled.device)
    return torch.cat([sampled[:, None], pad], dim=1), k_pool, v_pool


def decode_step_k(params, config: DecoderConfig, tokens, seq_lens, page_table,
                  k_pool, v_pool, paged: bool = False,
                  lora_params=None, adapter_ids=None, mesh=None):
    """Speculative verify step: 1 committed + (K-1) draft tokens per slot in
    one pass.

    tokens: [B, K] int — tokens[b, 0] is the slot's last committed token
    (position seq_lens[b]-1), tokens[b, 1:] drafts at the following
    positions; seq_lens counts committed tokens only.  Returns (logits
    [B, K, vocab] f32, k_pool, v_pool): logits[b, j] predicts the token at
    position seq_lens[b]+j.

    KV is written for every draft position; a rejected position holds
    garbage that stays masked (row j sees positions < seq_len + j) until a
    real token overwrites it.  The caller keeps draft positions inside the
    slot's owned pages.  ``paged=True`` runs attention through
    ``paged_attention`` with ``q [B, K, Hq, hd]``, whose per-row horizon is
    the same causal mask."""
    K = tokens.shape[1]
    shards, k_pools, v_pools = _shards(mesh, params, k_pool, v_pool)
    seq_lens = seq_lens.to(torch.int32)
    page_table = page_table.to(torch.int32)
    pos0 = (seq_lens.long() - 1).clamp(min=0)
    pos = pos0[:, None] + torch.arange(K, device=tokens.device)[None, :]  # [B, K]
    T = page_table.shape[1] * pool_page_size(k_pools[0])
    t_range = torch.arange(T, device=tokens.device)
    # causal over the history and this call's own K tokens (their KV is
    # written before attention reads it)
    mask = t_range[None, None, :] <= pos[:, :, None]  # [B, K, T]
    x = _pool_step(shards, config, tokens, pos, mask, seq_lens, page_table, k_pools,
                   v_pools, paged, _lora(lora_params, adapter_ids), mesh)
    return _logits(shards, config, x), k_pool, v_pool


def decode_step_verify_sample(params, config: DecoderConfig, prev_packed,
                              drafts, draft_len, seq_lens, page_table,
                              k_pool, v_pool, generator=None, poison=None,
                              temperature: float = 0.0, guard: bool = True,
                              paged: bool = False, lora_params=None,
                              adapter_ids=None, token_mask=None, mesh=None):
    """Speculative verify with longest-prefix accept, sampling and the NaN
    guard in one call: the pipelined speculative tick body.

    ``prev_packed``: [B, K] int32, the previous verify tick's output, kept
    on the device; row b's input token 0 is its last accepted entry (after
    a fence the engine seeds ``[last_committed, -1, ...]``).  ``drafts``:
    [B, K-1] int32 prompt-lookup drafts; ``draft_len``: [B] int32 valid
    drafts per row (padding never matches).  ``seq_lens``: committed length
    per slot including the current token.

    Returns (packed [B, K] int32, k_pool, v_pool): ``packed[b, :m]`` are
    the m = accepted + 1 tokens greedy decoding would have committed (the
    accepted draft prefix, then the bonus or correction token), later
    entries are ``-1``.  A row whose K verify rows are not all finite is
    all ``-1``: no healthy row can be, since every live row emits at least
    one token.

    ``token_mask`` ([B, K, V] bool or None): position j's legal set assumes
    drafts 0..j-1 were accepted (the host builds it by walking a clone of
    the slot's automaton over the drafts), so the bonus or correction token
    at the first rejected position is masked by exactly the right state.
    Finite -1e30, and the guard reads the raw logits, as in
    ``decode_step_sample``."""
    B, K = prev_packed.shape
    tok0 = _last_accepted(prev_packed).clamp(min=0)
    drafts = drafts.to(torch.int32)
    tokens = torch.cat([tok0[:, None], drafts], dim=1)
    logits, k_pool, v_pool = decode_step_k(
        params, config, tokens, seq_lens, page_table, k_pool, v_pool, paged=paged,
        lora_params=lora_params, adapter_ids=adapter_ids, mesh=mesh)
    if poison is not None:
        logits = torch.where(poison[:, None, None], float("nan"), logits)
    raw = logits
    if token_mask is not None:
        logits = torch.where(token_mask, logits, -1e30)
    V = logits.shape[-1]
    sampled = sample_tokens(logits.reshape(B * K, V), generator,
                            temperature).reshape(B, K)
    # longest-prefix accept: draft j is committable iff every earlier draft
    # matched greedy at its position (the sync walk's "break on mismatch"
    # as a cumulative product); padding past draft_len never matches
    j = torch.arange(K - 1, device=logits.device)
    match = (drafts == sampled[:, :K - 1]) & (j[None, :] < draft_len[:, None])
    n_acc = match.to(torch.int32).cumprod(dim=1).sum(dim=1)
    j_tok = torch.arange(K, device=logits.device)
    packed = torch.where(j_tok[None, :] <= n_acc[:, None], sampled, -1)
    if guard:
        ok = torch.isfinite(raw).reshape(B, -1).all(dim=1)
        packed = torch.where(ok[:, None], packed, -1)
    return packed.to(torch.int32), k_pool, v_pool


# ------------------------------------------------------------------ reference


def forward_full(params, config: DecoderConfig, tokens,
                 lora_params=None, adapter_ids=None):
    """Plain full-sequence forward (correctness oracle for the paged path):
    [B, S] tokens -> [B, S, vocab] f32 logits; ``adapter_ids`` [B] picks
    each row's LoRA adapter from ``lora_params``."""
    c = config
    B, S = tokens.shape
    dev = tokens.device
    lora = _lora(lora_params, adapter_ids)
    positions = [torch.arange(S, device=dev)[None, :].expand(B, S)]
    masks = [torch.ones((S, S), dtype=torch.bool, device=dev).tril()[None].expand(B, S, S)]
    xs = [_embed(params, c, tokens.long())]
    kv: list = [None]

    def write_kv(s, k, v):
        kv[s] = (k, v)

    for l in range(c.n_layers):
        xs = _layer([params], l, c, xs, positions, write_kv,
                    lambda qs: _dense_attend(qs, kv, masks), lora, None)
    return _logits([params], c, xs[0])
