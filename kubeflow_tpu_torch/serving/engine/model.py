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
    kernel at K > 1 with ``paged=True``.

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
from .paged_attention import paged_attention


def is_hf_config(raw: dict) -> bool:
    """True if a config.json dict is a transformers config (not ours).
    HF configs always carry model_type/architectures; ours never do.
    (A copy of ``kubeflow_tpu/serving/engine/hf_convert.is_hf_config``.)"""
    return "model_type" in raw or "architectures" in raw


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
                "first (kubeflow_tpu.serving.engine.hf_convert writes "
                "config.json + params.npz in the engine's format)")
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
    ``"cuda"``), dtypes unchanged.  Dense weights only in this slice."""
    dev = resolve_device(device)
    out = {}
    for name, arr in np_params.items():
        if isinstance(arr, dict):
            raise ValueError(f"param {name!r} is quantized; int8 weights are "
                             "not supported by this port yet")
        out[name] = _tensor_from_numpy(arr).to(dev)
    return out


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


# --------------------------------------------------------------------- blocks


def _embed(params, config, tokens):
    """Input embedding incl. Gemma's sqrt(d_model) input-side scaling."""
    x = params["embed"][tokens]
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


def _proj(params, l, name, h):
    """h @ W[name][l] (LoRA adapters are not ported yet)."""
    return h @ params[name][l]


def _block_with(params, l, config, x, positions, attend):
    """One transformer block with a pluggable attention: ``attend(q)`` maps
    roped queries [B, S, Hq, hd] to attention outputs of the same shape (the
    hook where the gather path and the paged kernel diverge)."""
    c = config
    h = _rms_norm(x, params["ln_attn"][l], c.norm_eps)
    B, S = x.shape[:2]
    q = _proj(params, l, "wq", h).reshape(B, S, c.n_heads, c.head_dim)
    q = _rope(q, positions, c.rope_theta)
    attn = attend(q)
    x = x + _proj(params, l, "wo", attn.reshape(B, S, -1))
    h = _rms_norm(x, params["ln_mlp"][l], c.norm_eps)
    if c.act == "silu":
        act = F.silu
    elif c.act == "gelu_tanh":
        def act(t):
            return F.gelu(t, approximate="tanh")
    else:  # a typo'd config must not silently serve wrong math
        raise ValueError(f"unknown act {c.act!r} (silu | gelu_tanh)")
    return x + _proj(params, l, "w2",
                     act(_proj(params, l, "w1", h)) * _proj(params, l, "w3", h))


def _block(params, l, config, x, k_cache, v_cache, positions, mask):
    """One transformer block over a contiguous cache: k_cache/v_cache
    [B, T, Hkv, hd] already hold this step's k/v at the right positions."""
    return _block_with(params, l, config, x, positions,
                       lambda q: _attn(q, k_cache, v_cache, mask))


def _kv_proj(params, l, config, h, positions):
    c = config
    B, S = h.shape[:2]
    k = _proj(params, l, "wk", h).reshape(B, S, c.n_kv_heads, c.head_dim)
    v = _proj(params, l, "wv", h).reshape(B, S, c.n_kv_heads, c.head_dim)
    k = _rope(k, positions, c.rope_theta)
    return k, v


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


def prefill(params, config: DecoderConfig, tokens, lengths, page_size: int):
    """Process a batch of same-bucket prompts in one call.

    tokens: [B, S] int (each row padded to the shared bucket S); lengths:
    [B] int per-row prompt lengths (a scalar broadcasts).  Returns
    (logits_last [B, vocab] f32, paged_k, paged_v) where paged_k/v are
    [layers, B, S/page_size, Hkv, page_size, hd] — ready to scatter into the
    page pool at each row's page ids via ``write_pages``."""
    c = config
    B, S = tokens.shape
    dev = tokens.device
    tokens = tokens.long()
    lengths = _lengths(lengths, B, dev)
    pos_row = torch.arange(S, device=dev)
    positions = pos_row[None, :].expand(B, S)
    x = _embed(params, c, tokens)
    causal = torch.ones((S, S), dtype=torch.bool, device=dev).tril()[None]
    valid = pos_row[None, None, :] < lengths[:, None, None]
    mask = causal & valid  # [B, S, S]
    ks, vs = [], []
    for l in range(c.n_layers):
        h = _rms_norm(x, params["ln_attn"][l], c.norm_eps)
        k, v = _kv_proj(params, l, c, h, positions)
        ks.append(k)
        vs.append(v)
        x = _block(params, l, c, x, k, v, positions, mask)
    x = _rms_norm(x, params["ln_out"], c.norm_eps)
    # logits at each row's last REAL token (lengths-1)
    last = x[torch.arange(B, device=dev), lengths - 1]
    logits = (last @ params["unembed"]).float()
    n_pages = S // page_size
    paged_k = (torch.stack(ks)
               .reshape(c.n_layers, B, n_pages, page_size, c.n_kv_heads, c.head_dim)
               .permute(0, 1, 2, 4, 3, 5))  # -> [L, B, n_pages, Hkv, ps, hd]
    paged_v = (torch.stack(vs)
               .reshape(c.n_layers, B, n_pages, page_size, c.n_kv_heads, c.head_dim)
               .permute(0, 1, 2, 4, 3, 5))
    return logits, paged_k, paged_v


def write_pages(k_pool, v_pool, paged_k, paged_v, page_ids):
    """Scatter prefilled KV into the pools at page_ids, in place.

    Batched form: paged_k/v [layers, B, n, Hkv, page_size, hd] with
    page_ids [B, n] (rows route unowned tail pages to the reserved trash
    page 0).  The single-prompt form (paged [layers, n, ...], page_ids [n])
    also works.  Returns the (same) pools."""
    if page_ids.ndim == 2:
        L = paged_k.shape[0]
        paged_k = paged_k.reshape((L, -1) + tuple(paged_k.shape[3:]))
        paged_v = paged_v.reshape((L, -1) + tuple(paged_v.shape[3:]))
        page_ids = page_ids.reshape(-1)
    idx = (slice(None), page_ids.long())
    return pool_set(k_pool, idx, paged_k), pool_set(v_pool, idx, paged_v)


def prefill_chunk(params, config: DecoderConfig, tokens, start, lengths,
                  chunk_page_ids, hist_page_ids, k_pool, v_pool, page_size: int):
    """Advance a BATCH of long prompts one page-aligned chunk each, in one
    call against the page pool (chunked prefill: a long prompt never
    head-of-line-blocks the decode steps of other slots).

    tokens: [B, C] int chunks (padded past each prompt end); start: shared
    offset of this chunk in the prompts; lengths: [B] per-row total prompt
    lengths (scalar broadcasts); chunk_page_ids: [B, C/page_size] pool pages
    to scatter each row's chunk KV into (unowned tail slots point at the
    trash page 0); hist_page_ids: [B, H] pool pages covering positions
    [0, start+C) per row.  Pools are written in place.

    Returns (logits [B, vocab] at each row's position length-1 — garbage
    unless that row's final chunk — , k_pool, v_pool)."""
    c = config
    B, C = tokens.shape
    dev = tokens.device
    tokens = tokens.long()
    start = int(start)
    lengths = _lengths(lengths, B, dev)
    if chunk_page_ids.ndim == 1:  # legacy batch-1 call shape
        chunk_page_ids = chunk_page_ids[None, :].expand(B, -1)
    if hist_page_ids.ndim == 1:
        hist_page_ids = hist_page_ids[None, :].expand(B, -1)
    chunk_page_ids = chunk_page_ids.long()
    hist_page_ids = hist_page_ids.long()
    H = hist_page_ids.shape[1]
    T = H * page_size
    n_chunk = C // page_size
    positions = start + torch.arange(C, device=dev)[None, :].expand(B, C)
    x = _embed(params, c, tokens)
    t_range = torch.arange(T, device=dev)
    # causal across chunks + clipped to each row's real prompt
    mask = ((t_range[None, None, :] <= positions[:, :, None])
            & (t_range[None, None, :] < lengths[:, None, None]))
    for l in range(c.n_layers):
        h = _rms_norm(x, params["ln_attn"][l], c.norm_eps)
        k, v = _kv_proj(params, l, c, h, positions)
        pool_set(k_pool, (l, chunk_page_ids),
                 k.reshape(B, n_chunk, page_size, c.n_kv_heads, c.head_dim)
                  .permute(0, 1, 3, 2, 4))  # [B, n, Hkv, ps, hd]
        pool_set(v_pool, (l, chunk_page_ids),
                 v.reshape(B, n_chunk, page_size, c.n_kv_heads, c.head_dim)
                  .permute(0, 1, 3, 2, 4))
        # gather [B, H, Hkv, ps, hd] -> [B, T, Hkv, hd] (token-major cache)
        k_cache = (pool_get(k_pool, (l, hist_page_ids))
                   .permute(0, 1, 3, 2, 4).reshape(B, T, c.n_kv_heads, c.head_dim))
        v_cache = (pool_get(v_pool, (l, hist_page_ids))
                   .permute(0, 1, 3, 2, 4).reshape(B, T, c.n_kv_heads, c.head_dim))
        x = _block(params, l, c, x, k_cache, v_cache, positions, mask)
    x = _rms_norm(x, params["ln_out"], c.norm_eps)
    last = (lengths - 1 - start).clamp(0, C - 1)
    logits = (x[torch.arange(B, device=dev), last] @ params["unembed"]).float()
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


def _decode_core(params, config: DecoderConfig, tokens, seq_lens, page_table,
                 k_pool, v_pool, paged: bool = False):
    """Body of the single-token decode step (``decode_step``)."""
    c = config
    B = tokens.shape[0]
    dev = tokens.device
    page_size = pool_page_size(k_pool)
    max_pages = page_table.shape[1]
    T = max_pages * page_size
    seq_lens = seq_lens.to(torch.int32)
    page_table = page_table.to(torch.int32)
    pos = (seq_lens.long() - 1).clamp(min=0)  # current token's position
    positions = pos[:, None]

    x = _embed(params, c, tokens.long())[:, None, :]  # [B, 1, D]
    t_range = torch.arange(T, device=dev)
    mask = (t_range[None, :] < seq_lens[:, None])[:, None, :]  # [B, 1, T]

    page_of = pos // page_size
    # a row stepped past its page table routes its KV write to the trash
    # page 0 explicitly: indexing past the table would raise here (and an
    # index clipped to the last page would alias the row's last owned page
    # and corrupt committed KV)
    page_id = torch.where(
        page_of < max_pages,
        page_table.long().gather(1, page_of.clamp(max=max_pages - 1)[:, None])[:, 0],
        0)
    offset = pos % page_size

    for l in range(c.n_layers):
        h = _rms_norm(x, params["ln_attn"][l], c.norm_eps)
        k_new, v_new = _kv_proj(params, l, c, h, positions)
        # scatter this step's kv into the pool: one (page, head, offset) per
        # slot — the slice between the advanced indices puts the broadcast
        # [B] axis first, matching k_new[:, 0]'s [B, Hkv, hd]
        pool_set(k_pool, (l, page_id, slice(None), offset), k_new[:, 0])
        pool_set(v_pool, (l, page_id, slice(None), offset), v_new[:, 0])
        if paged:
            kl, vl = pool_layer(k_pool, l), pool_layer(v_pool, l)
            x = _block_with(
                params, l, c, x, positions,
                lambda q: paged_attention(q, kl, vl, page_table, seq_lens, page_size))
        else:
            # gather each slot's pages [B, MP, Hkv, ps, hd] -> [B, T, Hkv, hd]
            k_cache = (pool_get(k_pool, (l, page_table.long()))
                       .permute(0, 1, 3, 2, 4).reshape(B, T, c.n_kv_heads, c.head_dim))
            v_cache = (pool_get(v_pool, (l, page_table.long()))
                       .permute(0, 1, 3, 2, 4).reshape(B, T, c.n_kv_heads, c.head_dim))
            x = _block(params, l, c, x, k_cache, v_cache, positions, mask)
    x = _rms_norm(x, params["ln_out"], c.norm_eps)
    logits = (x[:, 0] @ params["unembed"]).float()
    return logits, k_pool, v_pool


def decode_step(params, config: DecoderConfig, tokens, seq_lens, page_table,
                k_pool, v_pool, paged: bool = False):
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
    natively."""
    return _decode_core(params, config, tokens, seq_lens, page_table,
                        k_pool, v_pool, paged=paged)


def decode_step_sample(params, config: DecoderConfig, tokens, seq_lens,
                       page_table, k_pool, v_pool, generator=None, poison=None,
                       temperature: float = 0.0, guard: bool = True,
                       paged: bool = False):
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
    at the next commit."""
    logits, k_pool, v_pool = _decode_core(
        params, config, tokens.clamp(min=0), seq_lens, page_table,
        k_pool, v_pool, paged=paged)
    if poison is not None:
        logits = torch.where(poison[:, None], float("nan"), logits)
    sampled = sample_tokens(logits, generator, temperature)
    if guard:
        ok = torch.isfinite(logits).all(dim=-1)
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
                              paged: bool = False):
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
        k_pool, v_pool, generator, poison, temperature, guard, paged)
    pad = torch.full((B, K - 1), -1, dtype=torch.int32, device=sampled.device)
    return torch.cat([sampled[:, None], pad], dim=1), k_pool, v_pool


def decode_step_k(params, config: DecoderConfig, tokens, seq_lens, page_table,
                  k_pool, v_pool, paged: bool = False):
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
    c = config
    B, K = tokens.shape
    dev = tokens.device
    page_size = pool_page_size(k_pool)
    max_pages = page_table.shape[1]
    T = max_pages * page_size
    seq_lens = seq_lens.to(torch.int32)
    page_table = page_table.to(torch.int32)
    pos0 = (seq_lens.long() - 1).clamp(min=0)
    positions = pos0[:, None] + torch.arange(K, device=dev)[None, :]  # [B, K]

    x = _embed(params, c, tokens.long())  # [B, K, D]
    t_range = torch.arange(T, device=dev)
    # causal over the history and this call's own K tokens (their KV is
    # written below before attention reads it)
    mask = t_range[None, None, :] <= positions[:, :, None]  # [B, K, T]

    page_of = positions // page_size  # [B, K]
    # draft rows near the slot's capacity can step past the table: route
    # them to the trash page 0 (a clipped index would alias the slot's last
    # owned page and corrupt committed KV)
    page_ids = torch.where(
        page_of < max_pages,
        page_table.long().gather(1, page_of.clamp(max=max_pages - 1)), 0)
    offsets = positions % page_size

    for l in range(c.n_layers):
        h = _rms_norm(x, params["ln_attn"][l], c.norm_eps)
        k_new, v_new = _kv_proj(params, l, c, h, positions)  # [B, K, Hkv, hd]
        # [B, K] page ids and offsets around the head slice: the broadcast
        # [B, K] axes lead, matching k_new's [B, K, Hkv, hd]
        pool_set(k_pool, (l, page_ids, slice(None), offsets), k_new)
        pool_set(v_pool, (l, page_ids, slice(None), offsets), v_new)
        if paged:
            kl, vl = pool_layer(k_pool, l), pool_layer(v_pool, l)
            x = _block_with(
                params, l, c, x, positions,
                lambda q: paged_attention(q, kl, vl, page_table, seq_lens, page_size))
        else:
            k_cache = (pool_get(k_pool, (l, page_table.long()))
                       .permute(0, 1, 3, 2, 4).reshape(B, T, c.n_kv_heads, c.head_dim))
            v_cache = (pool_get(v_pool, (l, page_table.long()))
                       .permute(0, 1, 3, 2, 4).reshape(B, T, c.n_kv_heads, c.head_dim))
            x = _block(params, l, c, x, k_cache, v_cache, positions, mask)
    x = _rms_norm(x, params["ln_out"], c.norm_eps)
    logits = (x @ params["unembed"]).float()
    return logits, k_pool, v_pool


def decode_step_verify_sample(params, config: DecoderConfig, prev_packed,
                              drafts, draft_len, seq_lens, page_table,
                              k_pool, v_pool, generator=None, poison=None,
                              temperature: float = 0.0, guard: bool = True,
                              paged: bool = False):
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
    one token."""
    B, K = prev_packed.shape
    tok0 = _last_accepted(prev_packed).clamp(min=0)
    drafts = drafts.to(torch.int32)
    tokens = torch.cat([tok0[:, None], drafts], dim=1)
    logits, k_pool, v_pool = decode_step_k(
        params, config, tokens, seq_lens, page_table, k_pool, v_pool, paged=paged)
    if poison is not None:
        logits = torch.where(poison[:, None, None], float("nan"), logits)
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
        ok = torch.isfinite(logits).reshape(B, -1).all(dim=1)
        packed = torch.where(ok[:, None], packed, -1)
    return packed.to(torch.int32), k_pool, v_pool


# ------------------------------------------------------------------ reference


def forward_full(params, config: DecoderConfig, tokens):
    """Plain full-sequence forward (correctness oracle for the paged path):
    [B, S] tokens -> [B, S, vocab] f32 logits."""
    c = config
    B, S = tokens.shape
    dev = tokens.device
    tokens = tokens.long()
    positions = torch.arange(S, device=dev)[None, :].expand(B, S)
    x = _embed(params, c, tokens)
    mask = torch.ones((S, S), dtype=torch.bool, device=dev).tril()[None].expand(B, S, S)
    for l in range(c.n_layers):
        h = _rms_norm(x, params["ln_attn"][l], c.norm_eps)
        k, v = _kv_proj(params, l, c, h, positions)
        x = _block(params, l, c, x, k, v, positions, mask)
    x = _rms_norm(x, params["ln_out"], c.norm_eps)
    return (x @ params["unembed"]).float()
