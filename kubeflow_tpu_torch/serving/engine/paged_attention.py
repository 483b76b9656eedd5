"""Paged attention over the KV page pool: a hand-written Hopper kernel.

Counterpart of ``kubeflow_tpu/serving/engine/paged_attention.py``, whose
Pallas TPU kernel ``_kernel`` this replaces.  The decode-step attention of
the engine reads each slot's pages straight out of the pool instead of
gathering them into a contiguous ``[B, T, Hkv, hd]`` cache first (the gather
writes a full KV copy to device memory before attention reads it back).

* ``paged_attention`` keeps the JAX signature and layout.  On CUDA tensors
  it launches the CUDA C++ kernels in ``csrc/paged_attention.cu`` (built
  with nvcc for sm_90a at first use, bound with ctypes, launched on
  PyTorch's current stream) and counts the call as ONE launch in
  ``paged_attention.launches`` (and by K in ``launches_by_k``), although a
  call is two device kernels:
  a split kernel, where each block walks a chunk of ``pages_per_split`` of
  one slot's pages and writes a partial ``(m, l, acc)`` in f32 to scratch
  from ``torch.empty``, then a merge kernel that folds each slot's live
  chunks into the output.  ``_split_plan`` picks the chunk size from the
  shapes alone, so no call reads ``seq_lens`` back to the host.  The pools
  and scales must be 16-byte aligned (the kernel fills its shared-memory
  ring with 16-byte ``cp.async`` copies); the wrapper raises otherwise.  On
  CPU tensors it runs ``paged_attention_plain``.  There is no fallback: a
  CUDA call that cannot build or launch the kernels raises.
* ``paged_attention_plain`` is the plain PyTorch version of the same
  function (gather the pages, dense masked softmax with the same finite
  ``NEG_INF``), the reference the kernel is held against on the card.

Semantics shared by both (and by the TPU kernel): q ``[B, K, Hq, hd]``; query
row r of K sees positions ``< seq_len + r``; pages at or past every row's
horizon ``seq_len + K - 1`` are skipped; an idle K=1 slot (``seq_len == 0``)
visits no page and returns zeros; a K>1 row that sees no position of the
pages its slot visits averages V uniformly over those positions.  int8 pools
(``{"q": int8, "s": bf16 [P, Hkv, ps, 1]}``) are dequantized per
(page, head, token).
"""

from __future__ import annotations

import ctypes
import os

import torch

from ...utils.native_build import load_cuda

NEG_INF = -1e9

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                    "paged_attention.cu")
# the card's shared memory a block may use (H100: 227 KB)
_MAX_SMEM = 232448
_Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KV_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
# the card's streaming multiprocessors (H100 SXM: 132), and the waves of
# split blocks _split_plan aims for
_SMS = 132
_TARGET_WAVES = 4


def load_kernel() -> ctypes.CDLL:
    """Build (first use, keyed on the source hash) and bind the kernels."""
    lib = load_cuda(_SRC, "paged_attention")
    p, i32 = ctypes.c_void_p, ctypes.c_int
    lib.paged_attention_launch.restype = i32
    lib.paged_attention_launch.argtypes = (
        [p, i32, p, p, i32, p, p, p, p, p, p, p, p] + [i32] * 8 + [ctypes.c_float, p])
    lib.paged_attention_smem_bytes.restype = ctypes.c_size_t
    lib.paged_attention_smem_bytes.argtypes = [i32] * 6
    lib.paged_attention_error_string.restype = ctypes.c_char_p
    lib.paged_attention_error_string.argtypes = [i32]
    return lib


def _row_tiles(rows: int) -> int:
    """Blocks per (chunk, kv head, slot) for ``rows`` query rows, as the
    tensor-core kernel's launch (``launch_tc_rows``) tiles them: 16 rows in
    one m16 tile, else 32 in two."""
    return 1 if rows <= 16 else -(-rows // 32)


def _split_plan(max_pages: int, batch: int, kv_heads: int, rows: int) -> int:
    """Pages per split block, from the shapes only (never ``seq_lens``,
    which lives on the card: reading it would sync the host per layer).

    The largest power of two that still launches ``_TARGET_WAVES`` waves of
    blocks over the card's SMs, counting every (chunk, kv head, row tile,
    slot); 1 when even one page per block launches fewer.  Long chunks keep
    each block's load ring full and the partials few; enough blocks keep
    the longest slot's walk spread over the SMs."""
    blocks = batch * kv_heads * _row_tiles(rows)
    pps = 1
    while (pps * 2 <= max_pages
           and -(-max_pages // (pps * 2)) * blocks >= _TARGET_WAVES * _SMS):
        pps *= 2
    return pps


def _pool_parts(pool):
    """(values, scales or None) of one layer's pool."""
    if isinstance(pool, dict):
        return pool["q"], pool["s"]
    return pool, None


def paged_attention_plain(q, k_pool, v_pool, page_table, seq_lens,
                          page_size: int):
    """Plain PyTorch version of ``paged_attention`` (any device).

    Gathers every page of each slot's table row, masks positions a row
    cannot see with ``NEG_INF`` and pages past the slot's furthest horizon
    out entirely, then normalises exactly as the kernel's online softmax
    does (max floored at ``NEG_INF``, sum floored at 1e-30), all in f32.
    Returns ``[B, K, Hq, hd]`` in q's dtype."""
    B, K, Hq, hd = q.shape
    kq, _ = _pool_parts(k_pool)
    Hkv = kq.shape[1]
    group = Hq // Hkv
    rows = K * group
    MP = page_table.shape[1]
    T = MP * page_size
    dev = q.device
    pt = page_table.long()

    def gather(pool):
        vals, scales = _pool_parts(pool)
        x = vals[pt].float()                        # [B, MP, Hkv, ps, hd]
        if scales is not None:
            x = x * scales[pt].float()
        return x.permute(0, 2, 1, 3, 4).reshape(B, Hkv, T, hd)

    k = gather(k_pool)
    v = gather(v_pool)
    qg = ((q.float() * hd ** -0.5)
          .reshape(B, K, Hkv, group, hd).permute(0, 2, 1, 3, 4)
          .reshape(B, Hkv, rows, hd))
    logits = qg @ k.transpose(-1, -2)               # [B, Hkv, rows, T]
    pos = torch.arange(T, device=dev)
    sl = seq_lens.to(dev).long()
    qi = torch.arange(rows, device=dev) // group
    visible = pos[None, None, :] < (sl[:, None, None] + qi[None, :, None])
    visited = (pos // page_size * page_size)[None, :] < (sl + K - 1)[:, None]
    logits = torch.where(visible[:, None], logits, NEG_INF)
    m = (torch.where(visited[:, None, None], logits, float("-inf"))
         .amax(-1, keepdim=True).clamp(min=NEG_INF))
    p = torch.exp(logits - m) * visited[:, None, None]
    out = (p @ v) / p.sum(-1, keepdim=True).clamp(min=1e-30)
    return (out.reshape(B, Hkv, K, group, hd).permute(0, 2, 1, 3, 4)
            .reshape(B, K, Hq, hd).to(q.dtype))


def paged_attention(q, k_pool, v_pool, page_table, seq_lens, page_size: int,
                    *, _pages_per_split: int | None = None):
    """Attention for K query tokens per slot directly over the page pool.

    q: [B, K, Hq, hd] bf16 or f32 — query 0 is the slot's current committed
    token and rows 1..K-1 are draft tokens at the following positions.
    seq_lens: [B] int32 counting committed tokens INCLUDING query 0's
    position.  k_pool/v_pool: ONE layer's pool — [P, Hkv, page_size, hd]
    (bf16 or f32) or the int8 ``{"q", "s"}`` dict.  page_table:
    [B, max_pages] int32.  Returns [B, K, Hq, hd] in q's dtype.

    CPU tensors run the plain version; CUDA tensors launch the Hopper
    split and merge kernels (counted as one launch in
    ``paged_attention.launches``) or raise.  ``_pages_per_split`` overrides
    ``_split_plan`` (tests only)."""
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pool, v_pool, page_table, seq_lens,
                                     page_size)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    kq, ks = _pool_parts(k_pool)
    vq, vs = _pool_parts(v_pool)
    B, K, Hq, hd = q.shape
    P, Hkv, ps, hd_kv = kq.shape
    MP = page_table.shape[1]
    if q.dtype not in _Q_DTYPES or kq.dtype not in _KV_DTYPES:
        raise TypeError(f"paged_attention: q {q.dtype} / pool {kq.dtype} not "
                        "supported (q f32|bf16; pool f32|bf16|int8)")
    if (ks is None) != (kq.dtype != torch.int8) or vq.dtype != kq.dtype:
        raise TypeError("paged_attention: int8 pools need bf16 scales, and "
                        "K and V pools must share a dtype")
    if (ps != page_size or hd_kv != hd or Hq % Hkv or vq.shape != kq.shape
            or page_table.shape[0] != B or seq_lens.shape != (B,)):
        raise ValueError(
            f"paged_attention: shapes disagree (q {tuple(q.shape)}, pool "
            f"{tuple(kq.shape)}, page_size {page_size}, table "
            f"{tuple(page_table.shape)}, seq_lens {tuple(seq_lens.shape)})")
    tensors = [q, kq, vq, page_table, seq_lens] + ([ks, vs] if ks is not None else [])
    if any(t.device != q.device for t in tensors):
        raise ValueError("paged_attention: all tensors must be on one device")
    if page_table.dtype != torch.int32 or seq_lens.dtype != torch.int32:
        raise TypeError("paged_attention: page_table and seq_lens must be int32")
    if not all(t.is_contiguous() for t in tensors[1:]):
        raise ValueError("paged_attention: pools, page_table and seq_lens "
                         "must be contiguous")
    if ks is not None and (ks.dtype != torch.bfloat16 or vs.dtype != torch.bfloat16
                           or ks.shape != (P, Hkv, ps, 1) or vs.shape != ks.shape):
        raise ValueError("paged_attention: int8 scales must be bf16 [P, Hkv, ps, 1]")
    q = q.contiguous()
    out = torch.empty_like(q)
    if B == 0 or MP == 0:
        return out.zero_()
    # the tensor-core kernel copies every (page, head) tile and scale row
    # in 16-byte cp.async chunks: their bases must be 16-byte aligned (the
    # tile strides are multiples of 16 at the shapes it takes)
    bad = [name for name, t in (("k_pool", kq), ("v_pool", vq), ("k_scale", ks),
                                ("v_scale", vs))
           if t is not None and t.data_ptr() % 16]
    if bad:
        raise ValueError(f"paged_attention: {', '.join(bad)} not 16-byte "
                         "aligned (the kernel loads pages with 16-byte cp.async)")
    lib = load_kernel()
    q_code, kv_code = _Q_DTYPES[q.dtype], _KV_DTYPES[kq.dtype]
    rows = K * (Hq // Hkv)
    pps = _pages_per_split or _split_plan(MP, B, Hkv, rows)
    splits = -(-MP // pps)
    smem = lib.paged_attention_smem_bytes(q_code, kv_code, rows, hd, ps, pps)
    if smem > _MAX_SMEM:
        raise ValueError(f"paged_attention: {smem} B of shared memory per "
                         f"block exceeds the card's {_MAX_SMEM} B")
    # partials (m, l, acc) of every (slot, kv head, chunk, row), f32
    n = B * Hkv * splits * rows
    part = torch.empty(n * (hd + 2), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.paged_attention_launch(
            q.data_ptr(), q_code, kq.data_ptr(), vq.data_ptr(), kv_code,
            ks.data_ptr() if ks is not None else None,
            vs.data_ptr() if vs is not None else None,
            page_table.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
            part.data_ptr(), part[n:].data_ptr(), part[2 * n:].data_ptr(),
            B, K, Hq, Hkv, hd, ps, MP, pps, float(hd ** -0.5), stream)
    if err != 0:
        raise RuntimeError("paged_attention kernel launch failed: "
                           f"{lib.paged_attention_error_string(err).decode()}")
    paged_attention.launches += 1
    paged_attention.launches_by_k[K] = paged_attention.launches_by_k.get(K, 0) + 1
    return out


paged_attention.launches = 0
# the same launches by query rows per slot: K = 1 decode, K > 1 verify
paged_attention.launches_by_k = {}
