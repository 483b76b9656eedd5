"""Flash attention: a hand-written Hopper forward kernel + blockwise backward.

Counterpart of ``kubeflow_tpu/ops/flash_attention.py``, whose Pallas TPU
kernel ``_fwd_kernel`` this replaces.  The encoder's attention never writes a
``[B, H, S, T]`` probability tensor to device memory: the forward emits the
output and the log-sum-exp of each query row, and the backward recomputes the
probabilities one key block at a time from the saved log-sum-exp.

* ``flash_attention`` keeps the JAX signature and layout (``[B, S, H, D]``).
  It is a ``torch.autograd.Function``.  On CUDA tensors the forward launches
  the CUDA C++ kernel in ``csrc/flash_attention.cu`` (built with nvcc for
  sm_90a at first use, bound with ctypes, launched on PyTorch's current
  stream) and counts the launch in ``flash_attention.launches``; on CPU
  tensors it runs ``flash_attention_plain``.  There is no fallback: a CUDA
  call that cannot build or launch the kernel raises.  In bf16 at head_dim
  64 and 128 (every shape the port trains) the kernel is Hopper's own:
  persistent CTAs in which a producer warp streams Q and 64-key tiles of K
  and V by TMA into a 3-stage ring of ``mbarrier``-guarded shared memory,
  and consumer warpgroups compute S and O with ``wgmma`` (S, P and the
  output accumulator in registers, P fed as two bf16 terms so the output
  stays within one bf16 ulp of the f32 plain version), tile j-1's P V
  running under tile j's softmax.  head_dim 16 and 32 (tests only) run
  the ``mma.sync`` kernel with a ``cp.async`` ring, f32 inputs (tests only)
  the CUDA cores.  All load rows in 16-byte units, so an input that is not
  16-byte aligned is copied to a fresh allocation first.
* ``flash_attention_plain`` is the plain PyTorch version of the forward, the
  reference the kernel is held against on the card.
* The backward is ``_flash_bwd`` of the JAX package ported line for line:
  plain f32 tensor code looping over key blocks of ``block_k``, as the JAX
  package leaves it to XLA.  There is no backward kernel on either side.
* ``counting_flops()`` (``Trainer.compiled_cost_analysis``): the kernel is
  not an aten op, so ``torch.utils.flop_counter`` cannot see it.  While a
  count is open the op enters it at its own products, 4·BH·S·T·d forward
  (S = QK^T, PV) and 8·BH·S·T·d backward (dP, dV, dS·K, dS^T·Q), and what
  runs inside it (the kernel, the plain version, the backward's blockwise
  recompute of P) is taken back out, so the figure is the dense path's
  whichever implementation ran.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import threading
from typing import Optional

import torch

from ..utils.native_build import load_cuda

NEG_INF = -1e9

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                    "flash_attention.cu")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 128)


def load_kernel() -> ctypes.CDLL:
    """Build (first use, keyed on the source hash) and bind the kernel."""
    # -lcuda: the host encodes the kernel's TMA maps (cuTensorMapEncodeTiled)
    lib = load_cuda(_SRC, "flash_attention", ["-lcuda"])
    p, i32 = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_fwd.restype = i32
    lib.flash_attention_fwd.argtypes = (
        [p] * 6 + [i32] * 6 + [ctypes.c_float] + [i32] * 3 + [p])
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    lib.flash_attention_error_string.argtypes = [i32]
    return lib


def _visited(seq_q: int, seq_k: int, causal: bool, block_q: int, block_k: int,
             device) -> torch.Tensor:
    """[seq_q, seq_k] bool: the keys each query row's forward walk visits.

    Non-causal rows visit every key.  Causal rows visit the whole key blocks
    up to the diagonal of their QUERY block (``_fwd_kernel``'s ``last_kb``),
    so which keys a row visits depends on the caller's ``block_q`` and
    ``block_k``: a row whose visited keys are all masked averages V over
    exactly those keys."""
    if not causal:
        return torch.ones((seq_q, seq_k), dtype=torch.bool, device=device)
    qi = torch.arange(seq_q, device=device) // block_q
    last_kb = torch.clamp(((qi + 1) * block_q - 1) // block_k + 1, max=seq_k // block_k)
    return torch.arange(seq_k, device=device)[None, :] < (last_kb * block_k)[:, None]


def flash_attention_plain(q, k, v, mask, scale: float, causal: bool,
                          block_q: int, block_k: int):
    """Plain PyTorch version of the forward kernel (any device).

    q: [BH, S, d], k/v: [BH, T, d]; mask: [B, 1, T] f32 key-side padding mask
    (0 = padded key; row bh reads batch bh // (BH // B)) or None.  Computes in
    f32 what the online softmax computes: masked logits at the finite
    ``NEG_INF``, keys past a row's causal horizon not visited at all, the max
    floored at ``NEG_INF`` and the sum at 1e-30.  Returns (out in q's dtype,
    lse [BH, S] f32)."""
    bh, seq_q, _ = q.shape
    seq_k = k.shape[1]
    dev = q.device
    logits = (q.float() * scale) @ k.float().transpose(-1, -2)      # [BH, S, T]
    neg = torch.tensor(NEG_INF, dtype=torch.float32, device=dev)
    if causal:
        diag = torch.arange(seq_q, device=dev)[:, None] >= torch.arange(seq_k, device=dev)[None, :]
        logits = torch.where(diag, logits, neg)
    if mask is not None:
        km = mask[:, 0, :].repeat_interleave(bh // mask.shape[0], dim=0) > 0.5  # [BH, T]
        logits = torch.where(km[:, None, :], logits, neg)
    visited = _visited(seq_q, seq_k, causal, block_q, block_k, dev)
    m = (torch.where(visited, logits, float("-inf")).amax(-1, keepdim=True)
         .clamp(min=NEG_INF))
    p = torch.exp(logits - m) * visited
    l = p.sum(-1, keepdim=True).clamp(min=1e-30)
    out = (p @ v.float()) / l
    return out.to(q.dtype), (m + torch.log(l))[..., 0]


class _FlopTally:
    """One open FLOP count: ``model`` the op's own products, ``inside`` what
    the counter saw within the op (the kernel's plain version, the
    backward's recompute), which the caller takes out of its total."""

    def __init__(self):
        self._lock = threading.Lock()
        self.model = 0
        self.inside = 0

    def add(self, model: int, inside: int) -> None:
        # the backward may run on autograd's device thread
        with self._lock:
            self.model += model
            self.inside += inside


_TALLY: Optional[_FlopTally] = None


@contextlib.contextmanager
def counting_flops():
    """Open a FLOP count of the op (see the module docstring); yields the
    ``_FlopTally``.  Counts do not nest."""
    global _TALLY
    if _TALLY is not None:
        raise RuntimeError("flash_attention: a FLOP count is already open")
    _TALLY = tally = _FlopTally()
    try:
        yield tally
    finally:
        _TALLY = None


def _tallied(n_products: int, q, k, fn):
    """``fn()``, with the op's ``n_products`` products of BH·S·T·d (2 FLOPs
    each) entered in the open count in place of what ran inside it."""
    tally = _TALLY
    if tally is None:
        return fn()
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as inner:
        res = fn()
    bh, seq_q, d = q.shape
    tally.add(2 * n_products * bh * seq_q * k.shape[1] * d, inner.get_total_flops())
    return res


def _flash_fwd(q, k, v, mask, scale, causal, block_q, block_k, heads):
    """(out, lse) of the [BH, S, d] rows: the kernel on CUDA tensors, the
    plain version on CPU tensors."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, mask, scale, causal, block_q, block_k)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    bh, seq_q, d = q.shape
    seq_k = k.shape[1]
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q/k/v must share one dtype of f32 or "
                        f"bf16 (got {q.dtype}, {k.dtype}, {v.dtype})")
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {d} not supported by the "
                         f"kernel (one of {_HEAD_DIMS})")
    tensors = [q, k, v] + ([mask] if mask is not None else [])
    if any(t.device != q.device for t in tensors):
        raise ValueError("flash_attention: all tensors must be on one device")
    if mask is not None and (mask.dtype != torch.float32 or mask.shape != (bh // heads, 1, seq_k)):
        raise ValueError(f"flash_attention: mask must be f32 [B, 1, T], got "
                         f"{mask.dtype} {tuple(mask.shape)}")
    # the kernel loads rows in 16-byte chunks: a view at an odd offset is
    # copied to a fresh (aligned) allocation first
    q, k, v = (t.contiguous() if t.data_ptr() % 16 == 0 else t.clone(
        memory_format=torch.contiguous_format) for t in (q, k, v))
    mask = mask.contiguous() if mask is not None else None
    out = torch.empty_like(q)
    lse = torch.empty((bh, seq_q), dtype=torch.float32, device=q.device)
    if bh == 0 or seq_q == 0:
        return out, lse
    lib = load_kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            mask.data_ptr() if mask is not None else None,
            out.data_ptr(), lse.data_ptr(), _DTYPES[q.dtype], bh, seq_q, seq_k,
            d, heads, float(scale), int(causal), block_q, block_k, stream)
    if err != 0:
        raise RuntimeError("flash_attention kernel launch failed: "
                           f"{lib.flash_attention_error_string(err).decode()}")
    flash_attention.launches += 1
    return out, lse


def _flash_bwd(q, k, v, mask, out, lse, do, scale, causal, block_k, heads):
    """Standard flash backward: recompute P per K block from saved lse.
    ``mask``: [B, 1, seq_k] f32 key-side padding mask or None (masked logits
    recompute to NEG_INF exactly as the forward kernel saw them).

    Ported as the JAX package has it, including where it differs from the
    forward: P is recomputed over ALL key blocks, the causal blocks the
    forward never visited included.  For a row with a visible key those
    blocks carry NEG_INF logits and vanish.  A row that sees no key at all
    has lse = NEG_INF + log(visited count), which rounds to NEG_INF in f32,
    so every key of it, visited or not, recomputes to p = exp(0) = 1 and its
    gradient is not the gradient of its forward.  The reference does the
    same, and the tests hold the port to it."""
    f32 = torch.float32
    q32, k32, v32 = q.to(f32), k.to(f32), v.to(f32)
    o32, do32 = out.to(f32), do.to(f32)
    seq_q, seq_k = q.shape[1], k.shape[1]
    delta = torch.sum(o32 * do32, dim=-1)                    # [bh, seq_q]
    num_kb = seq_k // block_k
    if mask is not None:
        # [B, 1, seq_k] -> [bh, seq_k] rows aligned with q's bh rows
        mask_bh = mask[:, 0, :].repeat_interleave(heads, dim=0)
    neg = torch.tensor(NEG_INF, dtype=f32, device=q.device)

    q_pos = torch.arange(seq_q, device=q.device)
    dq = torch.zeros_like(q32)
    dks, dvs = [], []
    for kb in range(num_kb):
        sl = slice(kb * block_k, (kb + 1) * block_k)
        ks, vs = k32[:, sl], v32[:, sl]
        logits = torch.einsum("bqd,bkd->bqk", q32, ks) * scale
        if causal:
            k_pos = kb * block_k + torch.arange(block_k, device=q.device)
            logits = torch.where(q_pos[:, None] >= k_pos[None, :], logits, neg)
        if mask is not None:
            ms = mask_bh[:, sl]
            logits = torch.where(ms[:, None, :] > 0.5, logits, neg)
        p = torch.exp(logits - lse[:, :, None])               # [bh, q, blk]
        dvs.append(torch.einsum("bqk,bqd->bkd", p, do32))
        dp = torch.einsum("bqd,bkd->bqk", do32, vs)
        ds = p * (dp - delta[:, :, None]) * scale
        dks.append(torch.einsum("bqk,bqd->bkd", ds, q32))
        dq = dq + torch.einsum("bqk,bkd->bqd", ds, ks)
    dk = torch.cat(dks, dim=1)
    dv = torch.cat(dvs, dim=1)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _Flash(torch.autograd.Function):
    """Custom VJP of the JAX package's ``_flash``: forward saves
    (q, k, v, mask, out, lse); backward runs ``_flash_bwd``; the mask gets
    no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, mask, causal, block_q, block_k, heads):
        scale = q.shape[-1] ** -0.5
        out, lse = _tallied(2, q, k, lambda: _flash_fwd(q, k, v, mask, scale, causal,
                                                        block_q, block_k, heads))
        ctx.save_for_backward(q, k, v, mask, out, lse)
        ctx.causal, ctx.block_k, ctx.heads = causal, block_k, heads
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, mask, out, lse = ctx.saved_tensors
        scale = q.shape[-1] ** -0.5
        dq, dk, dv = _tallied(4, q, k, lambda: _flash_bwd(
            q, k, v, mask, out, lse, do, scale, ctx.causal, ctx.block_k, ctx.heads))
        return dq, dk, dv, None, None, None, None, None


def flash_attention(
    q: torch.Tensor,  # [B, S, H, D]
    k: torch.Tensor,  # [B, T, H, D]
    v: torch.Tensor,  # [B, T, H, D]
    causal: bool = False,
    block_q: int = 128,
    block_k: int = 128,
    kv_mask: Optional[torch.Tensor] = None,  # [B, T] {0,1}: 0 = padded key
) -> torch.Tensor:
    """Drop-in for ops.attention.multihead_attention.

    ``kv_mask`` is the key-side padding mask (the side the dense path's
    ``padding_mask`` masks): padded keys are excluded from every query's
    softmax.  Padded QUERY rows still compute (over real keys only); their
    outputs are garbage the loss masks out, exactly as dense.  ``block_q`` /
    ``block_k`` are clamped to the sequence lengths and must divide them; under
    ``causal`` they decide which keys a query row visits (see ``_visited``).
    """
    b, s, h, d = q.shape
    t = k.shape[1]
    block_q = min(block_q, s)
    block_k = min(block_k, t)
    if s % block_q or t % block_k:
        raise ValueError(f"seq lengths ({s},{t}) must divide blocks ({block_q},{block_k})")
    # [B, S, H, D] -> [B*H, S, D] rows for the kernel grid
    qf = q.transpose(1, 2).reshape(b * h, s, d)
    kf = k.transpose(1, 2).reshape(b * h, t, d)
    vf = v.transpose(1, 2).reshape(b * h, t, d)
    mask = None if kv_mask is None else kv_mask.reshape(b, 1, t).float()
    of = _Flash.apply(qf, kf, vf, mask, causal, block_q, block_k, h)
    return of.reshape(b, h, s, d).transpose(1, 2)


flash_attention.launches = 0
