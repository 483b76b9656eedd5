"""Dense attention, the reference implementation of the attention family.

Counterpart of ``kubeflow_tpu/ops/attention.py``.  Plain PyTorch: the JAX
package computes this outside any Pallas kernel (XLA fuses the softmax into
the two products), so the port leaves it to ``torch.matmul`` too.  The flash
kernel (``ops/flash_attention.py``) plugs in behind the same signature.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e9  # bf16-safe large negative (not -inf: softmax of all-masked rows)


def multihead_attention(
    q: torch.Tensor,  # [B, S, H, D]
    k: torch.Tensor,  # [B, T, H, D]
    v: torch.Tensor,  # [B, T, H, D]
    mask: Optional[torch.Tensor] = None,  # broadcastable to [B, H, S, T]; True = attend
    causal: bool = False,
) -> torch.Tensor:
    """Plain softmax attention over [batch, seq, heads, head_dim] tensors."""
    s, d = q.shape[1], q.shape[-1]
    t = k.shape[1]
    scale = d ** -0.5
    logits = torch.einsum("bshd,bthd->bhst", q, k) * scale
    if causal:
        causal_mask = torch.ones((s, t), dtype=torch.bool, device=q.device).tril()
        logits = torch.where(causal_mask[None, None], logits,
                             torch.tensor(NEG_INF, dtype=logits.dtype, device=q.device))
    if mask is not None:
        logits = torch.where(mask, logits,
                             torch.tensor(NEG_INF, dtype=logits.dtype, device=q.device))
    # softmax in fp32 for stability; the probabilities are rounded back to the
    # input dtype before the PV product, exactly as the JAX package does
    probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhst,bthd->bshd", probs, v)


def attention_flops(batch: int, seq: int, heads: int, head_dim: int, causal: bool = False) -> float:
    """Matmul FLOPs of one attention call (fwd only): QK^T + PV."""
    f = 2 * 2 * batch * heads * seq * seq * head_dim
    return f / 2 if causal else f


def padding_mask(attention_mask: torch.Tensor) -> torch.Tensor:
    """[B, T] {0,1} token mask → [B, 1, 1, T] broadcastable boolean."""
    return attention_mask[:, None, None, :].bool()
