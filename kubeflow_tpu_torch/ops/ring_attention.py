"""Ring attention: context parallelism over the ``seq`` mesh axis.

Counterpart of ``kubeflow_tpu/ops/ring_attention.py``.  Each shard owns one
sequence block of Q/K/V; K/V blocks rotate around the ring by ``ppermute``
(one hop a step), and each shard folds each visiting block into an
online-softmax accumulator.  Peak memory per shard stays O(S/n · S/n).

The fold is the JAX package's: logits in f32, masked at the finite
``NEG_INF``, the running max, sum and accumulator in f32, the sum clamped at
1e-30, the result cast to q's dtype.  Under ``causal`` a visiting block that
lies strictly in the future skips both products (``lax.cond`` there), and
the diagonal block gets the intra-block triangle.  The JAX op is plain
einsums, not a Pallas kernel, so this port is plain torch too: autograd
derives the reverse ring pass, as JAX's autodiff does.  One controller runs
the shards in lockstep (``ops/shard_map_compat.py``): each step folds every
shard's visiting block, then rotates K and V.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from ..parallel.mesh import Mesh, current_mesh
from ..parallel.sharding import P
from .shard_map_compat import axis_index, axis_size, each, ppermute, shard_map

NEG_INF = -1e9


def _ring_block(q, k, my_idx: int, src_idx: int, block_len: int, causal: bool, scale: float):
    """The logits of q against the visiting k block: [B, H, s, t] f32."""
    logits = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * scale
    if causal:
        s = q.shape[1]
        pos = torch.arange(s, device=q.device)
        q_pos = my_idx * block_len + pos
        k_pos = src_idx * block_len + pos
        logits = torch.where(q_pos[:, None] >= k_pos[None, :], logits,
                             torch.tensor(NEG_INF, dtype=logits.dtype, device=q.device))
    return logits


def _fold(q, k_r, v_r, m, l, acc, my_idx: int, src: int, causal: bool):
    """One online-softmax update: q attends to the visiting (k, v) block."""
    s, d = q.shape[1], q.shape[-1]
    logits = _ring_block(q, k_r, my_idx, src, s, causal, d ** -0.5)  # [B,H,s,t]
    m_new = torch.maximum(m, logits.amax(dim=-1))
    p = torch.exp(logits - m_new[..., None])
    corr = torch.exp(m - m_new)                                       # [B,H,s]
    l_new = l * corr + p.sum(dim=-1)
    pv = torch.einsum("bhst,bthd->bshd", p, v_r.float())
    return m_new, l_new, acc * corr.transpose(1, 2)[..., None] + pv


def _ring_attention_sharded(qs, ks, vs, *, axis_name, causal):
    """The ring over per-shard lists of [B, s, H, D] blocks."""
    n = axis_size(axis_name)
    my = axis_index(axis_name)
    perm = [(j, (j + 1) % n) for j in range(n)]

    def init(q):
        b, s, h, d = q.shape
        f32 = torch.float32
        return (torch.full((b, h, s), NEG_INF, dtype=f32, device=q.device),
                torch.zeros((b, h, s), dtype=f32, device=q.device),
                torch.zeros((b, s, h, d), dtype=f32, device=q.device))

    state = each(init, qs)
    k_r, v_r = list(ks), list(vs)
    # across processes a future block is folded masked (exact zeros: the
    # diagonal block, folded first, has set every row's max), so that every
    # process's backward reaches every ppermute: a block one process skips
    # drops its receive from the graph and leaves the peer waiting
    skip_future = causal and current_mesh().is_fully_addressable
    for r in range(n):
        def step(q, k, v, st, i):
            src = (i - r) % n
            if skip_future and src > i:
                # a visiting block strictly in the future contributes
                # nothing: skip BOTH products, not just mask them
                return st
            return _fold(q, k, v, *st, i, src, causal)

        state = each(step, qs, k_r, v_r, state, my)
        if r + 1 < n:  # the last rotation's result is never read
            k_r = ppermute(k_r, axis_name, perm)
            v_r = ppermute(v_r, axis_name, perm)

    def finish(q, st):
        _, l, acc = st
        l = torch.clamp(l, min=1e-30)
        return (acc / l.transpose(1, 2)[..., None]).to(q.dtype)

    return each(finish, qs, state)


def ring_attention(
    q: torch.Tensor,  # [B, S, H, D] — S split over `axis` of the mesh
    k: torch.Tensor,
    v: torch.Tensor,
    mesh: Mesh,
    causal: bool = True,
    axis: str = "seq",
    qkv_spec: Optional[P] = None,
) -> torch.Tensor:
    """Context-parallel attention over the mesh's ``axis``.

    ``qkv_spec`` defaults to ``P(None, axis, None, None)`` (batch replicated
    over the ring); give the full spec if batch/heads ride other axes too.
    """
    spec = qkv_spec if qkv_spec is not None else P(None, axis, None, None)
    fn = shard_map(
        functools.partial(_ring_attention_sharded, axis_name=axis, causal=causal),
        mesh=mesh,
        in_specs=(spec, spec, spec),
        out_specs=spec,
        check_vma=False,
    )
    return fn(q, k, v)
