"""The split-and-merge design of the port's paged-attention kernel, on the CPU.

The Hopper kernel (``kubeflow_tpu_torch/serving/engine/csrc/paged_attention.cu``)
cuts each slot's page walk into chunks of ``pages_per_split`` pages, writes a
raw ``(m, l, acc)`` partial per chunk and merges the live chunks in a second
kernel.  ``split_merge`` below models those two kernels in torch, step for
step, and is held against ``paged_attention_plain`` and against the JAX
package's Pallas kernel in interpret mode (as tests/test_torch_paged_attention.py
runs it).  The CUDA kernels themselves are held against the plain version on
the card (tests/test_torch_kernels_cuda.py)."""

import inspect
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.serving.engine.paged_attention import paged_attention as jax_paged_attention
from kubeflow_tpu_torch.serving.engine import paged_attention as PA

B, Hq, Hkv, hd, ps, P, MP = 4, 4, 2, 16, 8, 20, 6
PAGE_TABLE = np.array([[3, 5, 7, 9, 11, 13],
                       [1, 2, 4, 6, 8, 10],
                       [12, 14, 0, 0, 0, 0],
                       [15, 16, 17, 18, 19, 1]], np.int32)
# slot 0: partial last page; slot 1: one page and chunks past the horizon;
# slot 2: idle (at K > 1 its row 0 sees nothing); slot 3: every page
SEQ_LENS = np.array([20, 9, 0, 48], np.int32)
NEG_INF = PA.NEG_INF


def _inputs(K, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, K, Hq, hd)).astype(np.float32),
            rng.standard_normal((P, Hkv, ps, hd)).astype(np.float32),
            rng.standard_normal((P, Hkv, ps, hd)).astype(np.float32))


def split_partials(q, k_pool, v_pool, table, lens, page_size, pps):
    """The split kernel: for every (slot, kv head, chunk of ``pps`` pages)
    whose chunk starts before the slot's horizon, the raw partial ``(m, l,
    acc)`` of its rows over the chunk's pages.  Returns {(b, chunk): (m
    [Hkv, rows], l [Hkv, rows], acc [Hkv, rows, hd])}."""
    Bn, K, nq, d = q.shape
    nkv = k_pool.shape[1]
    group = nq // nkv
    rows = K * group
    max_pages = table.shape[1]
    qg = (q.float() * d ** -0.5).reshape(Bn, K, nkv, group, d).permute(0, 2, 1, 3, 4)
    qg = qg.reshape(Bn, nkv, rows, d)
    parts = {}
    for b in range(Bn):
        n_pages = min(max_pages, -(-(int(lens[b]) + K - 1) // page_size))
        see = int(lens[b]) + torch.arange(rows) // group       # [rows]
        for c, j0 in enumerate(range(0, max_pages, pps)):
            j1 = min(j0 + pps, n_pages)
            if j0 >= j1:
                continue                                    # exits: no partial
            pages = table[b, j0:j1].long()
            k = k_pool[pages].permute(1, 0, 2, 3).reshape(nkv, -1, d)
            v = v_pool[pages].permute(1, 0, 2, 3).reshape(nkv, -1, d)
            pos = j0 * page_size + torch.arange(k.shape[1])
            s = qg[b] @ k.transpose(-1, -2)                     # [Hkv, rows, T]
            s = torch.where(pos[None, None, :] < see[None, :, None], s, NEG_INF)
            m = s.amax(-1).clamp(min=NEG_INF)
            p = torch.exp(s - m[..., None])
            parts[b, c] = (m, p.sum(-1), p @ v)
    return parts


def merge(parts, q):
    """The merge kernel: raw m and l, zeros for a slot with no partial."""
    Bn, K, nq, d = q.shape
    out = torch.zeros((Bn, K, nq, d))
    for b in range(Bn):
        mine = [parts[key] for key in sorted(parts) if key[0] == b]
        if not mine:
            continue
        M = torch.stack([m for m, _, _ in mine]).amax(0)
        w = [torch.exp(m - M) for m, _, _ in mine]
        num = sum(wi[..., None] * acc for wi, (_, _, acc) in zip(w, mine))
        den = sum(wi * l for wi, (_, l, _) in zip(w, mine))
        o = num / den.clamp(min=1e-30)[..., None]               # [Hkv, rows, hd]
        nkv = o.shape[0]
        out[b] = o.reshape(nkv, K, nq // nkv, d).permute(1, 0, 2, 3).reshape(K, nq, d)
    return out


def split_merge(q, k_pool, v_pool, table, lens, page_size, pps):
    return merge(split_partials(q, k_pool, v_pool, table, lens, page_size, pps), q)


def _torch_inputs(K):
    q, kp, vp = _inputs(K)
    return (torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
            torch.from_numpy(PAGE_TABLE), torch.from_numpy(SEQ_LENS))


# f32 on both sides: summation order only (the reference's f32 kernel bound,
# tests/test_engine.py:357)
TOL = 1e-5


@pytest.mark.parametrize("pps", [1, 2, 3])
@pytest.mark.parametrize("K", [1, 5])
def test_split_merge_matches_plain(K, pps):
    q, kp, vp, pt, sl = _torch_inputs(K)
    got = split_merge(q, kp, vp, pt, sl, ps, pps)
    want = PA.paged_attention_plain(q, kp, vp, pt, sl, ps)
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)
    if K == 1:
        assert torch.equal(got[2], torch.zeros_like(got[2]))  # idle slot: no partial


@pytest.mark.parametrize("pps", [1, 2, 3])
@pytest.mark.parametrize("K", [1, 5])
def test_split_merge_matches_jax_kernel(K, pps):
    q, kp, vp = _inputs(K)
    ref = jax_paged_attention(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                              jnp.asarray(PAGE_TABLE), jnp.asarray(SEQ_LENS), ps,
                              interpret=True)
    got = split_merge(*_torch_inputs(K), ps, pps)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref, np.float32), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("pps", [1, 2, 3])
def test_chunks_past_the_horizon_write_no_partial(pps):
    """Only chunks that start before the slot's horizon seq_len + K - 1
    produce a partial; the merge counts the live ones from seq_lens alone."""
    K = 5
    parts = split_partials(*_torch_inputs(K), ps, pps)
    for b in range(B):
        n_pages = min(MP, -(-(int(SEQ_LENS[b]) + K - 1) // ps))
        live = sorted(c for bb, c in parts if bb == b)
        assert live == list(range(-(-n_pages // pps)))


def test_unseeing_row_averages_v_over_every_chunk():
    """Slot 2 at K=5 visits page 0 only (row 4's horizon is 4); its row 0
    sees nothing and averages V uniformly over that page, whatever the
    split."""
    q, kp, vp, pt, sl = _torch_inputs(5)
    page0 = vp[PAGE_TABLE[2, 0]]                        # [Hkv, ps, hd]
    for pps in (1, 2, 3):
        out = split_merge(q, kp, vp, pt, sl, ps, pps)
        for hq in range(Hq):
            torch.testing.assert_close(out[2, 0, hq], page0[hq // (Hq // Hkv)].mean(0),
                                       rtol=TOL, atol=TOL)


def test_lse_merge_would_lose_an_unseeing_rows_counts():
    """Why the partials carry m and l raw: an unseeing row's chunks have
    m = NEG_INF and l = their visited-token counts (8 and 4 here), but in
    f32 NEG_INF + log(l) rounds to NEG_INF, so a merge of log-sum-exps
    weighs the two chunks equally instead of 8 : 4."""
    m = torch.tensor([NEG_INF, NEG_INF], dtype=torch.float32)
    l = torch.tensor([8.0, 4.0])
    acc = torch.tensor([8.0 * 1.0, 4.0 * 4.0])     # chunk means 1 and 4
    raw = (torch.exp(m - m.max()) * acc).sum() / (torch.exp(m - m.max()) * l).sum()
    assert raw.item() == pytest.approx(2.0)         # (8*1 + 4*4) / 12
    lse = m + torch.log(l)
    assert torch.equal(lse, m)                      # the counts are gone
    w = torch.exp(lse - lse.max())
    lse_merged = (w * acc / l).sum() / w.sum()
    assert lse_merged.item() == pytest.approx(2.5)  # the plain mean of the means


@pytest.mark.parametrize("max_pages,batch,kv_heads,rows", [
    (64, 8, 8, 4), (64, 8, 8, 20), (8, 4, 2, 4), (1, 1, 1, 1), (100, 1, 8, 4),
    (512, 64, 8, 4), (7, 3, 4, 40)])
def test_split_plan_covers_max_pages(max_pages, batch, kv_heads, rows):
    pps = PA._split_plan(max_pages, batch, kv_heads, rows)
    assert 1 <= pps <= max_pages and pps & (pps - 1) == 0
    splits = -(-max_pages // pps)
    assert (splits - 1) * pps < max_pages <= splits * pps


def test_split_plan_reads_shapes_only():
    """The plan takes no tensor: it cannot read seq_lens back from the card."""
    params = list(inspect.signature(PA._split_plan).parameters)
    assert params == ["max_pages", "batch", "kv_heads", "rows"]
    assert PA._split_plan(64, 8, 8, 4) == PA._split_plan(64, 8, 8, 4)


@pytest.mark.parametrize("K", [1, 5])
def test_split_plan_fills_two_waves_at_the_main_shapes(K):
    """Llama-3-8B decode on the engine defaults (8 slots, 64 pages a slot,
    32/8 heads): at least two waves of split blocks over 132 SMs."""
    rows = K * 32 // 8
    pps = PA._split_plan(64, 8, 8, rows)
    blocks = math.ceil(64 / pps) * 8 * 8 * PA._row_tiles(rows)
    assert blocks >= 2 * 132
