"""The split-and-fold design of the port's paged-attention kernel, on the CPU.

The Hopper kernel (``kubeflow_tpu_torch/serving/engine/csrc/paged_attention.cu``)
cuts each slot's page walk into at most 16 chunks of ``pages_per_split``
pages.  The chunks of one (slot, kv head, row tile) are the blocks of one
thread-block cluster, each owning a share of the output columns: a block
that walked a live chunk pushes its raw ``(m, l, acc)`` partial into the
owners' shared memory (a chunk starting past the slot's horizon pushes
nothing), and after a cluster barrier every block folds the live chunks'
partials for its own columns.  ``split_merge`` below models that one kernel
in torch, step for step (``split_partials`` the per-chunk partials,
``merge`` the fold by column share), and is held against
``paged_attention_plain`` and against the JAX package's Pallas kernel in
interpret mode (as tests/test_torch_paged_attention.py runs it).  The CUDA
kernel itself is held against the plain version on the card
(tests/test_torch_kernels_cuda.py)."""

import inspect
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

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
    """The split blocks: for every (slot, chunk of ``pps`` pages) the raw
    partial ``(m, l, acc)`` of every kv head's rows over the chunk's pages,
    as the chunk's block pushes it.  A chunk that starts at or past the
    slot's horizon visits no page and pushes nothing; the model gives it
    the empty partial (m = NEG_INF, l = 0, acc = 0), which the fold never
    reads.  Returns {(b, chunk): (m [Hkv, rows], l [Hkv, rows], acc
    [Hkv, rows, hd])} for every chunk."""
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
            if j0 >= j1:                                    # an empty partial
                parts[b, c] = (torch.full((nkv, rows), NEG_INF), torch.zeros((nkv, rows)),
                               torch.zeros((nkv, rows, d)))
                continue
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


def live_chunks(seq_len, K, page_size, max_pages, pps):
    """The chunks a slot's fold reads: those that start before its horizon
    (from seq_lens alone, as every block of the cluster computes it)."""
    n_pages = min(max_pages, -(-(seq_len + K - 1) // page_size))
    return -(-n_pages // pps)


def column_share(rank, splits, hd):
    """The output columns block ``rank`` of a cluster of ``splits`` folds."""
    per = -(-hd // splits)
    return range(min(hd, rank * per), min(hd, (rank + 1) * per))


def merge(parts, q, lens, page_size, max_pages, pps):
    """The fold, as the cluster runs it: every block computes each row's
    weights exp(m_i - M) and denominator from the live chunks' raw m and l,
    then writes its own share of the columns, sum_i w_i acc_i / max(sum_i
    w_i l_i, 1e-30); zeros for a slot with no live chunk."""
    Bn, K, nq, d = q.shape
    splits = -(-max_pages // pps)
    out = torch.zeros((Bn, K, nq, d))
    for b in range(Bn):
        live = live_chunks(int(lens[b]), K, page_size, max_pages, pps)
        if live == 0:
            continue
        ms = torch.stack([parts[b, c][0] for c in range(live)])   # [live, Hkv, rows]
        M = ms.amax(0)
        w = torch.exp(ms - M)
        den = sum(w[c] * parts[b, c][1] for c in range(live))
        o = torch.zeros(parts[b, 0][2].shape)                    # [Hkv, rows, hd]
        for rank in range(splits):
            cols = list(column_share(rank, splits, d))
            num = sum(w[c][..., None] * parts[b, c][2][..., cols] for c in range(live))
            o[..., cols] = num / den.clamp(min=1e-30)[..., None]
        nkv = o.shape[0]
        out[b] = o.reshape(nkv, K, nq // nkv, d).permute(1, 0, 2, 3).reshape(K, nq, d)
    return out


def split_merge(q, k_pool, v_pool, table, lens, page_size, pps):
    parts = split_partials(q, k_pool, v_pool, table, lens, page_size, pps)
    return merge(parts, q, lens, page_size, table.shape[1], pps)


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
    hold a partial the fold reads; every other block of the cluster pushes
    nothing (its partial in the model is the empty one, and it still takes
    part in the cluster's barriers), and the fold counts the live chunks
    from seq_lens alone."""
    K = 5
    parts = split_partials(*_torch_inputs(K), ps, pps)
    splits = -(-MP // pps)
    for b in range(B):
        n_pages = min(MP, -(-(int(SEQ_LENS[b]) + K - 1) // ps))
        live = live_chunks(int(SEQ_LENS[b]), K, ps, MP, pps)
        assert live == -(-n_pages // pps)
        assert sorted(c for bb, c in parts if bb == b) == list(range(splits))
        for c in range(live, splits):
            m, l, acc = parts[b, c]
            assert torch.all(m == NEG_INF) and not l.any() and not acc.any()


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


@pytest.mark.parametrize("splits", range(1, 17))
def test_fold_column_shares_cover_hd_once(splits):
    """Every output column of a cluster of 1..16 blocks is folded by exactly
    one block, at the head dims the kernel serves."""
    for d in (16, 64, 96, 128, 160, 192, 256):
        cols = [c for rank in range(splits) for c in column_share(rank, splits, d)]
        assert sorted(cols) == list(range(d))


@pytest.mark.parametrize("pps", [1, 2])
@pytest.mark.parametrize("K", [1, 5])
def test_fold_of_empty_partials_changes_nothing(K, pps):
    """Reading a dead chunk's empty partial into the fold would not move the
    output either (its weight meets l = 0 and acc = 0), but the kernel reads
    the live chunks only: the fold over live chunks equals the plain
    version, and an all-idle batch folds to zeros."""
    q, kp, vp, pt, _ = _torch_inputs(K)
    idle = torch.zeros(B, dtype=torch.int32)
    got = split_merge(q, kp, vp, pt, idle, ps, pps)
    if K == 1:
        assert torch.equal(got, torch.zeros_like(got))
    want = PA.paged_attention_plain(q, kp, vp, pt, idle, ps)
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)


# The served shapes at small depth: hd 192 with 16/16 heads (the Gemma
# pipeline's served model, d_model 3072 over 16 heads) and the main
# Llama-3-8B shape, 32/8 heads at hd 128, page 32.
SERVED = {"gemma_hd192": (16, 16, 192), "llama_main": (32, 8, 128)}
SERVED_TABLE = np.array([[2, 4, 6, 1], [3, 5, 0, 0], [7, 0, 0, 0]], np.int32)
SERVED_LENS = np.array([100, 33, 0], np.int32)


def _served_inputs(name, K):
    nq, nkv, d = SERVED[name]
    rng = np.random.default_rng(d + K)
    return (rng.standard_normal((3, K, nq, d)).astype(np.float32),
            rng.standard_normal((8, nkv, 32, d)).astype(np.float32),
            rng.standard_normal((8, nkv, 32, d)).astype(np.float32))


@pytest.mark.parametrize("K", [1, 5])
@pytest.mark.parametrize("name", sorted(SERVED))
def test_split_fold_matches_jax_kernel_at_the_served_shapes(name, K):
    """The cluster model at the plan's own split and at one page a chunk
    against the JAX kernel in interpret mode: hd 192 with 16/16 heads and
    the main shape, K 1 and 5."""
    q, kp, vp = _served_inputs(name, K)
    ref = np.asarray(jax_paged_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(SERVED_TABLE),
        jnp.asarray(SERVED_LENS), 32, interpret=True), np.float32)
    nq, nkv, _ = SERVED[name]
    plan = PA._split_plan(SERVED_TABLE.shape[1], 3, nkv, K * nq // nkv)
    for pps in sorted({plan, 1}):
        got = split_merge(torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
                          torch.from_numpy(SERVED_TABLE), torch.from_numpy(SERVED_LENS), 32, pps)
        np.testing.assert_allclose(got.numpy(), ref, rtol=TOL, atol=TOL)


@settings(max_examples=300, deadline=None)
@given(max_pages=st.integers(1, 4096), batch=st.integers(1, 256),
       kv_heads=st.integers(1, 64), rows=st.integers(1, 256))
def test_split_plan_never_exceeds_one_cluster(max_pages, batch, kv_heads, rows):
    """Whatever the shapes, the plan cuts max_pages into at most MAX_SPLITS
    (16) chunks of a power-of-two page count that together cover every
    page, so the chunks of a slot always fit one cluster."""
    pps = PA._split_plan(max_pages, batch, kv_heads, rows)
    splits = -(-max_pages // pps)
    assert PA.MAX_SPLITS == 16
    assert 1 <= splits <= PA.MAX_SPLITS
    assert pps & (pps - 1) == 0
    assert (splits - 1) * pps < max_pages <= splits * pps


def test_split_plan_caps_the_tp_shard_at_one_cluster():
    """At the 8/2-head tensor-parallel shard (8 slots, 64 pages, K = 1) the
    uncapped plan would cut 64 chunks of one page; capped it is 16 of 4."""
    assert PA._split_plan(64, 8, 2, 4) == 4
