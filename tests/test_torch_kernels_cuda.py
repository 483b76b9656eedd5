"""The port's hand-written CUDA kernels against their plain PyTorch versions,
on the card.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU (a CUDA
kernel has no CPU mode).  The file imports neither JAX nor the JAX package,
so it runs on a machine that has only the port's dependencies:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

(``--noconftest``: tests/conftest.py configures JAX for the CPU suite.)
The parity of the plain versions with the JAX package's TPU kernels is
tests/test_torch_paged_attention.py's and tests/test_torch_flash_attention.py's
job."""

import importlib

import pytest
import torch

from kubeflow_tpu_torch.serving.engine import model as M
from kubeflow_tpu_torch.serving.engine import paged_attention as PA

B, Hq, Hkv, hd, ps, P, MP = 4, 8, 2, 128, 32, 40, 8
SEQ_LENS = [256, 0, 33, 97]  # a full slot, an idle slot, partial last pages

# (pool kind, q dtype, rtol, atol).  f32 everywhere: both sides compute in
# f32 and differ only in summation order.  bf16 q (output in bf16): one
# bf16 ulp of the output (2**-7 relative) plus 1e-3 for outputs near zero.
CASES = [("f32", torch.float32, 1e-5, 1e-5), ("bf16", torch.bfloat16, 2.0 ** -7, 1e-3),
         ("int8", torch.bfloat16, 2.0 ** -7, 1e-3)]


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [1, 5])
@pytest.mark.parametrize("kind,q_dtype,rtol,atol", CASES, ids=[c[0] for c in CASES])
def test_paged_attention_kernel_matches_plain(card, kind, q_dtype, rtol, atol, K):
    g = torch.Generator().manual_seed(0)
    q = torch.randn((B, K, Hq, hd), generator=g).to(card, q_dtype)

    def pool():
        x = torch.randn((P, Hkv, ps, hd), generator=g)
        if kind == "int8":
            qv, s = M._quantize_kv(x.to(torch.bfloat16))
            return {"q": qv.to(card), "s": s.to(card)}
        return x.to(card, torch.float32 if kind == "f32" else torch.bfloat16)

    k_pool, v_pool = pool(), pool()
    table = torch.randint(1, P, (B, MP), generator=g, dtype=torch.int32).to(card)
    lens = torch.tensor(SEQ_LENS, dtype=torch.int32, device=card)
    before = PA.paged_attention.launches
    out = PA.paged_attention(q, k_pool, v_pool, table, lens, ps)
    ref = PA.paged_attention_plain(q, k_pool, v_pool, table, lens, ps)
    torch.cuda.synchronize()
    assert PA.paged_attention.launches == before + 1
    assert out.dtype == q.dtype and out.shape == q.shape
    torch.testing.assert_close(out.float(), ref.float(), rtol=rtol, atol=atol)
    if K == 1:
        assert torch.all(out[1] == 0)  # the idle slot visits no page


# Many splits: a 2048-token slot over 64 pages, lengths that end exactly on
# a page and on a chunk boundary (pps 4 at ps 32 = 128 tokens) or one token
# past it, an idle slot, and seq_len 64: at K=5 its furthest row sees up to
# position 67, so it visits page 2, which its row 0 (positions < 64) cannot
# see.
SPLIT_MP, SPLIT_P = 64, 200
SPLIT_LENS = [2048, 128, 129, 0, 64, 256, 1, 1000]


def _split_inputs(kind, q_dtype, K, card):
    g = torch.Generator().manual_seed(K)
    q = torch.randn((len(SPLIT_LENS), K, Hq, hd), generator=g).to(card, q_dtype)

    def pool():
        x = torch.randn((SPLIT_P, Hkv, ps, hd), generator=g)
        if kind == "int8":
            qv, s = M._quantize_kv(x.to(torch.bfloat16))
            return {"q": qv.to(card), "s": s.to(card)}
        return x.to(card, torch.float32 if kind == "f32" else torch.bfloat16)

    k_pool, v_pool = pool(), pool()
    table = torch.randint(1, SPLIT_P, (len(SPLIT_LENS), SPLIT_MP), generator=g,
                          dtype=torch.int32).to(card)
    lens = torch.tensor(SPLIT_LENS, dtype=torch.int32, device=card)
    return q, k_pool, v_pool, table, lens


# every pages_per_split _split_plan can return at max_pages 64: a power of two
SPLIT_PPS = [1, 2, 4, 8, 16, 32, 64]


@pytest.mark.cuda
@pytest.mark.parametrize("pps", SPLIT_PPS)
@pytest.mark.parametrize("K", [1, 5])
@pytest.mark.parametrize("kind,q_dtype,rtol,atol", CASES, ids=[c[0] for c in CASES])
def test_paged_attention_kernel_every_split(card, kind, q_dtype, rtol, atol, K, pps):
    q, k_pool, v_pool, table, lens = _split_inputs(kind, q_dtype, K, card)
    out = PA.paged_attention(q, k_pool, v_pool, table, lens, ps, _pages_per_split=pps)
    ref = PA.paged_attention_plain(q, k_pool, v_pool, table, lens, ps)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), rtol=rtol, atol=atol)
    if K == 1:
        assert torch.all(out[3] == 0)  # the idle slot: no chunk writes a partial


@pytest.mark.cuda
@pytest.mark.parametrize("K", [1, 5])
@pytest.mark.parametrize("kind", ["bf16", "int8"])
@pytest.mark.parametrize("head_dim,page", [(64, 32), (128, 16), (64, 16), (32, 32), (128, 8)])
def test_paged_attention_kernel_other_tiles(card, head_dim, page, kind, K):
    """The tensor-core kernel's other (hd, page size) instantiations, and
    shapes outside them (hd 32, page 8) that take the CUDA-core kernel."""
    g = torch.Generator().manual_seed(head_dim + page)
    lens = [page * 5, 0, page + 1, 7]
    q = torch.randn((len(lens), K, Hq, head_dim), generator=g).to(card, torch.bfloat16)

    def pool():
        x = torch.randn((P, Hkv, page, head_dim), generator=g).to(torch.bfloat16)
        if kind == "int8":
            qv, s = M._quantize_kv(x)
            return {"q": qv.to(card), "s": s.to(card)}
        return x.to(card)

    k_pool, v_pool = pool(), pool()
    table = torch.randint(1, P, (len(lens), MP), generator=g, dtype=torch.int32).to(card)
    seq = torch.tensor(lens, dtype=torch.int32, device=card)
    out = PA.paged_attention(q, k_pool, v_pool, table, seq, page, _pages_per_split=2)
    ref = PA.paged_attention_plain(q, k_pool, v_pool, table, seq, page)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), rtol=2.0 ** -7, atol=1e-3)


@pytest.mark.cuda
def test_paged_attention_plan_is_one_of_the_tested_splits(card):
    for rows in (4, 20):
        assert PA._split_plan(SPLIT_MP, len(SPLIT_LENS), Hkv, rows) in SPLIT_PPS


@pytest.mark.cuda
def test_paged_attention_rejects_unaligned_pools(card):
    q = torch.zeros((1, 1, Hq, hd), dtype=torch.bfloat16, device=card)
    flat = torch.zeros(P * Hkv * ps * hd + 1, dtype=torch.bfloat16, device=card)
    pool = flat[1:].view(P, Hkv, ps, hd)  # 2 bytes past a 16-byte boundary
    table = torch.zeros((1, MP), dtype=torch.int32, device=card)
    lens = torch.ones((1,), dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="16-byte"):
        PA.paged_attention(q, pool, pool, table, lens, ps)


# ------------------------------------------------------------ flash attention

FA = importlib.import_module("kubeflow_tpu_torch.ops.flash_attention")
FB, FS, FH = 2, 96, 3  # S = 96: the kernel's second 64-row query tile is half full
# (dtype, rtol, atol).  f32: both sides in f32, summation order only.  bf16:
# one bf16 ulp of the output (2**-7 relative) plus 1e-3 near zero; lse is f32
# on both sides.
FLASH_CASES = [(torch.float32, 1e-5, 1e-5), (torch.bfloat16, 2.0 ** -7, 1e-3)]


def _flash_mask(kind, card):
    if kind is None:
        return None
    am = torch.ones((FB, FS), device=card)
    if kind == "ragged":
        am[0, 50:] = 0
    else:  # "left": under causal, batch 1's first 40 query rows see no key
        am[1, :40] = 0
    return am


@pytest.mark.cuda
@pytest.mark.parametrize("mask_kind", [None, "ragged", "left"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("D", [16, 64, 128])
@pytest.mark.parametrize("dtype,rtol,atol", FLASH_CASES, ids=["f32", "bf16"])
def test_flash_attention_kernel_matches_plain(card, dtype, rtol, atol, D, causal, mask_kind):
    g = torch.Generator().manual_seed(D)
    q, k, v = (torch.randn((FB * FH, FS, D), generator=g).to(card, dtype) for _ in range(3))
    am = _flash_mask(mask_kind, card)
    mask = None if am is None else am.reshape(FB, 1, FS)
    args = (q, k, v, mask, D ** -0.5, causal, 32, 32)
    before = FA.flash_attention.launches
    out, lse = FA._flash_fwd(*args[:-2], 32, 32, FH)
    ref, ref_lse = FA.flash_attention_plain(*args)
    torch.cuda.synchronize()
    assert FA.flash_attention.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape and lse.dtype == torch.float32
    torch.testing.assert_close(out.float(), ref.float(), rtol=rtol, atol=atol)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [200, 512])
@pytest.mark.parametrize("block_q,block_k", [(32, 64), (64, 32)])
@pytest.mark.parametrize("D", [16, 32, 64, 128])
def test_flash_attention_kernel_partial_tiles_and_caller_blocks(card, D, block_q, block_k, S):
    """bf16 at S = 200 (the kernel's last 128- or 64-row query tile and its
    last 64-key tile are partial) and S = 512, with the caller's block_q !=
    block_k, so the causal horizon of a row differs from the kernel's
    tiles; causal with batch 1's first 40 keys padded (its first rows see
    no key) and non-causal with batch 0 keeping 150 keys."""
    g = torch.Generator().manual_seed(S + D)
    q, k, v = (torch.randn((FB * FH, S, D), generator=g).to(card, torch.bfloat16)
               for _ in range(3))
    am = torch.ones((FB, S), device=card)
    am[0, 150:] = 0
    am[1, :40] = 0
    mask = am.reshape(FB, 1, S)
    for causal in (False, True):
        out, lse = FA._flash_fwd(q, k, v, mask, D ** -0.5, causal, block_q, block_k, FH)
        ref, ref_lse = FA.flash_attention_plain(q, k, v, mask, D ** -0.5, causal, block_q,
                                                block_k)
        torch.cuda.synchronize()
        torch.testing.assert_close(out.float(), ref.float(), rtol=2.0 ** -7, atol=1e-3)
        torch.testing.assert_close(lse, ref_lse, rtol=1e-5, atol=1e-5)
        if causal:
            # batch 1, head 0, row 5 sees no key: the V average over the
            # keys its query block visits (below 64 for 32/64 and 64/32)
            hz = (((5 // block_q) + 1) * block_q - 1) // block_k * block_k + block_k
            want = v[FH, :hz].float().mean(0)
            torch.testing.assert_close(out[FH, 5].float(), want, rtol=2.0 ** -7, atol=1e-3)


@pytest.mark.cuda
def test_flash_attention_backward_on_card_matches_cpu(card):
    """One backward through the autograd Function on the card (kernel
    forward, blockwise f32 backward) against the same Function on CPU copies
    (plain forward)."""
    g = torch.Generator().manual_seed(1)
    x = [torch.randn((FB, FS, FH, 64), generator=g) for _ in range(4)]
    am = torch.ones((FB, FS))
    am[1, :40] = 0

    def run(dev):
        q, k, v = (t.to(dev).requires_grad_() for t in x[:3])
        out = FA.flash_attention(q, k, v, causal=True, block_q=32, block_k=32,
                                 kv_mask=am.to(dev))
        (out * x[3].to(dev)).sum().backward()
        return [t.detach().cpu() for t in (out, q.grad, k.grad, v.grad)]

    before = FA.flash_attention.launches
    got = run(card)
    torch.cuda.synchronize()
    assert FA.flash_attention.launches == before + 1
    for a, b in zip(got, run("cpu")):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


# ------------------------------------------------------- the engine on the card
#
# The serving engine's loops on the card at a tiny config: the pipelined loop
# uploads from pinned buffers and reads back without blocking, and the
# speculative loops run the paged kernel at K = 5.  Same dispatch shapes, same
# kernels: pipelined and sync give the same bytes on the card too.

ENGINE_CFG = M.DecoderConfig(vocab_size=13, d_model=256, n_layers=2, n_heads=4,
                             n_kv_heads=1, d_ff=512)
ENGINE_PROMPTS = [list(range(1, 13)), [1, 2, 3, 4] * 4, [5, 9, 2], [7] * 20]


def _engine_run(card, **kw):
    from kubeflow_tpu_torch.serving.engine.engine import Engine, EngineConfig

    params = M.init(ENGINE_CFG, card, seed=0)
    ec = EngineConfig(max_slots=4, num_pages=64, page_size=16, max_pages_per_slot=8, **kw)
    eng = Engine(params, ENGINE_CFG, ec, device=card)
    futs = [eng.generate_async(p, 40) for p in ENGINE_PROMPTS]
    before = dict(PA.paged_attention.launches_by_k)
    eng.start()
    try:
        out = [f.result(timeout=300)["tokens"] for f in futs]
        stats = eng.stats
    finally:
        eng.stop()
    launched = {k: v - before.get(k, 0) for k, v in PA.paged_attention.launches_by_k.items()}
    assert stats["free_pages"] + stats["cached_pages"] == ec.num_pages - 1
    return out, stats, launched, params


@pytest.mark.cuda
def test_engine_pipelined_matches_sync_on_card(card):
    sync, _, _, _ = _engine_run(card, pipeline_depth=0)
    pipe, stats, launched, _ = _engine_run(card, pipeline_depth=1)
    assert pipe == sync
    assert stats["pipeline_depth"] == 1 and launched.get(1, 0) > 0


@pytest.mark.cuda
def test_engine_speculative_on_card(card):
    """Sync and pipelined speculative give the same bytes, the verify passes
    launch the kernel at K = 5, and every token passes the tie-aware greedy
    oracle (``forward_full`` on the card; the K-row verify runs its GEMMs at
    another M than the plain step, so a near tie may flip against it)."""
    kw = dict(speculative="prompt_lookup", spec_ngram=1, spec_max_draft=4)
    sync, s0, _, _ = _engine_run(card, pipeline_depth=0, **kw)
    pipe, s1, launched, params = _engine_run(card, pipeline_depth=1, **kw)
    assert pipe == sync
    assert s1["spec_accepted"] == s0["spec_accepted"] > 0
    assert launched.get(5, 0) > 0
    for p, got in zip(ENGINE_PROMPTS, pipe):
        with torch.inference_mode():
            logits = M.forward_full(params, ENGINE_CFG, torch.tensor(
                [p + got[:-1]], device=card))[0, len(p) - 1:]
        picked = logits[torch.arange(len(got), device=card), torch.tensor(got, device=card)]
        assert float((logits.max(-1).values - picked).max()) <= 5e-2
