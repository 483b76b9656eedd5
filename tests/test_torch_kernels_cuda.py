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
import time

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
@pytest.mark.parametrize("K", [1, 5])
@pytest.mark.parametrize("head_dim", [96, 160, 192, 256])
def test_paged_attention_cuda_core_kernel_wide_heads(card, head_dim, K):
    """Head dims outside the tensor-core kernel's (64, 128) take the
    CUDA-core split kernel: hd 192 is the Gemma pipeline's served shape
    (d_model 3072 over 16 heads, 16 kv heads, page 32), 96, 160 and 256
    the widths beside it.  bf16 pools, the plan's own split."""
    heads = 16
    g = torch.Generator().manual_seed(head_dim + K)
    q = torch.randn((len(SEQ_LENS), K, heads, head_dim), generator=g).to(card, torch.bfloat16)
    k_pool, v_pool = (torch.randn((P, heads, ps, head_dim), generator=g).to(card, torch.bfloat16)
                      for _ in range(2))
    table = torch.randint(1, P, (len(SEQ_LENS), MP), generator=g, dtype=torch.int32).to(card)
    lens = torch.tensor(SEQ_LENS, dtype=torch.int32, device=card)
    before = PA.paged_attention.launches
    out = PA.paged_attention(q, k_pool, v_pool, table, lens, ps)
    ref = PA.paged_attention_plain(q, k_pool, v_pool, table, lens, ps)
    torch.cuda.synchronize()
    assert PA.paged_attention.launches == before + 1
    torch.testing.assert_close(out.float(), ref.float(), rtol=2.0 ** -7, atol=1e-3)
    if K == 1:
        assert torch.all(out[1] == 0)  # the idle slot


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


# Swap and sessions on the card: the page snapshot and scatter behind swap preemption
# and sessions move the pools' exact bytes, and a swap-resumed slot decodes
# through the kernel.


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [None, "int8"])
def test_swap_round_trip_on_card_is_bit_exact(card, quant):
    """Device pages -> host blob -> KVPG frame -> host blob -> other device
    pages: the destination pages hold the source pages' bytes exactly."""
    from kubeflow_tpu_torch.serving.engine import kvstore as K
    from kubeflow_tpu_torch.serving.engine.engine import Engine, EngineConfig

    eng = Engine(M.init(ENGINE_CFG, card, seed=0), ENGINE_CFG, EngineConfig(
        max_slots=2, num_pages=16, page_size=16, max_pages_per_slot=8, kv_quant=quant),
        device=card)
    g = torch.Generator(device=card).manual_seed(0)
    for pool in (eng.k_pool, eng.v_pool):
        for leaf in (pool.values() if isinstance(pool, dict) else (pool,)):
            if leaf.dtype == torch.int8:
                leaf.copy_(torch.randint(-127, 128, leaf.shape, generator=g, device=card))
            else:
                leaf.copy_(torch.randn(leaf.shape, generator=g, device=card))
    src, dst = [3, 1, 7], [9, 12, 4]
    blob, nbytes = eng._snapshot_pages(src)
    frame, n, _ = K.pack_frame("swap/0", blob, {})
    eng._scatter_pages(dst, K.unpack_frame(frame)[0], 0, len(dst))
    torch.cuda.synchronize()
    assert n == nbytes > 0
    for pool in (eng.k_pool, eng.v_pool):
        for leaf in (pool.values() if isinstance(pool, dict) else (pool,)):
            assert torch.equal(leaf[:, dst].view(torch.uint8), leaf[:, src].view(torch.uint8))
    eng.stop()


@pytest.mark.cuda
def test_swap_resumed_slot_decodes_through_the_kernel(card):
    """A batch request swapped out for an interactive one resumes to its
    uncontended bytes, and its resumed decode steps launch the kernel."""
    from kubeflow_tpu_torch.serving.engine.engine import Engine, EngineConfig
    from kubeflow_tpu_torch.serving.engine.scheduler import SchedulerConfig

    params = M.init(ENGINE_CFG, card, seed=0)
    ec = EngineConfig(max_slots=1, num_pages=64, page_size=16, max_pages_per_slot=8,
                      scheduler=SchedulerConfig(swap_policy="swap"))
    eng = Engine(params, ENGINE_CFG, ec, device=card)
    eng.start()
    try:
        base = eng.generate(ENGINE_PROMPTS[0], 80)["tokens"]
    finally:
        eng.stop()
    eng = Engine(params, ENGINE_CFG, ec, device=card)
    eng.start()
    try:
        hog = eng.generate_async(ENGINE_PROMPTS[0], 80, priority="batch")
        deadline = time.monotonic() + 120
        while eng.stats["decode_steps"] < 10 and time.monotonic() < deadline:
            time.sleep(0.001)
        inter = eng.generate(ENGINE_PROMPTS[2], 8, priority="interactive")
        resumed_at = PA.paged_attention.launches
        rh = hog.result(timeout=300)
        stats = eng.stats
    finally:
        eng.stop()
    assert inter["num_tokens"] == 8 and rh["preemptions"] == 1
    assert rh["tokens"] == base
    assert stats["swapped_in"] == 1 and stats["swap_used_bytes"] == 0
    assert PA.paged_attention.launches > resumed_at


@pytest.mark.cuda
@pytest.mark.parametrize("spec", [False, True], ids=["plain", "speculative"])
def test_streamed_request_matches_unary_on_card(card, spec):
    """A streamed request on a CUDA engine yields, token by token, the ids
    of its unary run on the same engine config, and its decode steps
    launch the kernel (at K = 5 under speculation)."""
    from kubeflow_tpu_torch.serving.engine.engine import Engine, EngineConfig

    params = M.init(ENGINE_CFG, card, seed=0)
    kw = dict(speculative="prompt_lookup", spec_ngram=1) if spec else {}
    ec = EngineConfig(max_slots=4, num_pages=64, page_size=16, max_pages_per_slot=8, **kw)
    runs = []
    for stream in (False, True):
        eng = Engine(params, ENGINE_CFG, ec, device=card)
        eng.start()
        before = dict(PA.paged_attention.launches_by_k)
        try:
            if stream:
                items = list(eng.generate_stream(ENGINE_PROMPTS[1], 40))
                final = items.pop()
                assert items == final["tokens"]
            else:
                items = eng.generate(ENGINE_PROMPTS[1], 40)["tokens"]
        finally:
            eng.stop()
        launched = {k: v - before.get(k, 0) for k, v in PA.paged_attention.launches_by_k.items()}
        runs.append((items, launched))
    (unary, _), (streamed, launched) = runs
    assert streamed == unary and len(streamed) == 40
    assert launched.get(5 if spec else 1, 0) > 0


# Observability and supervision on the card: a TickProfiler capture of the
# served loop holds both device kernels of every paged call (split + merge)
# per layer per decode tick — no record lost at the window's edges — and a
# loop killed mid-decode by chaos is restarted by the watchdog and serves
# again through the kernel.


def _paged_kernel_records(trace_path: str) -> int:
    import json

    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    return sum(1 for e in events
               if e.get("cat") == "kernel" and e.get("ph") == "X"
               and any(m in e.get("name", "") for m in ("paged_split", "paged_merge")))


@pytest.mark.cuda
def test_tick_profiler_captures_every_paged_kernel_record(card, tmp_path):
    from kubeflow_tpu_torch.serving.engine.engine import Engine, EngineConfig

    params = M.init(ENGINE_CFG, card, seed=0)
    ec = EngineConfig(max_slots=4, num_pages=64, page_size=16, max_pages_per_slot=16)
    eng = Engine(params, ENGINE_CFG, ec, device=card)
    futs = [eng.generate_async(p, 200) for p in ENGINE_PROMPTS]
    eng.start()
    try:
        deadline = time.monotonic() + 120
        while ((eng._prefilling or eng._decode_steps < 3)
               and time.monotonic() < deadline):
            time.sleep(0.001)
        d = eng.trace_n_ticks(8, str(tmp_path))
        while eng.profiler_active and time.monotonic() < deadline:
            time.sleep(0.005)
        prof = eng.perf_snapshot()["profiler"]
        first, last = eng._profiler.window
        decode_ticks = sum(1 for r in eng.timeline.snapshot(last=256)
                           if first <= r["tick"] <= last
                           and "decode_dispatch" in r["segments"])
        [f.result(timeout=300) for f in futs]
    finally:
        eng.stop()
    assert prof["last_error"] is None and prof["captures"] == 1
    assert d == str(tmp_path)
    assert decode_ticks == 8
    assert _paged_kernel_records(eng._profiler.last_trace) == 2 * ENGINE_CFG.n_layers * 8


@pytest.mark.cuda
def test_watchdog_restart_serves_again_through_the_kernel(card):
    from kubeflow_tpu_torch.serving.engine.engine import Engine, EngineConfig
    from kubeflow_tpu_torch.serving.engine.faults import FaultConfig
    from kubeflow_tpu_torch.serving.errors import TickFailure

    params = M.init(ENGINE_CFG, card, seed=0)
    geo = dict(max_slots=4, num_pages=64, page_size=16, max_pages_per_slot=8,
               watchdog_interval_s=0.05)
    eng = Engine(params, ENGINE_CFG, EngineConfig(**geo), device=card)
    eng.start()
    try:
        base = eng.generate(ENGINE_PROMPTS[2], 32)["tokens"]
    finally:
        eng.stop()
    eng = Engine(params, ENGINE_CFG, EngineConfig(**geo, chaos=FaultConfig(die_on_tick=8)),
                 device=card)
    futs = [eng.generate_async(p, 100) for p in ENGINE_PROMPTS]
    eng.start()
    try:
        for f in futs:
            with pytest.raises(TickFailure):
                f.result(timeout=300)
        deadline = time.monotonic() + 60
        while eng.health()["restarts"] < 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        before = PA.paged_attention.launches
        after = eng.generate(ENGINE_PROMPTS[2], 32, timeout=300)["tokens"]
        health, stats = eng.health(), eng.stats
    finally:
        eng.stop()
    assert health["state"] == "SERVING" and health["restarts"] == 1
    assert after == base
    assert PA.paged_attention.launches > before
    assert stats["free_pages"] + stats["cached_pages"] == geo["num_pages"] - 1


@pytest.mark.cuda
def test_handoff_decode_replica_decodes_through_the_kernel(card, monkeypatch):
    """Disaggregated on the card: engine A prefills and exports each prompt's
    KV frame (one token), engine B imports it and decodes with no prefill of
    its own, through the kernel (its plain version never called), to the
    unified engine's bytes; a page-boundary prompt included."""
    from kubeflow_tpu_torch.serving.engine.engine import Engine, EngineConfig
    from kubeflow_tpu_torch.serving.engine.kvstore import unpack_frame

    plain_calls = []
    plain = PA.paged_attention_plain
    monkeypatch.setattr(PA, "paged_attention_plain",
                        lambda *a, **kw: plain_calls.append(1) or plain(*a, **kw))
    params = M.init(ENGINE_CFG, card, seed=0)
    geo = dict(max_slots=4, num_pages=64, page_size=16, max_pages_per_slot=8)
    prompts = ENGINE_PROMPTS + [list(range(1, 13)) + [3, 5, 7, 9]]  # 16 = one page
    engines = {role: Engine(params, ENGINE_CFG, EngineConfig(**geo, role=role), device=card)
               for role in ("unified", "prefill", "decode")}
    for eng in engines.values():
        eng.start()
    try:
        a, b = engines["prefill"], engines["decode"]
        for p in prompts:
            ref = engines["unified"].generate(p, 24)["tokens"]
            pre = a.generate(p, 1, handoff=True)
            assert pre["tokens"] == ref[:1]
            blob, header = unpack_frame(a.pull_handoff(pre["handoff"]["handle"]))
            before = PA.paged_attention.launches
            out = b.generate(p + pre["tokens"], 23,
                             kv_import=(blob, header["nbytes"], header["meta"]["resume_len"]))
            assert PA.paged_attention.launches > before
            assert pre["tokens"] + out["tokens"] == ref
        stats = {role: eng.stats for role, eng in engines.items()}
        outcomes = b.telemetry.kv_handoff.series()
    finally:
        for eng in engines.values():
            eng.stop()
    assert stats["decode"]["prefill_dispatches"] == 0
    assert outcomes == {(("outcome", "import"),): len(prompts)}
    assert not plain_calls
    for s in stats.values():
        assert s["free_pages"] + s["cached_pages"] == geo["num_pages"] - 1
        assert s["swap_used_bytes"] == 0


# int8 weights, a LoRA table with mixed adapter ids and a grammar token mask
# ride the fused decode steps on top of the kernel: on the card the paged
# and gather paths of decode_step_sample and decode_step_verify_sample give
# the same tokens, and their logits agree within the 2-layer decode bound
# (5e-2, as chip_smoke.py's decode_tol(2)).

VARIANT_CFG = M.DecoderConfig(vocab_size=512, d_model=256, n_layers=2, n_heads=4,
                              n_kv_heads=1, d_ff=512)
VARIANT_TABLE = [[3, 5, 0, 0], [7, 8, 9, 0], [0, 0, 0, 0], [10, 11, 12, 13]]
VARIANT_LENS = [40, 70, 0, 100]
DECODE_TOL = 5e-2
CLEAR_GAP = 0.1


def _variant_inputs(card, variant):
    """(params, pools, table, lens, extra kwargs) on the card, from seed 0."""
    g = torch.Generator(device=card).manual_seed(0)
    c = VARIANT_CFG
    params = M.init(c, card, seed=0)
    kw = {}
    if variant == "int8":
        params = M.quantize_weights_int8(params)
    if variant == "lora":
        dims = {"wq": (c.d_model, c.n_heads * c.head_dim), "wv": (c.d_model, c.n_kv_heads * c.head_dim),
                "w1": (c.d_model, c.d_ff), "w2": (c.d_ff, c.d_model)}
        table = {}
        for name, (din, dout) in dims.items():
            A = torch.randn((3, c.n_layers, din, 8), generator=g, device=card) * 0.05
            Bm = torch.randn((3, c.n_layers, 8, dout), generator=g, device=card) * 0.05
            A[0] = 0
            Bm[0] = 0
            table[name] = {"A": A.to(torch.bfloat16), "B": Bm.to(torch.bfloat16)}
        kw = {"lora_params": table,
              "adapter_ids": torch.tensor([0, 1, 2, 1], dtype=torch.int32, device=card)}
    shape = (c.n_layers, 16, c.n_kv_heads, 32, c.head_dim)
    pools = [torch.randn(shape, generator=g, device=card).to(torch.bfloat16) for _ in range(2)]
    table = torch.tensor(VARIANT_TABLE, dtype=torch.int32, device=card)
    lens = torch.tensor(VARIANT_LENS, dtype=torch.int32, device=card)
    return params, pools, table, lens, kw, g


def _clear(logits):
    top2 = logits.float().topk(2, dim=-1).values
    return (top2[..., 0] - top2[..., 1]) > CLEAR_GAP


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["int8", "lora", "mask"])
def test_decode_step_sample_paged_vs_gather_on_card(card, variant):
    params, pools, table, lens, kw, g = _variant_inputs(card, variant)
    tokens = torch.tensor([5, 17, 0, 33], dtype=torch.int32, device=card)
    mask = None
    if variant == "mask":
        mask = torch.rand((4, VARIANT_CFG.vocab_size), generator=g, device=card) < 0.3
        mask[:, 0] = True
    out = {}
    with torch.inference_mode():
        for paged in (True, False):
            kp, vp = pools[0].clone(), pools[1].clone()
            logits, _, _ = M.decode_step(params, VARIANT_CFG, tokens, lens, table, kp, vp,
                                         paged=paged, **kw)
            kp, vp = pools[0].clone(), pools[1].clone()
            before = PA.paged_attention.launches
            sampled, _, _ = M.decode_step_sample(params, VARIANT_CFG, tokens, lens, table,
                                                 kp, vp, paged=paged, token_mask=mask, **kw)
            assert (PA.paged_attention.launches > before) == paged
            if mask is not None:
                logits = torch.where(mask, logits, -1e30)
            out[paged] = (logits, sampled)
    (lp, sp), (lg, sg) = out[True], out[False]
    live = [0, 1, 3]
    torch.testing.assert_close(lp[live], lg[live], rtol=DECODE_TOL, atol=DECODE_TOL)
    clear = _clear(lg)
    assert bool(clear[live].any())
    for b in live:
        if clear[b]:
            assert int(sp[b]) == int(sg[b]) == int(lg[b].argmax())
        if mask is not None:
            assert bool(mask[b, int(sp[b])])


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["int8", "lora", "mask"])
def test_decode_step_verify_sample_paged_vs_gather_on_card(card, variant):
    params, pools, table, lens, kw, g = _variant_inputs(card, variant)
    K = 5
    prev = torch.full((4, K), -1, dtype=torch.int32, device=card)
    prev[:, 0] = torch.tensor([5, 17, 0, 33], device=card)
    drafts = torch.randint(0, VARIANT_CFG.vocab_size, (4, K - 1), generator=g, device=card,
                           dtype=torch.int32)
    dlen = torch.tensor([4, 2, 0, 3], dtype=torch.int32, device=card)
    mask = None
    if variant == "mask":
        mask = torch.rand((4, K, VARIANT_CFG.vocab_size), generator=g, device=card) < 0.3
        mask[..., 0] = True
    toks = torch.cat([prev[:, :1], drafts], dim=1)
    out = {}
    with torch.inference_mode():
        for paged in (True, False):
            kp, vp = pools[0].clone(), pools[1].clone()
            logits, _, _ = M.decode_step_k(params, VARIANT_CFG, toks, lens, table, kp, vp,
                                           paged=paged, **kw)
            kp, vp = pools[0].clone(), pools[1].clone()
            before = dict(PA.paged_attention.launches_by_k)
            packed, _, _ = M.decode_step_verify_sample(
                params, VARIANT_CFG, prev, drafts, dlen, lens, table, kp, vp, paged=paged,
                token_mask=mask, **kw)
            assert (PA.paged_attention.launches_by_k.get(K, 0) > before.get(K, 0)) == paged
            if mask is not None:
                logits = torch.where(mask, logits, -1e30)
            out[paged] = (logits, packed)
    (lp, pp), (lg, pg) = out[True], out[False]
    live = [0, 1, 3]
    torch.testing.assert_close(lp[live], lg[live], rtol=DECODE_TOL, atol=DECODE_TOL)
    clear = _clear(lg)
    for b in live:
        if bool(clear[b].all()):
            assert torch.equal(pp[b], pg[b])
        n = int((pp[b] >= 0).sum())
        assert n >= 1
        if mask is not None:
            assert all(bool(mask[b, j, int(pp[b, j])]) for j in range(n))


@pytest.mark.cuda
@pytest.mark.parametrize("spec", [False, True], ids=["plain", "speculative"])
def test_int8_lora_constrained_engine_decodes_through_the_kernel(card, spec, monkeypatch):
    """An engine with int8 weights and a LoRA table serves mixed adapters and
    a constrained request through the kernel (K = 5 on the speculative
    engine), its plain version never called; every constrained token is
    legal, and no page leaks."""
    from kubeflow_tpu_torch.serving.constrain import GrammarConstraint, TokenTable, compile_grammar
    from kubeflow_tpu_torch.serving.engine.engine import Engine, EngineConfig

    plain_calls = []
    plain = PA.paged_attention_plain
    monkeypatch.setattr(PA, "paged_attention_plain",
                        lambda *a, **kw: plain_calls.append(1) or plain(*a, **kw))
    c = ENGINE_CFG
    params = M.init(c, card, seed=0)
    g = torch.Generator(device=card).manual_seed(1)
    dims = {"wq": (c.d_model, c.n_heads * c.head_dim), "w3": (c.d_model, c.d_ff)}
    table = {}
    for name, (din, dout) in dims.items():
        A = torch.randn((2, c.n_layers, din, 4), generator=g, device=card) * 0.05
        Bm = torch.randn((2, c.n_layers, 4, dout), generator=g, device=card) * 0.05
        A[0] = 0
        Bm[0] = 0
        table[name] = {"A": A.to(torch.bfloat16), "B": Bm.to(torch.bfloat16)}
    kw = dict(speculative="prompt_lookup", spec_ngram=1, spec_max_draft=4) if spec else {}
    eng = Engine(params, c, EngineConfig(max_slots=4, num_pages=64, page_size=16,
                                         max_pages_per_slot=8, weight_quant="int8", **kw),
                 device=card, lora=(table, {"t": 1}))
    grammar = compile_grammar(r"start ::= ([\x01-\x06] [\x07-\x0c])* ;")
    con = GrammarConstraint(grammar, TokenTable([bytes([i]) for i in range(13)]))
    futs = [eng.generate_async(p, 24, adapter=a, constrain=k)
            for p, a, k in zip(ENGINE_PROMPTS, [None, "t", "t", None], [None, None, con, None])]
    before = dict(PA.paged_attention.launches_by_k)
    eng.start()
    try:
        outs = [f.result(timeout=300) for f in futs]
        stats = eng.stats
    finally:
        eng.stop()
    launched = {k: v - before.get(k, 0) for k, v in PA.paged_attention.launches_by_k.items()}
    # a speculative engine verifies every tick that has drafts at K = 5
    assert not plain_calls and launched.get(5 if spec else 1, 0) > 0
    toks = outs[2]["tokens"]
    assert outs[2]["constrain"]["n_tokens"] == len(toks) == 24
    assert all((t <= 6) if i % 2 == 0 else (t >= 7) for i, t in enumerate(toks))
    assert stats["free_pages"] + stats["cached_pages"] == 63


# ------------------------------------------------------- tensor-parallel shards
#
# Tensor parallelism splits the KV heads over the shards, so each shard's
# kernel sees Hkv/N heads (Llama-3-8B: 32/8 heads -> 16/4 at TP 2, 8/2 at
# TP 4, 4/1 at TP 8) with the group (Hq/Hkv) unchanged: the grid and the
# split plan change, the rows per block do not.

SHARD_HEADS = [(16, 4), (8, 2), (4, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("K", [1, 5])
@pytest.mark.parametrize("heads", SHARD_HEADS, ids=[f"{h[0]}-{h[1]}" for h in SHARD_HEADS])
def test_paged_attention_kernel_at_per_shard_heads(card, heads, K):
    hq, hkv = heads
    g = torch.Generator().manual_seed(hkv * 10 + K)
    q = torch.randn((len(SPLIT_LENS), K, hq, hd), generator=g).to(card, torch.bfloat16)
    k_pool, v_pool = (torch.randn((SPLIT_P, hkv, ps, hd), generator=g).to(card, torch.bfloat16)
                      for _ in range(2))
    table = torch.randint(1, SPLIT_P, (len(SPLIT_LENS), SPLIT_MP), generator=g,
                          dtype=torch.int32).to(card)
    lens = torch.tensor(SPLIT_LENS, dtype=torch.int32, device=card)
    before = PA.paged_attention.launches
    out = PA.paged_attention(q, k_pool, v_pool, table, lens, ps)
    ref = PA.paged_attention_plain(q, k_pool, v_pool, table, lens, ps)
    torch.cuda.synchronize()
    assert PA.paged_attention.launches == before + 1
    torch.testing.assert_close(out.float(), ref.float(), rtol=2.0 ** -7, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("tp", [2, 4])
def test_paged_attention_mesh_launches_once_per_shard(card, tp):
    """With ``mesh=``, shards on one card each launch the kernel on their
    own heads and pool; the outputs are the unsharded call's head slices."""
    from kubeflow_tpu_torch.serving.engine.sharding import tensor_mesh

    g = torch.Generator().manual_seed(tp)
    hq, hkv = 32, 8
    q = torch.randn((B, 1, hq, hd), generator=g).to(card, torch.bfloat16)
    k_pool, v_pool = (torch.randn((P, hkv, ps, hd), generator=g).to(card, torch.bfloat16)
                      for _ in range(2))
    table = torch.randint(1, P, (B, MP), generator=g, dtype=torch.int32).to(card)
    lens = torch.tensor(SEQ_LENS, dtype=torch.int32, device=card)
    full = PA.paged_attention(q, k_pool, v_pool, table, lens, ps)
    a, b = hq // tp, hkv // tp
    before = PA.paged_attention.launches
    outs = PA.paged_attention(
        [q[:, :, i * a:(i + 1) * a].contiguous() for i in range(tp)],
        [k_pool[:, i * b:(i + 1) * b].contiguous() for i in range(tp)],
        [v_pool[:, i * b:(i + 1) * b].contiguous() for i in range(tp)],
        table, lens, ps, mesh=tensor_mesh(tp, [card] * tp))
    torch.cuda.synchronize()
    assert PA.paged_attention.launches == before + tp
    torch.testing.assert_close(torch.cat(outs, dim=2).float(), full.float(),
                               rtol=2.0 ** -7, atol=1e-3)


@pytest.mark.cuda
def test_engine_tensor_parallel_on_card(card):
    """A two-shard engine on one card gives the TP 1 engine's tokens (or
    parts at a near tie, tie-aware against ``forward_full``), launching the
    kernel twice per layer and decode step."""
    tp_cfg = M.DecoderConfig(vocab_size=13, d_model=256, n_layers=2, n_heads=4,
                             n_kv_heads=2, d_ff=512)
    from kubeflow_tpu_torch.serving.engine.engine import Engine, EngineConfig

    params = M.init(tp_cfg, card, seed=0)
    outs = {}
    for tp in (1, 2):
        ec = EngineConfig(max_slots=4, num_pages=64, page_size=16, max_pages_per_slot=8,
                          tensor_parallel=tp)
        eng = Engine(params, tp_cfg, ec, device=[card] * tp)
        before = PA.paged_attention.launches
        futs = [eng.generate_async(p, 24) for p in ENGINE_PROMPTS]
        eng.start()
        try:
            outs[tp] = [f.result(timeout=300)["tokens"] for f in futs]
            stats = eng.stats
        finally:
            eng.stop()
        assert PA.paged_attention.launches - before == tp * tp_cfg.n_layers * stats["decode_steps"]
        assert stats["free_pages"] + stats["cached_pages"] == 63
    for p, got in zip(ENGINE_PROMPTS, outs[2]):
        with torch.inference_mode():
            logits = M.forward_full(params, tp_cfg, torch.tensor(
                [p + got[:-1]], device=card))[0, len(p) - 1:]
        picked = logits[torch.arange(len(got), device=card), torch.tensor(got, device=card)]
        assert float((logits.max(-1).values - picked).max()) <= 5e-2


# ------------------------------------------------------------------- the mesh

MESH_SIZES = {2: dict(fsdp=2), 4: dict(fsdp=2, tensor=2)}


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 4])
def test_ulysses_flash_inner_matches_dense_on_card(card, n):
    """Ulysses over n shards of the card: the flash kernel once per shard on
    its heads at full length, within one bf16 ulp of the dense inner over
    the same inputs in f32."""
    from kubeflow_tpu_torch.ops.ulysses import ulysses_attention
    from kubeflow_tpu_torch.parallel.mesh import MeshConfig, build_mesh

    FA = importlib.import_module("kubeflow_tpu_torch.ops.flash_attention")
    mesh = build_mesh(MeshConfig(fsdp=1, seq=n), [card] * n)
    g = torch.Generator().manual_seed(n)
    q, k, v = (torch.randn((1, 1024, 8, 64), generator=g).to(card, torch.bfloat16)
               for _ in range(3))
    before = FA.flash_attention.launches
    with torch.no_grad():
        got = ulysses_attention(q, k, v, mesh, causal=True, inner=FA.flash_attention)
        want = ulysses_attention(q.float(), k.float(), v.float(), mesh, causal=True)
    torch.cuda.synchronize()
    assert FA.flash_attention.launches == before + n
    torch.testing.assert_close(got.float(), want, rtol=2.0 ** -7, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("n", sorted(MESH_SIZES))
def test_bert_mesh_step_launches_flash_once_per_shard_and_layer(card, n):
    """One BERT train step on a mesh of n shards of the card: one flash
    launch per layer, batch shard and tensor shard; the plain version never."""
    from kubeflow_tpu_torch.models import bert
    from kubeflow_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    from kubeflow_tpu_torch.train.data import synthetic_mlm_batches
    from kubeflow_tpu_torch.train.trainer import Trainer, TrainerConfig

    FA = importlib.import_module("kubeflow_tpu_torch.ops.flash_attention")
    sizes = MESH_SIZES[n]
    mesh = build_mesh(MeshConfig(**sizes), [card] * n)
    cfg = bert.BertConfig(vocab_size=512, hidden_size=128, num_layers=2, num_heads=4,
                          intermediate_size=256, max_position=128, attention="flash")

    def loss_fn(m, b):
        return bert.mlm_loss(m, cfg, b["input_ids"], b["labels"], b["attention_mask"])

    trainer = Trainer(loss_fn, bert.init(cfg, card, seed=0),
                      TrainerConfig(learning_rate=1e-3, warmup_steps=1, total_steps=4),
                      mesh=mesh, rules=bert.SHARDING_RULES)
    batch = next(synthetic_mlm_batches(cfg.vocab_size, 8, 128, seed=0))
    batch["attention_mask"][1, 100:] = 0
    plain = FA.flash_attention_plain
    calls = []
    FA.flash_attention_plain = lambda *a, **kw: calls.append(1) or plain(*a, **kw)
    try:
        before = FA.flash_attention.launches
        metrics = trainer.train_step(batch)
        launches = FA.flash_attention.launches - before
    finally:
        FA.flash_attention_plain = plain
    shards = sizes.get("data", 1) * sizes.get("fsdp", 1) * sizes.get("tensor", 1)
    assert launches == cfg.num_layers * shards and not calls
    assert torch.isfinite(torch.tensor(metrics["loss"]))


@pytest.mark.cuda
def test_bert_step_across_two_processes_launches_flash_in_each(card):
    """A gang of 2 processes sharing the card (gloo, host-staged), 2 mesh
    positions each of fsdp 2 x tensor 2, one BERT flash step: each member
    launches the kernel once per layer and local position, never the plain
    version, and both report the same loss."""
    from test_torch_mesh_processes import flash_gang_member, run_gang

    gang = run_gang(flash_gang_member, device="cuda", timeout=300)
    for got in gang.values():
        assert got["backend"] == "gloo"
        assert got["launches"] == got["layers"] * got["local"] and got["plain_calls"] == 0
        assert torch.isfinite(torch.tensor(got["loss"]))
    assert gang[0]["loss"] == gang[1]["loss"]


@pytest.mark.cuda
def test_bert_pp_across_two_processes_launches_flash_in_each(card):
    """GPipe across a gang of 2 processes sharing the card, stages 2 x fsdp 2
    (each process one stage, every hand-off across processes): each member
    launches the kernel once per microbatch, layer of its stage and local
    position, never the plain version, and the step holds to the
    one-process pp mesh on the card (loss within 1e-2, norm within 1.22e-2
    relative, as chip_smoke.py's mesh phases)."""
    from test_torch_mesh_processes import flash_pp_gang_member, flash_pp_step, run_gang

    gang = run_gang(flash_pp_gang_member, device="cuda", timeout=300)
    want = flash_pp_step(card, [card] * 4)
    assert want["launches"] == want["per_step"] == 8 and want["plain_calls"] == 0
    for got in gang.values():
        assert got["backend"] == "gloo"
        assert got["launches"] == got["per_step"] == 4 and got["plain_calls"] == 0
        assert abs(got["loss"] - want["loss"]) <= 1e-2
        assert abs(got["grad_norm"] - want["grad_norm"]) <= 1.22e-2 * want["grad_norm"]
    assert gang[0]["loss"] == gang[1]["loss"]


# ------------------------------------------------------------ pipeline (pp)


@pytest.mark.cuda
def test_flash_attention_kernel_at_the_pp_shard_shape(card):
    """BERT-base under GPipe on stages 2 x fsdp 2 (B=32, 4 microbatches):
    each launch is one microbatch's fsdp shard, 4 rows of 12 heads at 512,
    non-causal and with no mask (pp refuses one)."""
    g = torch.Generator().manual_seed(48)
    q, k, v = (torch.randn((4 * 12, 512, 64), generator=g).to(card, torch.bfloat16)
               for _ in range(3))
    args = (q, k, v, None, 64 ** -0.5, False, 128, 128)
    before = FA.flash_attention.launches
    out, lse = FA._flash_fwd(*args, 12)
    ref, ref_lse = FA.flash_attention_plain(*args)
    torch.cuda.synchronize()
    assert FA.flash_attention.launches == before + 1
    torch.testing.assert_close(out.float(), ref.float(), rtol=2.0 ** -7, atol=1e-3)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_bert_pp_step_launches_flash_once_per_microbatch_layer_and_shard(card):
    """One BERT train step under GPipe on the ``pp`` preset's 4 shards of the
    card (stages 2 x fsdp 2): one flash launch per microbatch, layer and
    fsdp shard of its stage (bubble ticks skipped), the plain version
    never; the loss within 1e-2 of the unsharded step's."""
    from kubeflow_tpu_torch.models import bert
    from kubeflow_tpu_torch.parallel.mesh import build_mesh
    from kubeflow_tpu_torch.parallel.presets import get_preset
    from kubeflow_tpu_torch.train.data import synthetic_mlm_batches
    from kubeflow_tpu_torch.train.trainer import Trainer, TrainerConfig

    mesh = build_mesh(get_preset("pp", 4).mesh, [card] * 4)
    base = dict(vocab_size=512, hidden_size=128, num_layers=4, num_heads=4,
                intermediate_size=256, max_position=128, attention="flash")
    cfg = bert.BertConfig(**base, pipeline_stages=2, pipeline_microbatches=4)
    one_cfg = bert.BertConfig(**base)
    tcfg = TrainerConfig(learning_rate=1e-3, warmup_steps=1, total_steps=4)
    batch = next(synthetic_mlm_batches(cfg.vocab_size, 16, 128, seed=0))
    del batch["attention_mask"]
    trainer = Trainer(lambda m, b: bert.mlm_loss(m, cfg, b["input_ids"], b["labels"]),
                      bert.init(one_cfg, card, seed=0), tcfg, mesh=mesh,
                      rules=bert.pp_sharding_rules())
    plain = FA.flash_attention_plain
    calls = []
    FA.flash_attention_plain = lambda *a, **kw: calls.append(1) or plain(*a, **kw)
    try:
        before = FA.flash_attention.launches
        metrics = trainer.train_step(batch)
        launches = FA.flash_attention.launches - before
    finally:
        FA.flash_attention_plain = plain
    assert launches == 4 * cfg.num_layers * 2 and not calls
    one = Trainer(lambda m, b: bert.mlm_loss(m, one_cfg, b["input_ids"], b["labels"]),
                  bert.init(one_cfg, card, seed=0), tcfg, device=card)
    assert abs(metrics["loss"] - one.train_step(batch)["loss"]) <= 1e-2


# ------------------------------------------------------- mesh models (19)


@pytest.mark.cuda
def test_decoder_mesh_trainer_matches_unsharded_on_card(card):
    """Phase 19(a)'s check at a small width: the decoder on fsdp 2 x tensor
    2 shards of the card through ``decoder.SHARDING_RULES`` against the
    unsharded Trainer on the same weights and batches (losses within 1e-2,
    gradient norms within 1.22e-2 relative), each shard holding its rule's
    shard shape and the card each distinct slice once."""
    from kubeflow_tpu_torch.models import decoder
    from kubeflow_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    from kubeflow_tpu_torch.train.trainer import Trainer, TrainerConfig

    cfg = M.DecoderConfig(vocab_size=1024, d_model=256, n_layers=2, n_heads=8, n_kv_heads=2,
                          d_ff=512)
    mesh = build_mesh(MeshConfig(fsdp=2, tensor=2), [card] * 4)
    tcfg = TrainerConfig(learning_rate=1e-4, warmup_steps=2, total_steps=16)
    data = decoder.synthetic_lm_batches(cfg.vocab_size, 4, 128, seed=0)
    batches = [next(data) for _ in range(3)]
    model = decoder.init(cfg, card, seed=0)

    def loss_fn(p, b):
        return decoder.lm_loss(p, cfg, b["tokens"])

    sharded = Trainer(loss_fn, model, tcfg, mesh=mesh, rules=decoder.SHARDING_RULES)
    got = [sharded.train_step(b) for b in batches]
    held = 0
    for st in sharded.params.values():
        shape = st.sharding.shard_shape(tuple(st.shape))
        assert [tuple(t.shape) for t in st.shards] == [shape] * 4
        held += sum(t.numel() for t in st.locals)
    assert held == cfg.param_count()
    assert sharded.params["embed"].split_axes(0) == ("tensor",)
    del sharded
    one = Trainer(loss_fn, model, tcfg, device=card)
    want = [one.train_step(b) for b in batches]
    for g, w in zip(got, want):
        assert abs(g["loss"] - w["loss"]) <= 1e-2, (got, want)
        assert abs(g["grad_norm"] - w["grad_norm"]) <= 1.22e-2 * w["grad_norm"], (got, want)
