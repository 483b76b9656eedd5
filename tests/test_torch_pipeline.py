"""Port parity: the pipelined decode loop of kubeflow_tpu_torch's engine.

The port's ``pipeline_depth=1`` (its default, as in the JAX engine) must give
byte-identical greedy tokens to its ``pipeline_depth=0`` sync loop on the CPU
(the reference's own contract, tests/test_decode_pipeline.py), through
mid-stream admits, page crossings, EOS behind a dispatch, pool exhaustion
and a NaN row; and it must pass the JAX package's tie-aware greedy oracle
against the JAX engine at its defaults, on the same weights.  Every run
ends with zero leaked pages (``free + cached == num_pages - 1``).

Requests are queued before ``start()``, so the first tick admits a fixed
set and the rest join as slots free: the admission schedule, and so every
prefill's batch shape, is the same in both modes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.serving.engine import Engine as JEngine
from kubeflow_tpu.serving.engine import EngineConfig as JEngineConfig
from kubeflow_tpu.serving.engine import model as JM
from kubeflow_tpu_torch.serving.engine import engine as E
from kubeflow_tpu_torch.serving.engine import model as TM
from kubeflow_tpu_torch.serving.errors import EngineError, NonFiniteLogits

CFG_J = JM.DecoderConfig(vocab_size=101, d_model=64, n_layers=2, n_heads=4,
                         n_kv_heads=2, d_ff=128)
CFG_T = TM.DecoderConfig(**{f: getattr(CFG_J, f) for f in TM.DecoderConfig.__dataclass_fields__})
PROMPTS = [[(i * 13 + j * 7) % (CFG_J.vocab_size - 1) + 1 for j in range(4 + i % 3)]
           for i in range(6)]
# unequal lengths: slots finish at different steps and the two queued
# requests join mid-stream
N_TOKENS = [12, 20, 8, 16, 12, 10]
ORACLE_LEN = 64
TIE_EPS = 5e-2      # cross-framework bf16 logit tolerance (test_torch_model.py)
STABLE_GAP = 0.07   # a greedy trajectory with every top-2 gap above this is tie-stable


@pytest.fixture(scope="module")
def params():
    jp = JM.init(jax.random.PRNGKey(0), CFG_J)
    return jp, TM.params_from_jax({k: np.asarray(v) for k, v in jp.items()}, "cpu")


def _ec(**kw):
    base = dict(max_slots=4, num_pages=128, page_size=8, max_pages_per_slot=16)
    base.update(kw)
    return E.EngineConfig(**base)


def _no_leak(stats, num_pages=128):
    return stats["active_slots"] == 0 and (
        stats["free_pages"] + stats["cached_pages"] == num_pages - 1)


def _run(tp, ec, prompts=PROMPTS, n_tokens=N_TOKENS, engine_hook=None):
    """Queue every request, start, collect (tokens-or-error list, results,
    stats)."""
    eng = E.Engine(tp, CFG_T, ec, device="cpu")
    if engine_hook is not None:
        engine_hook(eng)
    futs = [eng.generate_async(p, n) for p, n in zip(prompts, n_tokens)]
    eng.start()
    try:
        out, res = [], []
        for f in futs:
            try:
                r = f.result(timeout=120)
                out.append(r["tokens"])
                res.append(r)
            except EngineError as e:
                out.append(e)
                res.append(None)
        return out, res, eng.stats
    finally:
        eng.stop()


def oracle_logits(jp, toks):
    padded = np.zeros((1, ORACLE_LEN), np.int32)
    padded[0, :len(toks)] = toks
    return np.asarray(JM.forward_full(jp, CFG_J, jnp.asarray(padded)))[0, :len(toks)]


def assert_greedy_equivalent(jp, prompt, got, tie_eps=TIE_EPS):
    """Each emitted token's JAX forward_full logit lies within tie_eps of
    the max along the engine's own trajectory."""
    logits = oracle_logits(jp, list(prompt) + list(got))
    for i, g in enumerate(got):
        row = logits[len(prompt) - 1 + i]
        assert float(row[g]) >= float(row.max()) - tie_eps, (i, g, int(row.argmax()))


def oracle_gap(jp, prompt, got):
    """Smallest top-1/top-2 gap of the oracle along ``got``'s trajectory."""
    logits = oracle_logits(jp, list(prompt) + list(got))
    rows = logits[len(prompt) - 1:len(prompt) - 1 + len(got)]
    top2 = np.sort(rows, axis=-1)[:, -2:]
    return float((top2[:, 1] - top2[:, 0]).min())


def test_config_defaults_and_validation(params):
    _, tp = params
    ec = E.EngineConfig()
    assert ec.pipeline_depth == 1 and ec.speculative is None
    assert (ec.spec_max_draft, ec.spec_ngram) == (4, 2)
    for bad, match in ((dict(pipeline_depth=2), "pipeline_depth"),
                       (dict(speculative="medusa"), "speculative"),
                       (dict(speculative="prompt_lookup", temperature=0.5), "temperature"),
                       (dict(speculative="prompt_lookup", spec_max_draft=0), "spec_max_draft")):
        with pytest.raises(ValueError, match=match):
            E.Engine(tp, CFG_T, _ec(**bad), device="cpu")


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "gather"])
def test_pipelined_matches_sync_through_staggered_admits(params, paged):
    """6 requests over 4 slots: admits and finishes fence the pipeline
    mid-stream, and every output is byte-identical to the sync loop."""
    _, tp = params
    sync, _, s0 = _run(tp, _ec(pipeline_depth=0, paged_kernel=paged))
    pipe, res, s1 = _run(tp, _ec(pipeline_depth=1, paged_kernel=paged))
    assert pipe == sync
    assert [len(t) for t in pipe] == N_TOKENS and not any(r["truncated"] for r in res)
    assert s0["pipeline_depth"] == 0 and s0["pipeline_fences"] == 0
    assert s1["pipeline_depth"] == 1
    # a finish fences before the queued request's admission dirties the
    # roster again, so that fence carries the first cause
    assert s1["pipeline_fence_reasons"].get("finish", 0) >= 2
    # a pipelined step per generated token after the first, give or take
    # the one extra step a row runs behind each finish
    assert s1["decode_steps"] >= max(N_TOKENS) - 1
    assert _no_leak(s0) and _no_leak(s1)


def test_long_generation_crosses_pages(params):
    """One request generating 40 tokens past a 4-token prompt crosses five
    8-token pages: the lookahead must reserve each page before the dispatch
    that writes into it."""
    _, tp = params
    sync, _, _ = _run(tp, _ec(pipeline_depth=0, max_slots=1), [PROMPTS[0]], [40])
    pipe, _, s1 = _run(tp, _ec(pipeline_depth=1, max_slots=1), [PROMPTS[0]], [40])
    assert pipe == sync and len(pipe[0]) == 40
    assert _no_leak(s1)


def test_eos_finish_mid_pipeline(params):
    """A row stopping on EOS finishes at the commit-behind while the next
    tick already ran one extra step for it: outputs match the sync loop."""
    _, tp = params
    base, _, _ = _run(tp, _ec(pipeline_depth=0, max_slots=1), [PROMPTS[1]], [16])
    eos = base[0][7]
    sync, _, _ = _run(tp, _ec(pipeline_depth=0, max_slots=1, eos_ids=(eos,)),
                      [PROMPTS[1]], [16])
    pipe, _, s1 = _run(tp, _ec(pipeline_depth=1, max_slots=1, eos_ids=(eos,)),
                       [PROMPTS[1]], [16])
    assert pipe == sync
    assert pipe[0][-1] == eos and len(pipe[0]) <= 8
    assert _no_leak(s1)


def test_pool_exhaustion_truncates_like_sync(params):
    """When the lookahead cannot cover a dispatch, the tick falls back to
    the sync path, whose commit-time OOM truncates: tokens and truncated
    flags match pipeline_depth=0 exactly."""
    _, tp = params
    kw = dict(max_slots=2, num_pages=8, page_size=8, max_pages_per_slot=8)
    _, r0, _ = _run(tp, _ec(pipeline_depth=0, **kw), PROMPTS[:2], [48, 48])
    _, r1, s1 = _run(tp, _ec(pipeline_depth=1, **kw), PROMPTS[:2], [48, 48])
    sync = [(r["tokens"], r["truncated"]) for r in r0]
    pipe = [(r["tokens"], r["truncated"]) for r in r1]
    assert pipe == sync
    assert any(trunc for _, trunc in pipe)  # the pool really ran dry
    assert s1["pipeline_fence_reasons"].get("pool", 0) >= 1
    assert _no_leak(s1, num_pages=8)


def test_nan_row_fails_only_victim_at_fence(params, monkeypatch):
    """NaN logits injected into one request's row of a pipelined decode step
    are caught at the commit-behind: only that request fails (typed
    NonFiniteLogits), every other one is byte-identical to a clean run, the
    fence is counted as "nan", and no page leaks."""
    _, tp = params
    clean, _, _ = _run(tp, _ec())
    victim, calls = 2, [0]
    real = E.decode_step_sample

    def poisoned(*args, **kw):
        eng = state["eng"]
        slot = next((s for s, r in eng._slot_req.items() if r == victim), None)
        calls[0] += 1
        if slot is not None and calls[0] > 3:
            poison = torch.zeros(eng.ec.max_slots, dtype=torch.bool)
            poison[slot] = True
            args = args[:8] + (poison,) + args[9:]
        return real(*args, **kw)

    state = {}
    monkeypatch.setattr(E, "decode_step_sample", poisoned)
    got, _, stats = _run(tp, _ec(), engine_hook=lambda eng: state.update(eng=eng))
    for i, (want, have) in enumerate(zip(clean, got)):
        if i == victim:
            assert isinstance(have, NonFiniteLogits), have
        else:
            assert have == want, i
    assert stats["nan_rows"] == 1 and stats["requests_failed"] == 1
    assert stats["pipeline_fence_reasons"].get("nan", 0) >= 1
    assert _no_leak(stats)


def test_matches_jax_engine_at_its_defaults(params):
    """The port at its defaults (pipelined, prefix cache, paged kernel's
    plain version) against the JAX engine at its defaults (pipelined,
    prefix cache, gather path) on the same weights: every port token passes
    the tie-aware oracle, and tie-stable trajectories agree byte for byte."""
    jp, tp = params
    geo = dict(max_slots=4, num_pages=128, page_size=8, max_pages_per_slot=16)
    port, _, stats = _run(tp, E.EngineConfig(**geo))
    jeng = JEngine(jp, CFG_J, JEngineConfig(**geo))
    futs = [jeng.generate_async(p, n) for p, n in zip(PROMPTS, N_TOKENS)]
    jeng.start()
    try:
        ref = [f.result(timeout=120)["tokens"] for f in futs]
        jstats = jeng.stats
    finally:
        jeng.stop()
    assert jstats["pipeline_depth"] == stats["pipeline_depth"] == 1
    stable = 0
    for p, mine, theirs in zip(PROMPTS, port, ref):
        assert len(mine) == len(theirs)
        assert_greedy_equivalent(jp, p, mine)
        if oracle_gap(jp, p, theirs) > STABLE_GAP:
            stable += 1
            assert mine == theirs
    assert stable >= 2, "too few tie-stable prompts to compare bytes"
    assert _no_leak(stats)
