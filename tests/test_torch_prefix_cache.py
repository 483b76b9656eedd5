"""Port parity: the prefix cache of kubeflow_tpu_torch's engine.

The port submits each prompt with the chain hashes of its full pages and
releases a finished prompt's pages into the C++ core's prefix cache, as the
JAX engine does.  The hashes must be the JAX engine's bit for bit; a repeated
prompt must adopt its cached pages and resume prefill past them with the
same cache accounting as the JAX engine; shared prefixes are adopted by
concurrent requests; under pool pressure the cache evicts; and the tokens
of every cache-resumed request pass the JAX package's tie-aware greedy
oracle (a cache-resumed prefill runs another graph than a cold one, so a
near tie may legally flip).  Zero leaked pages throughout
(``free + cached == num_pages - 1``)."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kubeflow_tpu.serving.engine import Engine as JEngine
from kubeflow_tpu.serving.engine import EngineConfig as JEngineConfig
from kubeflow_tpu.serving.engine import model as JM
from kubeflow_tpu_torch.serving.engine import engine as E
from kubeflow_tpu_torch.serving.engine import model as TM

CFG_J = JM.DecoderConfig(vocab_size=101, d_model=64, n_layers=2, n_heads=4,
                         n_kv_heads=2, d_ff=128)
CFG_T = TM.DecoderConfig(**{f: getattr(CFG_J, f) for f in TM.DecoderConfig.__dataclass_fields__})
PS = 8
ORACLE_LEN = 96
TIE_EPS = 5e-2
STABLE_GAP = 0.07


@pytest.fixture(scope="module")
def params():
    jp = JM.init(jax.random.PRNGKey(0), CFG_J)
    return jp, TM.params_from_jax({k: np.asarray(v) for k, v in jp.items()}, "cpu")


def _prompt(seed, n):
    return [int(t) for t in np.random.default_rng(seed).integers(1, CFG_J.vocab_size, n)]


def _no_leak(stats, num_pages):
    return stats["active_slots"] == 0 and (
        stats["free_pages"] + stats["cached_pages"] == num_pages - 1)


def _oracle_rows(jp, prompt, got):
    toks = list(prompt) + list(got)
    padded = np.zeros((1, ORACLE_LEN), np.int32)
    padded[0, :len(toks)] = toks
    logits = np.asarray(JM.forward_full(jp, CFG_J, jnp.asarray(padded)))[0]
    return logits[len(prompt) - 1:len(prompt) - 1 + len(got)]


def assert_oracle(jp, prompt, got, ref=None):
    """Tie-aware against forward_full; with ``ref`` (tokens of another run),
    also byte-identical up to ref's first near tie."""
    rows = _oracle_rows(jp, prompt, got)
    for i, g in enumerate(got):
        assert rows[i, g] >= rows[i].max() - TIE_EPS, (i, g, int(rows[i].argmax()))
    if ref is not None:
        top2 = np.sort(_oracle_rows(jp, prompt, ref), axis=-1)[:, -2:]
        near = np.flatnonzero(top2[:, 1] - top2[:, 0] <= STABLE_GAP)
        n = int(near[0]) if near.size else len(ref)
        assert list(got[:n]) == list(ref[:n])


@pytest.mark.parametrize("page_size", [8, 32])
def test_page_hashes_bit_identical_to_jax(page_size):
    """The port's chain hashes are the JAX engine's ``_page_hashes`` bit for
    bit (empty, partial-page, page-aligned and Llama-3-vocabulary prompts)."""
    rng = np.random.default_rng(0)
    jax_engine = types.SimpleNamespace(ec=types.SimpleNamespace(page_size=page_size))
    for toks in ([], [5] * 7, list(range(8)), list(range(17)), [0] * 64,
                 [int(t) for t in rng.integers(0, 128256, 100)],
                 [int(t) for t in rng.integers(0, 128256, 300)]):
        ours = E._page_hashes(toks, page_size)
        ref = JEngine._page_hashes(jax_engine, toks)
        assert ours.dtype == np.uint64 and ours.shape == (len(toks) // page_size,)
        np.testing.assert_array_equal(ours, ref)
        assert (ours != 0).all()  # 0 is the no-parent sentinel


def _sequential(eng, prompts, n_tokens):
    """Generate one prompt at a time; (results, cache stats after each)."""
    out, snaps = [], []
    for p in prompts:
        out.append(eng.generate(p, n_tokens, timeout=120))
        snaps.append({k: eng.stats[k] for k in ("page_hits", "page_misses",
                                                  "cached_pages", "evictions")})
    return out, snaps


def test_repeated_prompt_reuses_pages_like_the_jax_engine(params):
    """A 40-token prompt twice: the second admission adopts the 4 lookup
    pages (one page short of the prompt end), prefill resumes at token 32,
    and the cache counters after each request equal the JAX engine's on the
    same sequence.  Both requests pass the oracle."""
    jp, tp = params
    geo = dict(max_slots=2, num_pages=64, page_size=PS, max_pages_per_slot=16)
    prompt = _prompt(1, 40)
    eng = E.Engine(tp, CFG_T, E.EngineConfig(**geo), device="cpu")
    eng.start()
    try:
        res, snaps = _sequential(eng, [prompt, prompt], 8)
        stats = eng.stats
    finally:
        eng.stop()
    jeng = JEngine(jp, CFG_J, JEngineConfig(**geo))
    jeng.start()
    try:
        jres, jsnaps = _sequential(jeng, [prompt, prompt], 8)
    finally:
        jeng.stop()
    assert snaps == jsnaps
    assert snaps[0]["page_hits"] == 0 and snaps[0]["cached_pages"] == 5
    assert snaps[1]["page_hits"] == 4
    # the second prefill started past the cached pages: a chunk, not a bucket
    assert stats["prefill_batch_hist"] == {1: 2}
    for r, j in zip(res, jres):
        assert r["num_tokens"] == 8 and not r["truncated"]
        assert_oracle(jp, prompt, r["tokens"], ref=j["tokens"])
    assert _no_leak(stats, 64)


def test_concurrent_requests_share_a_cached_prefix(params):
    """A finished request leaves a 3-page prefix in the cache; two requests
    with that prefix and different tails, admitted together, both adopt it
    and decode correctly; nothing leaks once they finish."""
    jp, tp = params
    prefix = _prompt(2, 24)
    a, b, c = (prefix + _prompt(s, 10) for s in (3, 4, 5))
    eng = E.Engine(tp, CFG_T, E.EngineConfig(max_slots=2, num_pages=64, page_size=PS,
                                             max_pages_per_slot=16), device="cpu")
    eng.start()
    try:
        eng.generate(a, 6, timeout=120)
        hits0 = eng.stats["page_hits"]
        futs = [eng.generate_async(p, 6) for p in (b, c)]
        res = [f.result(timeout=120) for f in futs]
        stats = eng.stats
    finally:
        eng.stop()
    assert stats["page_hits"] - hits0 == 6  # 3 shared pages for each
    cold = E.Engine(tp, CFG_T, E.EngineConfig(max_slots=2, num_pages=64, page_size=PS,
                                              max_pages_per_slot=16), device="cpu")
    cold.start()
    try:
        ref = [cold.generate(p, 6, timeout=120)["tokens"] for p in (b, c)]
    finally:
        cold.stop()
    for p, r, want in zip((b, c), res, ref):
        assert_oracle(jp, p, r["tokens"], ref=want)
    assert _no_leak(stats, 64)


def test_cache_evicts_under_pool_pressure(params):
    """15 usable pages, prompts of 5 full pages each: the cache fills after
    two requests and must evict for the third and fourth; every request
    completes untruncated and passes the oracle, and nothing leaks."""
    jp, tp = params
    eng = E.Engine(tp, CFG_T, E.EngineConfig(max_slots=1, num_pages=16, page_size=PS,
                                             max_pages_per_slot=8), device="cpu")
    prompts = [_prompt(10 + i, 40) for i in range(4)]
    eng.start()
    try:
        res, snaps = _sequential(eng, prompts, 8)
        again = eng.generate(prompts[-1], 8, timeout=120)
        stats = eng.stats
    finally:
        eng.stop()
    assert snaps[1]["evictions"] == 0 and snaps[-1]["evictions"] > 0
    assert stats["page_hits"] == 4  # the last prompt, still cached, reused
    for p, r in zip(prompts, res):
        assert r["num_tokens"] == 8 and not r["truncated"]
        assert_oracle(jp, p, r["tokens"])
    assert_oracle(jp, prompts[-1], again["tokens"], ref=res[-1]["tokens"])
    assert _no_leak(stats, 16)
