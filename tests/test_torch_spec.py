"""Port parity: prompt-lookup speculative decoding in kubeflow_tpu_torch's engine.

``speculative="prompt_lookup"`` must be lossless: on the CPU the port's
sync (``pipeline_depth=0``) and pipelined speculative loops give tokens
byte-identical to its plain greedy loop, as the reference's own tests
assert (tests/test_spec_pipeline.py, tests/test_engine.py:885), and the two
speculative loops propose and accept the same drafts.  Against the JAX
engine on the same weights the port passes the tie-aware greedy oracle.

Two configs, as in the reference's tests: ``CFG`` (vocab 101) with an
every-token prompt set so drafts are proposed on every tick, and
``CFG_ACC`` (vocab 13), whose random-weight continuation revisits n-grams
often enough that drafts are really accepted (multi-token commits).  Every
run ends with zero leaked pages."""

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
CFG_ACC_J = JM.DecoderConfig(vocab_size=13, d_model=64, n_layers=2, n_heads=4,
                             n_kv_heads=2, d_ff=128)
ALL_VOCAB = list(range(1, CFG_J.vocab_size))
PROMPTS = [ALL_VOCAB, [7, 3, 9, 5] * 6,
           [(i * 13 + 7) % (CFG_J.vocab_size - 1) + 1 for i in range(9)],
           ALL_VOCAB[40:] + ALL_VOCAB[:40], [2, 4, 6, 8, 10] * 4,
           [(i * 29 + 3) % (CFG_J.vocab_size - 1) + 1 for i in range(6)]]
ACC_PROMPTS = [list(range(1, CFG_ACC_J.vocab_size)), [1, 2, 3, 4] * 4]
ORACLE_LEN = 160
TIE_EPS = 5e-2
STABLE_GAP = 0.07


def _port_cfg(cfg):
    return TM.DecoderConfig(**{f: getattr(cfg, f) for f in TM.DecoderConfig.__dataclass_fields__})


def _params(cfg):
    jp = JM.init(jax.random.PRNGKey(0), cfg)
    return jp, TM.params_from_jax({k: np.asarray(v) for k, v in jp.items()}, "cpu")


@pytest.fixture(scope="module")
def params():
    return _params(CFG_J)


@pytest.fixture(scope="module")
def params_acc():
    return _params(CFG_ACC_J)


def _ec(**kw):
    base = dict(max_slots=4, num_pages=128, page_size=8, max_pages_per_slot=24,
                speculative="prompt_lookup", spec_ngram=1, spec_max_draft=4)
    base.update(kw)
    return E.EngineConfig(**base)


def _no_leak(stats, num_pages=128):
    return stats["active_slots"] == 0 and (
        stats["free_pages"] + stats["cached_pages"] == num_pages - 1)


def _run(tp, cfg, ec, prompts, n_tokens, engine_hook=None):
    """Queue every request, start, collect (tokens-or-error list, stats)."""
    eng = E.Engine(tp, _port_cfg(cfg), ec, device="cpu")
    if engine_hook is not None:
        engine_hook(eng)
    futs = [eng.generate_async(p, n_tokens) for p in prompts]
    eng.start()
    try:
        out = []
        for f in futs:
            try:
                out.append(f.result(timeout=120)["tokens"])
            except EngineError as e:
                out.append(e)
        return out, eng.stats
    finally:
        eng.stop()


def _three_ways(tp, cfg, prompts, n_tokens, **kw):
    plain, _ = _run(tp, cfg, _ec(pipeline_depth=0, speculative=None, **kw), prompts, n_tokens)
    sync, s0 = _run(tp, cfg, _ec(pipeline_depth=0, **kw), prompts, n_tokens)
    pipe, s1 = _run(tp, cfg, _ec(pipeline_depth=1, **kw), prompts, n_tokens)
    return plain, sync, s0, pipe, s1


def test_speculative_matches_plain_greedy_sync_and_pipelined(params):
    """Drafts proposed on every tick: both speculative loops give plain
    greedy's bytes and walk the same draft trajectory."""
    _, tp = params
    plain, sync, s0, pipe, s1 = _three_ways(tp, CFG_J, PROMPTS, 12)
    assert sync == plain   # speculative decoding is lossless
    assert pipe == sync    # the pipeline preserves it
    assert s0["pipeline_fences"] == 0 and s1["pipeline_depth"] == 1
    assert s1["spec_proposed"] == s0["spec_proposed"] > 0
    assert s1["spec_accepted"] == s0["spec_accepted"]
    assert _no_leak(s0) and _no_leak(s1)


def test_accepted_drafts_commit_several_tokens_per_tick(params_acc):
    """On the 13-token vocabulary drafts are accepted: several tokens commit
    per verify pass, fewer decode steps than tokens, still byte-identical."""
    _, tp = params_acc
    plain, sync, s0, pipe, s1 = _three_ways(tp, CFG_ACC_J, ACC_PROMPTS, 40)
    assert sync == plain and pipe == sync
    assert s0["spec_accepted"] > 0
    assert (s1["spec_proposed"], s1["spec_accepted"]) == (s0["spec_proposed"],
                                                          s0["spec_accepted"])
    assert s1["decode_steps"] < 2 * 39  # accepted drafts saved steps
    assert _no_leak(s1)


def test_drafts_across_page_boundaries(params_acc):
    """64 tokens with live drafts cross eight 8-token pages: the verify
    lookahead must own every page a draft row writes into."""
    _, tp = params_acc
    plain, sync, _, pipe, s1 = _three_ways(tp, CFG_ACC_J, ACC_PROMPTS[:1], 64, max_slots=1)
    assert pipe == sync == plain and len(pipe[0]) == 64
    assert s1["spec_accepted"] > 0
    assert _no_leak(s1)


def test_eos_inside_accepted_span(params_acc):
    """An EOS inside an accepted multi-token span ends the commit walk at
    the stop id, discarding the rest of the span, in both loops."""
    _, tp = params_acc
    base, s = _run(tp, CFG_ACC_J, _ec(pipeline_depth=0, max_slots=1), ACC_PROMPTS[:1], 40)
    assert s["spec_accepted"] > 0
    eos = base[0][len(base[0]) // 2]
    plain, sync, _, pipe, s1 = _three_ways(tp, CFG_ACC_J, ACC_PROMPTS[:1], 40,
                                           max_slots=1, eos_ids=(eos,))
    assert pipe == sync == plain
    assert pipe[0][-1] == eos and len(pipe[0]) < 40
    assert _no_leak(s1)


def test_nan_mid_verify_fails_only_victim(params, monkeypatch):
    """NaN logits in one request's row of a pipelined verify (or no-draft)
    pass: its packed row is all -1, the slot fails with NonFiniteLogits at
    a "nan" fence, nothing of the poisoned pass is committed, and the other
    requests are byte-identical to a clean run."""
    _, tp = params
    clean, _ = _run(tp, CFG_J, _ec(pipeline_depth=1), PROMPTS, 12)
    victim, state, calls = 1, {}, [0]

    def poisoning(real, poison_at):
        def call(*args, **kw):
            eng = state["eng"]
            slot = next((s for s, r in eng._slot_req.items() if r == victim), None)
            calls[0] += 1
            if slot is not None and calls[0] > 2:
                poison = torch.zeros(eng.ec.max_slots, dtype=torch.bool)
                poison[slot] = True
                args = args[:poison_at] + (poison,) + args[poison_at + 1:]
            return real(*args, **kw)
        return call

    monkeypatch.setattr(E, "decode_step_verify_sample",
                        poisoning(E.decode_step_verify_sample, 11))
    monkeypatch.setattr(E, "decode_step_sample_packed",
                        poisoning(E.decode_step_sample_packed, 8))
    got, stats = _run(tp, CFG_J, _ec(pipeline_depth=1), PROMPTS, 12,
                      engine_hook=lambda eng: state.update(eng=eng))
    for i, (want, have) in enumerate(zip(clean, got)):
        if i == victim:
            assert isinstance(have, NonFiniteLogits), have
        else:
            assert have == want, i
    assert stats["nan_rows"] == 1
    assert stats["pipeline_fence_reasons"].get("nan", 0) >= 1
    assert _no_leak(stats)


def _oracle_rows(jp, cfg, prompt, got):
    toks = list(prompt) + list(got)
    padded = np.zeros((1, ORACLE_LEN), np.int32)
    padded[0, :len(toks)] = toks
    logits = np.asarray(JM.forward_full(jp, cfg, jnp.asarray(padded)))[0]
    return logits[len(prompt) - 1:len(prompt) - 1 + len(got)]


def test_pipelined_speculative_matches_jax_engine(params):
    """The port's pipelined speculative engine against the JAX engine in
    the same mode (pipelined, prompt lookup, prefix cache) on the same
    weights, drafts proposed on every tick: tie-aware on every token, and
    byte-identical up to the first step of the JAX trajectory whose oracle
    top-2 gap is a near tie."""
    jp, tp = params
    kw = dict(max_slots=4, num_pages=128, page_size=8, max_pages_per_slot=24,
              speculative="prompt_lookup", spec_ngram=1, spec_max_draft=4)
    port, stats = _run(tp, CFG_J, E.EngineConfig(**kw), PROMPTS, 12)
    jeng = JEngine(jp, CFG_J, JEngineConfig(**kw))
    futs = [jeng.generate_async(p, 12) for p in PROMPTS]
    jeng.start()
    try:
        ref = [f.result(timeout=120)["tokens"] for f in futs]
        jstats = jeng.stats
    finally:
        jeng.stop()
    assert jstats["spec_proposed"] > 0 and stats["spec_proposed"] > 0
    compared = 0
    for p, mine, theirs in zip(PROMPTS, port, ref):
        assert len(mine) == len(theirs) == 12
        rows = _oracle_rows(jp, CFG_J, p, mine)
        for i, g in enumerate(mine):
            assert rows[i, g] >= rows[i].max() - TIE_EPS, (i, g)
        top2 = np.sort(_oracle_rows(jp, CFG_J, p, theirs), axis=-1)[:, -2:]
        near = np.flatnonzero(top2[:, 1] - top2[:, 0] <= STABLE_GAP)
        n = int(near[0]) if near.size else len(theirs)
        assert mine[:n] == theirs[:n]
        compared += n
    assert compared >= 24, "too few tie-stable steps to compare bytes"
    assert _no_leak(stats)
