"""Port parity: structured output (``constrain``) and ingress brownout.

- The port's ``serving/constrain.py`` is the JAX package's module apart
  from its header: along seeded random legal walks over a multi-byte token
  table the two give the same masks, acceptance, counters and snapshots for
  a JSON schema, ``{"format": "json"}``, an EBNF grammar and a tool, and the
  same ``compile_spec`` errors; ``token_bytes_from_tokenizer`` maps the
  port's tokenizers as the JAX package maps its own.
- ``decode_step_sample`` and ``decode_step_verify_sample`` with a
  ``token_mask`` stay within 5e-2 of the JAX steps' masked logits, sample
  only legal tokens, and keep the NaN guard on the raw logits.
- A constrained engine's outputs pass the tie-aware oracle of the JAX
  ``forward_full`` under the mask replayed by a fresh automaton, with the
  JAX engine's outcomes, at both pipeline depths and speculative; an
  all-legal grammar leaves the port's tokens byte-identical to its
  unconstrained run; a closed grammar finishes gracefully; drafts are cut
  at the first illegal token; the automaton rides swap and recompute
  preemption; stall chaos fails only its victim with ConstraintStall and a
  ``constraint_stall`` incident.
- The serve layer answers the JAX ``JetStreamModel``'s ``json`` /
  ``tool_call`` fields, stream event, per-instance predict constraints and
  400 messages; a forced tool over OpenAI chat is a ``tool_calls`` message.
- Brownout: stage 2 drops drafts but never the mask (modelled on the green
  reference ``tests/test_constrain.py::test_brownout_stage2_drops_drafts_never_the_mask``,
  checking stage 0 proposes drafts first), stage 3 defers the fabric
  publish as the JAX engine does, and malformed stages are the JAX
  package's 400s."""

import json
import os
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from kubeflow_tpu.serving import constrain as JC
from kubeflow_tpu.serving.engine import Engine as JEngine
from kubeflow_tpu.serving.engine import EngineConfig as JEngineConfig
from kubeflow_tpu.serving.engine import model as JM
from kubeflow_tpu.serving.engine.serve import ByteTokenizer as JByteTokenizer
from kubeflow_tpu.serving.engine.serve import JetStreamModel as JJetStreamModel
from kubeflow_tpu.serving.engine.serve import VocabTokenizer as JVocabTokenizer
from kubeflow_tpu.serving.server import ModelServer as JModelServer
from kubeflow_tpu_torch.serving import constrain as C
from kubeflow_tpu_torch.serving.engine import engine as E
from kubeflow_tpu_torch.serving.engine import model as TM
from kubeflow_tpu_torch.serving.engine.faults import (ConstrainFaultConfig,
                                                      FaultConfig)
from kubeflow_tpu_torch.serving.engine.scheduler import SchedulerConfig
from kubeflow_tpu_torch.serving.engine.serve import (ByteTokenizer, JetStreamModel,
                                                     VocabTokenizer)
from kubeflow_tpu_torch.serving.errors import RequestError
from kubeflow_tpu_torch.serving.server import ModelServer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG_J = JM.DecoderConfig(vocab_size=101, d_model=64, n_layers=2, n_heads=4,
                         n_kv_heads=2, d_ff=128)
CFG_ACC_J = JM.DecoderConfig(vocab_size=13, d_model=64, n_layers=2, n_heads=4,
                             n_kv_heads=2, d_ff=128)
CFG256_J = JM.DecoderConfig(vocab_size=256, d_model=32, n_layers=1, n_heads=2,
                            n_kv_heads=1, d_ff=64)


def _tcfg(cfg):
    return TM.DecoderConfig(**{f: getattr(cfg, f) for f in TM.DecoderConfig.__dataclass_fields__})


CFG_T, CFG_ACC_T, CFG256_T = _tcfg(CFG_J), _tcfg(CFG_ACC_J), _tcfg(CFG256_J)
GEO = dict(max_slots=4, num_pages=128, page_size=8, max_pages_per_slot=16)
LOGIT_TOL = 5e-2
TIE_EPS = 5e-2
STABLE_GAP = 0.07
ORACLE_LEN = 160

# one-byte token tables: token id i <-> the single byte i
TABLE101 = C.TokenTable([bytes([i]) for i in range(101)])
TABLE13 = C.TokenTable([bytes([i]) for i in range(13)])
ALL_LEGAL_101 = r"start ::= [\x00-\x64]* ;"
ALL_LEGAL_13 = r"start ::= [\x00-\x0c]* ;"
AB_C = 'start ::= "ab" ("ab")* "c" ;'
# alternating byte classes: the automaton's state flips every token, so a
# wrong restore after a preemption shows in the tokens
ALTERNATE = r"start ::= ([\x01-\x31] [\x32-\x64])* ;"
ALL_VOCAB = list(range(1, CFG_J.vocab_size))
PROMPTS = [ALL_VOCAB, [7, 3, 9, 5] * 6,
           [(i * 13 + 7) % (CFG_J.vocab_size - 1) + 1 for i in range(9)]]

SCHEMA = {"type": "object",
          "properties": {"color": {"enum": ["red", "green"]},
                         "n": {"type": "integer"}, "ok": {"type": "boolean"}},
          "required": ["color", "n", "ok"]}
SPECS = {"schema": {"schema": SCHEMA}, "json": {"format": "json"},
         "grammar": {"grammar": 'start ::= [a-d]+ ("," [a-d]+)* ;'},
         "tool": {"tool": {"name": "lookup", "parameters": {
             "type": "object", "properties": {"q": {"type": "string"}},
             "required": ["q"]}}}}

_forward = jax.jit(lambda p, t: JM.forward_full(p, CFG_J, t))


@pytest.fixture(scope="module")
def params():
    jp = JM.init(jax.random.PRNGKey(0), CFG_J)
    return jp, TM.params_from_jax({k: np.asarray(v) for k, v in jp.items()}, "cpu")


@pytest.fixture(scope="module")
def params_acc():
    jp = JM.init(jax.random.PRNGKey(0), CFG_ACC_J)
    return jp, TM.params_from_jax({k: np.asarray(v) for k, v in jp.items()}, "cpu")


def _con(text, table=TABLE101):
    return C.GrammarConstraint(C.compile_grammar(text), table)


# -------------------------------------------------------- the module copy


def test_module_is_the_jax_packages_apart_from_its_header():
    def body(path):
        src = open(path).read()
        return src[src.index('"""', 3) + 3:]  # past the module docstring

    assert (body(os.path.join(REPO, "kubeflow_tpu_torch/serving/constrain.py"))
            == body(os.path.join(REPO, "kubeflow_tpu/serving/constrain.py")))


def _multibyte_tokens():
    """A vocabulary like a real tokenizer's: every printable byte, then
    seeded 2-4 byte pieces of JSON-ish text (prefixes of one another
    included)."""
    rng = np.random.default_rng(5)
    alphabet = list(b'abcdeghlnoqrstu0123456789 {}[]":,-.tf')
    toks = [bytes([i]) for i in range(32, 127)] + [b"\n", b""]
    seen = set(toks)
    while len(toks) < 600:
        t = bytes(int(c) for c in rng.choice(alphabet, int(rng.integers(2, 5))))
        if t not in seen:
            seen.add(t)
            toks.append(t)
    return toks


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("kind", sorted(SPECS))
def test_masks_equal_the_jax_modules_along_random_walks(kind, seed):
    toks = _multibyte_tokens()
    g, k, tool = C.compile_spec(SPECS[kind])
    jg, jk, jtool = JC.compile_spec(SPECS[kind])
    assert (k, tool) == (jk, jtool) and g.crc == jg.crc
    c = C.GrammarConstraint(g, C.TokenTable(toks), kind=k, tool_name=tool)
    jc = JC.GrammarConstraint(jg, JC.TokenTable(toks), kind=jk, tool_name=jtool)
    rng = np.random.default_rng(seed)
    steps = 0
    for _ in range(40):
        m, jm = c.token_mask(), jc.token_mask()
        assert np.array_equal(m, jm)
        assert c.accepting() == jc.accepting()
        legal = np.flatnonzero(m)
        if len(legal) == 0:
            break
        t = int(rng.choice(legal))
        assert c.advance(t) and jc.advance(t)
        steps += 1
        assert (c.n_tokens, c.n_bytes) == (jc.n_tokens, jc.n_bytes)
    assert steps >= 3
    assert c.snapshot() == jc.snapshot()
    fresh = JC.GrammarConstraint(jg, JC.TokenTable(toks), kind=jk, tool_name=jtool)
    fresh.restore(c.snapshot())  # a port snapshot restores in the JAX package
    assert fresh.configs == jc.configs


BAD_SPECS = [{}, {"format": "xml"}, {"grammar": AB_C, "format": "json"}, {"mystery": 1},
             {"grammar": 7}, {"schema": []}, {"tool": {"name": "f"}},
             {"tool": {"parameters": {}}}, {"tool": {"name": "f", "parameters": {}, "x": 1}},
             "nope", {"grammar": "start: 'a' ;"}, {"grammar": "start ::= 'a ;"},
             {"grammar": "start ::= nope ;"}, {"grammar": "start ::= [z-a] ;"},
             {"schema": {"type": "object", "additionalProperties": False}},
             {"schema": {"type": "object", "properties": {}, "required": ["ghost"]}}]


@pytest.mark.parametrize("i", range(len(BAD_SPECS)))
def test_compile_spec_errors_equal_the_jax_modules(i):
    with pytest.raises(JC.GrammarError) as ref:
        JC.compile_spec(BAD_SPECS[i])
    with pytest.raises(C.GrammarError) as got:
        C.compile_spec(BAD_SPECS[i])
    assert str(got.value) == str(ref.value)


def test_token_bytes_of_the_ports_tokenizers():
    """``token_bytes_from_tokenizer`` knows the byte tokenizer by its class
    NAME, which the port's class shares; the vocab tokenizer maps through
    its ``inv`` table.  Both equal the JAX package's on its own classes."""
    assert type(ByteTokenizer()).__name__ == "ByteTokenizer"
    assert (C.token_bytes_from_tokenizer(ByteTokenizer())
            == JC.token_bytes_from_tokenizer(JByteTokenizer())
            == [bytes([i]) for i in range(256)])
    vocab = {"a": 0, "bc": 1, "{": 2, "é": 4}
    assert (C.token_bytes_from_tokenizer(VocabTokenizer(vocab))
            == JC.token_bytes_from_tokenizer(JVocabTokenizer(vocab))
            == [b"a", b"bc", b"{", b"", "é".encode()])
    assert C._vocab_sig(VocabTokenizer(vocab)) == JC._vocab_sig(JVocabTokenizer(vocab))


def test_registry_cache_corruption_recompiles_identically(tmp_path):
    from kubeflow_tpu_torch.serving.engine.faults import ConstrainChaos

    tok = ByteTokenizer()
    cold = C.ConstrainRegistry(cache_dir=str(tmp_path)).table_for(tok)
    chaos = ConstrainChaos(ConstrainFaultConfig(corrupt_cache_on=1))
    reg = C.ConstrainRegistry(cache_dir=str(tmp_path), chaos=chaos)
    table = reg.table_for(tok)
    assert reg.stats()["table_cache_recompiles"] == 1
    assert chaos.stats()["injected_corrupt_reads"] == 1
    assert table.token_bytes == cold.token_bytes and table.crc == cold.crc


# ----------------------------------------------------------- the model


PS, PAGES, K = 8, 16, 5
TABLE = np.array([[3, 5, 0, 0], [7, 8, 0, 0], [0, 0, 0, 0], [9, 10, 0, 0]], np.int32)
LENS = np.array([11, 6, 0, 14], np.int32)


def _t(x):
    return TM.params_from_jax({"x": np.asarray(x)}, "cpu")["x"]


def _pools():
    rng = np.random.default_rng(0)
    shape = (CFG_J.n_layers, PAGES, CFG_J.n_kv_heads, PS, CFG_J.head_dim)
    k0 = rng.standard_normal(shape).astype(ml_dtypes.bfloat16)
    v0 = rng.standard_normal(shape).astype(ml_dtypes.bfloat16)
    return jnp.asarray(k0), jnp.asarray(v0), _t(k0), _t(v0)


def _masks(shape, seed):
    rng = np.random.default_rng(seed)
    m = rng.random(shape) < 0.3
    m[..., 0] |= ~m.any(axis=-1)  # at least one legal token per row
    return m


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "gather"])
def test_decode_step_sample_with_a_token_mask_matches_jax(params, paged):
    jp, tp = params
    mask = _masks((4, CFG_J.vocab_size), 1)
    mask[1] = False  # a fully masked row samples id 0 and is NOT a guard trip
    poison = np.array([False, False, False, True])
    toks = np.array([5, 17, 0, 33], np.int32)
    jk, jv, tk, tv = _pools()
    ref, _, _ = JM.decode_step_sample(jp, CFG_J, jnp.asarray(toks), jnp.asarray(LENS),
                                      jnp.asarray(TABLE), jk, jv, jax.random.PRNGKey(0),
                                      jnp.asarray(poison), token_mask=jnp.asarray(mask))
    logits, _, _ = JM.decode_step(jp, CFG_J, jnp.asarray(toks), jnp.asarray(LENS),
                                  jnp.asarray(TABLE), *_pools()[:2])
    masked = np.where(mask, np.asarray(logits, np.float32), -1e30)
    with torch.inference_mode():
        got, _, _ = TM.decode_step_sample(
            tp, CFG_T, torch.from_numpy(toks), torch.from_numpy(LENS),
            torch.from_numpy(TABLE), tk, tv, poison=torch.from_numpy(poison),
            paged=paged, token_mask=torch.from_numpy(mask))
    got, ref = got.numpy(), np.asarray(ref)
    assert got[3] < 0 and ref[3] < 0  # the poisoned row trips on its raw logits
    assert got[1] == ref[1] == 0      # all -1e30: finite, id 0
    for b in (0, 1):
        assert mask[b, got[b]] or b == 1
        top2 = np.sort(masked[b])[-2:]
        if top2[1] - top2[0] > STABLE_GAP:
            assert got[b] == ref[b]
        assert masked[b, got[b]] >= masked[b].max() - LOGIT_TOL


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "gather"])
def test_decode_step_verify_sample_with_a_token_mask_matches_jax(params, paged):
    jp, tp = params
    prev = np.full((4, K), -1, np.int32)
    prev[:, 0] = [5, 17, 0, 33]
    drafts = np.array([[3, 4, 5, 6], [8, 8, 8, 8], [0, 0, 0, 0], [1, 2, 3, 4]], np.int32)
    dlen = np.array([4, 2, 0, 3], np.int32)
    mask = _masks((4, K, CFG_J.vocab_size), 2)
    jk, jv, tk, tv = _pools()
    ref, _, _ = JM.decode_step_verify_sample(
        jp, CFG_J, jnp.asarray(prev), jnp.asarray(drafts), jnp.asarray(dlen),
        jnp.asarray(LENS), jnp.asarray(TABLE), jk, jv, jax.random.PRNGKey(0),
        token_mask=jnp.asarray(mask))
    toks = np.concatenate([prev[:, :1], drafts], axis=1)
    logits, _, _ = JM.decode_step_k(jp, CFG_J, jnp.asarray(toks), jnp.asarray(LENS),
                                    jnp.asarray(TABLE), *_pools()[:2])
    masked = np.where(mask, np.asarray(logits, np.float32), -1e30)
    with torch.inference_mode():
        got, _, _ = TM.decode_step_verify_sample(
            tp, CFG_T, torch.from_numpy(prev), torch.from_numpy(drafts),
            torch.from_numpy(dlen), torch.from_numpy(LENS), torch.from_numpy(TABLE),
            tk, tv, paged=paged, token_mask=torch.from_numpy(mask))
    got, ref = got.numpy(), np.asarray(ref)
    for b in (0, 1, 3):
        n = int((got[b] >= 0).sum())
        for j in range(n):
            assert mask[b, j, got[b, j]], (b, j)
            assert masked[b, j, got[b, j]] >= masked[b, j].max() - LOGIT_TOL
        top2 = np.sort(masked[b], axis=-1)[:, -2:]
        if (top2[:, 1] - top2[:, 0] > STABLE_GAP).all():
            assert np.array_equal(got[b], ref[b])


# ----------------------------------------------------------- the engine


def _run(pkg, params, cfg, ec_kw, prompts, make_con=None, n=10, brownout=0):
    if pkg == "port":
        eng = E.Engine(params[1], _tcfg(cfg), E.EngineConfig(**ec_kw), device="cpu")
    else:
        eng = JEngine(params[0], cfg, JEngineConfig(**ec_kw))
    try:
        # every request is queued before the loop starts, so both packages'
        # engines tick the same schedule (and count the same mask builds)
        futs = [eng.generate_async(p, n, brownout=brownout,
                                   constrain=make_con() if make_con else None)
                for p in prompts]
        eng.start()
        out = []
        for f in futs:
            try:
                out.append(f.result(timeout=180))
            except Exception as e:  # noqa: BLE001 — chaos arms expect stalls
                out.append(e)
        return out, eng.stats
    finally:
        eng.stop()


def _jcon(text, table=None):
    table = table or JC.TokenTable([bytes([i]) for i in range(101)])
    return JC.GrammarConstraint(JC.compile_grammar(text), table)


def _masked_rows(jp, grammar, prompt, got):
    """The JAX oracle's logits along the engine's trajectory, masked by a
    FRESH automaton replayed over the emitted tokens."""
    toks = list(prompt) + list(got)
    padded = np.zeros((1, ORACLE_LEN), np.int32)
    padded[0, :len(toks)] = toks
    rows = np.asarray(_forward(jp, padded))[0, len(prompt) - 1:len(toks) - 1].copy()
    c = _con(grammar)
    for i, g in enumerate(got):
        m = c.token_mask()
        assert m[g], f"token {g} at step {i} is illegal under the grammar"
        rows[i] = np.where(m, rows[i], -1e30)
        assert c.advance(g)
    return rows, c


SPEC_EC = dict(speculative="prompt_lookup", spec_ngram=1, spec_max_draft=4)


@pytest.mark.parametrize("mode", ["pipelined", "sync", "speculative"])
def test_constrained_engine_matches_the_jax_engine(params, mode):
    ec = {**GEO, "pipeline_depth": 0 if mode == "sync" else 1,
          **(SPEC_EC if mode == "speculative" else {})}
    prompts = PROMPTS + [[4, 4, 8] * 3]
    got, st = _run("port", params, CFG_J, ec, prompts, lambda: _con(AB_C), n=8)
    ref, _ = _run("jax", params, CFG_J, ec, prompts, lambda: _jcon(AB_C), n=8)
    assert st["constrained_requests"] == len(prompts) and st["constraint_stalls"] == 0
    assert st["free_pages"] + st["cached_pages"] == GEO["num_pages"] - 1
    compared = 0
    for p, g, r in zip(prompts, got, ref):
        rows, c = _masked_rows(params[0], AB_C, p, g["tokens"])
        for i, t in enumerate(g["tokens"]):
            assert rows[i, t] >= rows[i].max() - TIE_EPS, (p, i, t)
        assert g["constrain"] == {"kind": "grammar",
                                  "outcome": "valid" if c.accepting() else "truncated",
                                  "n_tokens": len(g["tokens"]),
                                  "n_bytes": len(g["tokens"])}
        rrows, _ = _masked_rows(params[0], AB_C, p, r["tokens"])
        top2 = np.sort(rrows, axis=-1)[:, -2:]
        for j in range(min(len(g["tokens"]), len(r["tokens"]))):
            if top2[j, 1] - top2[j, 0] <= STABLE_GAP:
                break
            assert g["tokens"][j] == r["tokens"][j]
            compared += 1
        if g["tokens"] == r["tokens"]:
            assert g["constrain"] == r["constrain"]
    assert compared >= 4


def test_all_legal_grammar_leaves_the_tokens_unchanged(params):
    plain, _ = _run("port", params, CFG_J, {**GEO, "pipeline_depth": 0}, PROMPTS)
    want = [r["tokens"] for r in plain]
    for depth in (0, 1):
        for spec in (False, True):
            ec = {**GEO, "pipeline_depth": depth, **(SPEC_EC if spec else {})}
            got, st = _run("port", params, CFG_J, ec, PROMPTS, lambda: _con(ALL_LEGAL_101))
            assert [r["tokens"] for r in got] == want, (depth, spec)
            assert all(r["constrain"]["outcome"] == "valid" for r in got)
            if depth == 1 and not spec:
                # the "constrain" fence drains the pipeline every tick
                assert st["pipeline_fence_reasons"].get("constrain", 0) > 0


def test_closed_grammar_finishes_gracefully_and_eos_composes(params):
    out, st = _run("port", params, CFG_J, GEO, [[5, 6, 7]],
                   lambda: _con('start ::= "abc" ;'), n=9)
    assert out[0]["tokens"] == [97, 98, 99]
    assert out[0]["constrain"] == {"kind": "grammar", "outcome": "valid",
                                   "n_tokens": 3, "n_bytes": 3}
    assert not out[0]["truncated"] and st["constraint_stalls"] == 0
    out, _ = _run("port", params, CFG_J, {**GEO, "eos_ids": (100,)}, [[5, 6, 7]],
                  lambda: _con('start ::= "abc" ;'), n=9)
    assert out[0]["tokens"] == [97, 98, 99, 100]
    assert out[0]["constrain"]["n_tokens"] == 3


def test_speculative_drafts_are_cut_at_the_first_illegal_token(params_acc):
    prompts = [list(range(1, CFG_ACC_J.vocab_size)), [1, 2, 3, 4] * 4]
    spec = {**GEO, "max_slots": 2, **SPEC_EC}
    plain, _ = _run("port", params_acc, CFG_ACC_J, {**GEO, "max_slots": 2,
                                                     "pipeline_depth": 0}, prompts, n=24)
    got, st = _run("port", params_acc, CFG_ACC_J, spec, prompts,
                   lambda: _con(ALL_LEGAL_13, TABLE13), n=24)
    assert [r["tokens"] for r in got] == [r["tokens"] for r in plain]
    assert st["spec_proposed"] > 0 and st["spec_accepted"] > 0
    forced, _ = _run("port", params_acc, CFG_ACC_J, spec, [prompts[0]],
                     lambda: _con('start ::= "\\x01\\x02\\x03" ;', TABLE13), n=24)
    assert forced[0]["tokens"] == [1, 2, 3]
    # a draft walk on a clone: legal drafts kept, the first illegal one cuts
    eng = E.Engine(params_acc[1], CFG_ACC_T, E.EngineConfig(**spec), device="cpu")
    try:
        pending = E._Pending(tokens=[1], max_new_tokens=4, future=None,
                             constrain=_con(r"start ::= [\x01-\x04]* ;", TABLE13))
        assert eng._legal_draft_prefix(pending, [1, 2, 9, 3]) == [1, 2]
        assert pending.constrain.n_tokens == 0  # the request's own automaton
    finally:
        eng.stop()


@pytest.mark.parametrize("policy", ["swap", "recompute"])
def test_automaton_snapshot_rides_preemption(params, policy):
    calm, _ = _run("port", params, CFG_J, GEO, PROMPTS, lambda: _con(ALTERNATE), n=12)
    storm, st = _run("port", params, CFG_J,
                     {**GEO, "chaos": FaultConfig(preempt_every=5),
                      "scheduler": SchedulerConfig(swap_policy=policy)},
                     PROMPTS, lambda: _con(ALTERNATE), n=12)
    assert st["preemptions"] > 0 and st["preemption_modes"][policy] > 0
    assert [r["tokens"] for r in storm] == [r["tokens"] for r in calm]
    for p, r in zip(PROMPTS, storm):
        _masked_rows(params[0], ALTERNATE, p, r["tokens"])  # every token legal
        assert r["constrain"]["n_tokens"] == 12


def test_forced_stall_fails_only_the_victim_with_an_incident(params):
    ec = E.EngineConfig(**GEO, constrain_chaos=ConstrainFaultConfig(stall_on=1),
                        incidents=True, incident_debounce_s=0.2,
                        incident_resolve_s=0.5, incident_poll_s=0.05)
    eng = E.Engine(params[1], CFG_T, ec, device="cpu")
    eng.start()
    try:
        victim = eng.generate_async([5, 6, 7], 8, constrain=_con(AB_C))
        bystander = eng.generate_async([8, 9, 10], 8)
        with pytest.raises(C.ConstraintStall, match="zero legal tokens"):
            victim.result(timeout=60)
        assert len(bystander.result(timeout=60)["tokens"]) == 8
        st = eng.stats
        assert st["constraint_stalls"] == 1
        assert st["constrain_chaos"]["injected_stalls"] == 1
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and not any(
                i["cause"] == "constraint_stall" for i in eng.incident_list()):
            time.sleep(0.05)
        assert any(i["cause"] == "constraint_stall" for i in eng.incident_list())
        assert st["free_pages"] + st["cached_pages"] == GEO["num_pages"] - 1
    finally:
        eng.stop()


def test_seeded_stall_chaos_leaves_no_invalid_output(params):
    prompts = PROMPTS + [[4, 4, 8] * 3]
    ec = {**GEO, "constrain_chaos": ConstrainFaultConfig(seed=11, stall_every=9)}
    out, st = _run("port", params, CFG_J, ec, prompts, lambda: _con(AB_C), n=8)
    ref, jst = _run("jax", params, CFG_J, ec, prompts, lambda: _jcon(AB_C), n=8)
    failed = [r for r in out if isinstance(r, Exception)]
    assert failed and all(isinstance(e, C.ConstraintStall) for e in failed)
    assert st["constraint_stalls"] == len(failed)
    # the same operations are stalled in both packages
    assert [isinstance(r, Exception) for r in out] == [isinstance(r, Exception) for r in ref]
    assert st["constrain_chaos"] == jst["constrain_chaos"]
    for p, r in zip(prompts, out):
        if not isinstance(r, Exception):
            _masked_rows(params[0], AB_C, p, r["tokens"])


def test_vocab_mismatch_and_waterfall(params):
    eng = E.Engine(params[1], CFG_T, E.EngineConfig(**GEO), device="cpu")
    eng.start()
    try:
        with pytest.raises(RequestError, match="vocab 256, model vocab is 101"):
            eng.generate_async([1, 2], 4, constrain=_con(AB_C, C.TokenTable(
                [bytes([i]) for i in range(256)])))
        r = eng.generate_async([5, 6, 7], 8, constrain=_con(ALL_LEGAL_101)).result(timeout=120)
        wf = eng.waterfall(r["rid"])
        assert "grammar_advance" in {s["name"] for s in wf["segments"]}
        assert sum(s["dur_s"] for s in wf["segments"]) == pytest.approx(wf["wall_s"], abs=1e-6)
        text = eng.telemetry.render()
        assert 'engine_constrained_requests_total{outcome="valid"}' in text
        assert "engine_grammar_mask_seconds_count" in text
    finally:
        eng.stop()


# ------------------------------------------------------------ the serve layer


@pytest.fixture(scope="module")
def models():
    """(port model, JAX model) on the same vocab-256 weights."""
    jp = JM.init(jax.random.PRNGKey(3), CFG256_J)
    tp = TM.params_from_jax({k: np.asarray(v) for k, v in jp.items()}, "cpu")
    geo = dict(max_slots=2, num_pages=64, page_size=8, max_pages_per_slot=16)
    tm = JetStreamModel("llm", engine=E.Engine(tp, CFG256_T, E.EngineConfig(**geo),
                                               device="cpu"))
    jm = JJetStreamModel("llm", "", engine=JEngine(jp, CFG256_J, JEngineConfig(**geo)))
    tm.engine.start()
    jm.engine.start()
    yield tm, jm
    tm.engine.stop()
    jm.engine.stop()


FORCED = {"schema": ({"schema": {"const": "ok"}}, 16),
          "tool": ({"tool": {"name": "lookup", "parameters": {"const": {"q": "hi"}}}}, 24),
          "grammar": ({"grammar": 'start ::= "abc" ;'}, 8)}


@pytest.mark.parametrize("kind", sorted(FORCED))
def test_generate_fields_equal_the_jax_models(models, kind):
    spec, n = FORCED[kind]
    body = {"text_input": "q", "parameters": {"max_tokens": n, "constrain": spec}}
    got, ref = (m.generate(body) for m in models)
    for k in ("text_output", "token_ids", "tokens", "constrain", "json", "tool_call"):
        assert got.get(k) == ref.get(k), k
    assert got["constrain"]["outcome"] == "valid"
    stream = list(models[0].generate_stream(body))
    rstream = list(models[1].generate_stream(body))
    assert [{k: v for k, v in e.items() if k not in ("ttft_s", "latency_s")} for e in stream] \
        == [{k: v for k, v in e.items() if k not in ("ttft_s", "latency_s")} for e in rstream]


STRUCTURED = [{"kind": "schema", "outcome": "valid"}, {"kind": "json", "outcome": "truncated"},
              {"kind": "tool", "outcome": "valid", "tool": "f"}, {"kind": "grammar",
                                                                  "outcome": "valid"},
              None]
TEXTS = ['{"a": 1}', "[1, 2", "not json", '"ok"']


@pytest.mark.parametrize("i", range(len(STRUCTURED)))
def test_structured_fields_equal_the_jax_models(i):
    for text in TEXTS:
        assert (JetStreamModel._structured_fields(STRUCTURED[i], text)
                == JJetStreamModel._structured_fields(STRUCTURED[i], text))


def test_predict_per_instance_constraints_and_refusals(models):
    tm, jm = models
    body = {"instances": [{"prompt": "q", "max_tokens": 16,
                           "constrain": {"schema": {"const": "ok"}}},
                          {"prompt": "r", "max_tokens": 4}]}
    got, ref = tm.predict(body), jm.predict(body)
    assert got[0]["json"] == ref[0]["json"] == "ok"
    assert got[0]["constrain"] == ref[0]["constrain"]
    assert "constrain" not in got[1] and got[1]["tokens"] == 4
    bads = [{"constrain": {"schema": {"const": 1}, "format": "json"}},
            {"constrain": {"grammar": "start: 'a'"}},
            {"constrain": {"format": "json"}, "resume_token_ids": [1, 2, 3]},
            {"constrain": {"format": "json"}, "kv_handoff": True},
            {"brownout": True}, {"brownout": 9}, {"brownout": -1}, {"brownout": "2"}]
    for params in bads:
        body = {"text_input": "q", "parameters": {"max_tokens": 2, **params}}
        msgs = []
        for m in models:
            with pytest.raises(Exception) as e:
                m.generate(body)
            assert type(e.value).__name__ == "RequestError"
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1], params


def test_openai_forced_tool_is_a_tool_calls_message(models):
    tm, jm = models
    tools = [{"type": "function", "function": {"name": "lookup", "parameters": {
        "const": {"q": "hi"}}}}]
    body = {"messages": [{"role": "user", "content": "find it"}], "tools": tools,
            "tool_choice": "required", "max_tokens": 24}
    outs = []
    for cls, m in ((ModelServer, tm), (JModelServer, jm)):
        srv = cls([m], port=0)
        srv.start()
        try:
            req = urllib.request.Request(
                f"http://127.0.0.1:{srv.port}/openai/v1/chat/completions",
                data=json.dumps(body).encode(), headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as r:
                outs.append(json.loads(r.read()))
        finally:
            srv.stop()
    for out in outs:
        ch = out["choices"][0]
        assert ch["finish_reason"] == "tool_calls"
        assert ch["message"]["content"] is None
        fn = ch["message"]["tool_calls"][0]["function"]
        assert fn == {"name": "lookup", "arguments": json.dumps({"q": "hi"})}
    assert outs[0]["usage"] == outs[1]["usage"]


# ------------------------------------------------------------------ brownout


def test_brownout_stage2_drops_drafts_never_the_mask(params_acc):
    ec = {**GEO, "max_slots": 2, **SPEC_EC}
    prompts = [list(range(1, CFG_ACC_J.vocab_size))]
    hot, s_hot = _run("port", params_acc, CFG_ACC_J, ec, prompts,
                      lambda: _con(ALL_LEGAL_13, TABLE13), n=24)
    assert s_hot["spec_proposed"] > 0  # stage 0 drafts: the check is not vacuous
    cool, s_cool = _run("port", params_acc, CFG_ACC_J, ec, prompts,
                        lambda: _con(ALL_LEGAL_13, TABLE13), n=24, brownout=2)
    assert s_cool["spec_proposed"] == 0
    assert cool[0]["tokens"] == hot[0]["tokens"]
    assert cool[0]["constrain"]["outcome"] == "valid"
    # the JAX engine drops its drafts the same way
    _, j_cool = _run("jax", params_acc, CFG_ACC_J, ec, prompts,
                     lambda: JC.GrammarConstraint(JC.compile_grammar(ALL_LEGAL_13),
                                                  JC.TokenTable([bytes([i]) for i in range(13)])),
                     n=24, brownout=2)
    assert j_cool["spec_proposed"] == 0


@pytest.mark.parametrize("stage", [0, 2, 3, 7])
def test_brownout_stage3_defers_the_fabric_publish(params, stage):
    prompt = list(range(1, 40))
    outcomes = []
    for pkg in ("port", "jax"):
        ec = {**GEO, "fabric": True}
        if pkg == "port":
            eng = E.Engine(params[1], CFG_T, E.EngineConfig(**ec), device="cpu")
        else:
            eng = JEngine(params[0], CFG_J, JEngineConfig(**ec))
        eng.start()
        try:
            eng.generate(prompt, 4, brownout=stage)
            outcomes.append(({dict(k)["outcome"]: v
                              for k, v in eng.telemetry.kv_fabric.series().items()},
                             len(eng.fabric_view())))
        finally:
            eng.stop()
    assert outcomes[0] == outcomes[1]
    deferred = stage >= 3  # a stage past 3 is clamped to 3
    assert outcomes[0] == (({"publish_deferred": 1.0} if deferred else {"publish": 1.0}),
                           0 if deferred else 1)


def test_brownout_counted_and_refused_over_http(models):
    tm, _ = models
    srv = ModelServer([tm], port=0)
    srv.start()
    try:
        def post(path, body):
            req = urllib.request.Request(f"http://127.0.0.1:{srv.port}{path}",
                                         data=json.dumps(body).encode(),
                                         headers={"Content-Type": "application/json"})
            try:
                with urllib.request.urlopen(req, timeout=120) as r:
                    return r.status, json.loads(r.read())
            except urllib.error.HTTPError as e:
                return e.code, json.loads(e.read())

        code, _ = post("/v2/models/llm/generate",
                       {"text_input": "q", "parameters": {"max_tokens": 2, "brownout": 2}})
        assert code == 200
        code, _ = post("/v1/models/llm:predict", {"instances": ["q"], "brownout": 1})
        assert code == 200
        code, out = post("/v2/models/llm/generate",
                         {"text_input": "q", "parameters": {"brownout": 9}})
        assert code == 400 and "brownout must be an integer stage in [0, 3]" in out["error"]
        text = tm.metrics_text()
        assert 'engine_brownout_requests_total{stage="2",model="llm"} 1' in text
        assert 'engine_brownout_requests_total{stage="1",model="llm"} 1' in text
    finally:
        srv.stop()
