"""Port parity: streamed generation (``generate_stream``) in kubeflow_tpu_torch.

The same prompts, on weights carried over from the JAX package, stream
through both packages' ``JetStreamModel.generate_stream`` with the ingress's
``X-Stream-Resume`` header, on the sync loop, the pipelined loop and the
pipelined speculative loop.  The port's streamed token ids pass the tie-aware
oracle (``forward_full``) and equal the JAX stream's up to its first near
tie; wherever the ids agree the text pieces agree too; the concatenated
pieces equal the port's unary ``text_output``; the final record carries the
JAX package's keys.  A client that disconnects mid-stream cancels its
request, and a streamed request that is preempted (swap or recompute)
continues with no duplicated and no dropped token.  No KV page leaks."""

import http.client
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kubeflow_tpu.serving.engine import Engine as JEngine
from kubeflow_tpu.serving.engine import EngineConfig as JEngineConfig
from kubeflow_tpu.serving.engine import model as JM
from kubeflow_tpu.serving.engine.serve import JetStreamModel as JJetStreamModel
from kubeflow_tpu_torch.serving.engine import engine as E
from kubeflow_tpu_torch.serving.engine import model as TM
from kubeflow_tpu_torch.serving.engine.scheduler import SchedulerConfig
from kubeflow_tpu_torch.serving.engine.serve import JetStreamModel
from kubeflow_tpu_torch.serving.server import ModelServer

# byte-level prompts need the 256-id vocabulary
CFG_J = JM.DecoderConfig(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
                         n_kv_heads=2, d_ff=128)
CFG_T = TM.DecoderConfig(**{f: getattr(CFG_J, f) for f in TM.DecoderConfig.__dataclass_fields__})
GEO = dict(max_slots=4, num_pages=96, page_size=8, max_pages_per_slot=24)
ORACLE_LEN = 96
TIE_EPS = 5e-2       # the cross-framework bf16 logit tolerance (test_torch_model.py)
STABLE_GAP = 0.07    # twice the largest cross-framework logit difference
PROMPTS = ["hello world", "The quick brown fox", "kubeflow on an H100",
           "abcabcabcabcabcabc"]
N = 12
RESUME = {"X-Stream-Resume": "1"}
MODES = {"sync": dict(pipeline_depth=0), "pipelined": dict(pipeline_depth=1),
         "spec": dict(pipeline_depth=1, speculative="prompt_lookup", spec_ngram=1)}


@pytest.fixture(scope="module")
def params():
    jp = JM.init(jax.random.PRNGKey(3), CFG_J)
    return jp, TM.params_from_jax({k: np.asarray(v) for k, v in jp.items()}, "cpu")


def _oracle_rows(jp, prompt, got):
    toks = list(prompt) + list(got)
    padded = np.zeros((1, ORACLE_LEN), np.int32)
    padded[0, :len(toks)] = toks
    logits = np.asarray(JM.forward_full(jp, CFG_J, jnp.asarray(padded)))[0]
    return logits[len(prompt) - 1:len(prompt) - 1 + len(got)]


def _agreeing_prefix(jp, prompt, got, ref) -> int:
    """Assert ``got`` passes the tie-aware oracle and equals ``ref`` up to
    ref's first near tie; returns that length."""
    rows = _oracle_rows(jp, prompt, got)
    for i, g in enumerate(got):
        assert rows[i, g] >= rows[i].max() - TIE_EPS, (i, g, int(rows[i].argmax()))
    top2 = np.sort(_oracle_rows(jp, prompt, ref), axis=-1)[:, -2:]
    near = np.flatnonzero(top2[:, 1] - top2[:, 0] <= STABLE_GAP)
    n = int(near[0]) if near.size else len(ref)
    assert list(got[:n]) == list(ref[:n])
    return n


def _leaked(eng) -> int:
    s = eng.stats
    return (eng.ec.num_pages - 1) - s["free_pages"] - s["cached_pages"]


def _wait(pred, timeout=60.0):
    t0 = time.monotonic()
    while not pred():
        assert time.monotonic() - t0 < timeout, "timed out"
        time.sleep(0.002)


def _events(model, prompt, n=N, headers=RESUME, **params):
    body = {"text_input": prompt, "parameters": {"max_tokens": n, **params}}
    return list(model.generate_stream(body, headers))


def _split(events):
    """(streamed ids, text pieces, final record)."""
    ids = [t for e in events for t in e.get("token_ids", ())]
    return ids, [e["text_output"] for e in events if not e.get("done")], events[-1]


@pytest.mark.parametrize("mode", sorted(MODES))
def test_stream_matches_jax_generate_stream(params, mode):
    jp, tp = params
    jm = JJetStreamModel("m", engine=JEngine(jp, CFG_J, JEngineConfig(**GEO, **MODES[mode])))
    tm = JetStreamModel("m", engine=E.Engine(tp, CFG_T, E.EngineConfig(**GEO, **MODES[mode]),
                                             device="cpu"))
    jm.load()
    tm.load()
    try:
        identical = 0
        for prompt in PROMPTS:
            ref_ids, ref_pieces, ref_final = _split(_events(jm, prompt))
            ids, pieces, final = _split(_events(tm, prompt))
            assert len(ids) == N and final["done"] and final["tokens"] == N
            assert set(final) == set(ref_final)
            assert final["prompt_tokens"] == ref_final["prompt_tokens"]
            n = _agreeing_prefix(jp, list(prompt.encode()), ids, ref_ids)
            if ids == ref_ids:
                identical += 1
                assert pieces == ref_pieces
            else:
                assert n < N
            # the pieces add up to the unary text, event boundaries aside
            unary = tm.generate({"text_input": prompt, "parameters": {"max_tokens": N}})
            assert "".join(pieces) == unary["text_output"]
            assert unary["token_ids"] == ids
            # without X-Stream-Resume the events carry no ids, same text
            plain = _events(tm, prompt, headers=None)
            assert not any("token_ids" in e for e in plain)
            assert "".join(e["text_output"] for e in plain) == unary["text_output"]
        assert identical >= 2, "too few prompts agree to compare pieces"
        if mode == "spec":
            assert tm.engine.stats["spec_proposed"] > 0
        _wait(lambda: tm.engine.stats["active_slots"] == 0)
        assert _leaked(tm.engine) == 0
    finally:
        tm.engine.stop()
        jm.engine.stop()


def _slow_decode(monkeypatch, seconds=0.005):
    """Slow every pipelined decode step (the port has no chaos config)."""
    real = E.decode_step_sample

    def slow(*a, **kw):
        time.sleep(seconds)
        return real(*a, **kw)

    monkeypatch.setattr(E, "decode_step_sample", slow)


def test_client_disconnect_cancels_and_leaks_nothing(params, monkeypatch):
    _, tp = params
    _slow_decode(monkeypatch)
    eng = E.Engine(tp, CFG_T, E.EngineConfig(**GEO), device="cpu")
    tm = JetStreamModel("m", engine=eng)
    srv = ModelServer([tm], port=0)
    srv.start()
    try:
        body = {"text_input": "hello world", "parameters": {"max_tokens": 150}}
        # in process: closing the generator cancels the engine request
        gen = tm.generate_stream(body, RESUME)
        got = [next(gen) for _ in range(3)]
        assert all("token_ids" in e for e in got)
        steps = eng.stats["decode_steps"]
        gen.close()
        _wait(lambda: eng.stats["active_slots"] == 0)
        assert eng.stats["decode_steps"] - steps < 100
        assert _leaked(eng) == 0
        # over HTTP: the client hangs up after a few events
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=30)
        conn.request("POST", "/v2/models/m/generate_stream", json.dumps(body),
                     {"Content-Type": "application/json", **RESUME})
        resp = conn.getresponse()
        assert resp.status == 200
        assert resp.readline().startswith(b"data: ")
        steps = eng.stats["decode_steps"]
        resp.close()  # the response holds the socket open past conn.close()
        conn.close()
        _wait(lambda: eng.stats["active_slots"] == 0)
        assert eng.stats["decode_steps"] - steps < 100
        assert _leaked(eng) == 0
        assert srv.metrics.inflight == 0
    finally:
        srv.stop()
        eng.stop()


@pytest.mark.parametrize("swap_policy", ["swap", "recompute"])
def test_streamed_preempted_victim_continues_exactly(params, swap_policy):
    """A batch-class request streams on the only slot; an interactive one
    preempts it mid-stream.  The victim's stream goes on after its resume
    with every token once, in order: the stream equals the result's
    tokens, and they follow the oracle's trajectory (a duplicated or
    dropped token misses it by whole logits).  Swap restores the exact KV,
    so its stream equals the uncontended run; recompute re-derives the KV
    by a prefill at a step that depends on timing, so a near tie may flip
    and it is held tie-aware."""
    jp, tp = params
    ec = E.EngineConfig(max_slots=1, num_pages=96, page_size=8, max_pages_per_slot=24,
                        scheduler=SchedulerConfig(swap_policy=swap_policy))
    eng = E.Engine(tp, CFG_T, ec, device="cpu")
    eng.start()
    try:
        hog = list("a batch job that runs long".encode())
        alone = eng.generate(hog, 60, priority="batch")["tokens"]
        stream = eng.generate_stream(hog, 60, priority="batch")
        items = [next(stream) for _ in range(5)]
        eng.generate(list(b"urgent"), 4, priority="interactive")
        items += list(stream)
        final = items.pop()
        assert items == final["tokens"] and len(items) == 60
        if swap_policy == "swap":
            assert items == alone
        else:
            _agreeing_prefix(jp, hog, items, alone)
        assert eng.stats["preemptions"] == 1
        assert eng.stats["preemption_modes"][swap_policy] == 1
        assert final["preemptions"] == 1 and eng.stats["swap_used_bytes"] == 0
        assert _leaked(eng) == 0
    finally:
        eng.stop()
