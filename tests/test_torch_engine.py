"""Port parity: kubeflow_tpu_torch's engine and HTTP serving path on the CPU.

The port's ``Engine`` runs concurrent prompts (one of them long enough for
chunked prefill) on weights carried over from the JAX package, and its
tokens must pass the JAX package's tie-aware greedy oracle (the
``assert_greedy_equivalent`` pattern of tests/test_engine.py:32, against
the JAX ``forward_full``) with no KV page leaked.  Then ``JetStreamModel`` +
``ModelServer`` answer ``/v2/models/<name>/generate`` and ``:predict`` over
HTTP with the same ``text_output`` as the JAX ``JetStreamModel`` on the same
weights, for prompts whose greedy trajectory has no near-tie."""

import json
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.serving.engine import Engine as JEngine
from kubeflow_tpu.serving.engine import EngineConfig as JEngineConfig
from kubeflow_tpu.serving.engine import model as JM
from kubeflow_tpu.serving.engine.serve import JetStreamModel as JJetStreamModel
from kubeflow_tpu_torch.serving.engine import model as TM
from kubeflow_tpu_torch.serving.engine.engine import Engine, EngineConfig
from kubeflow_tpu_torch.serving.engine.serve import JetStreamModel
from kubeflow_tpu_torch.serving.errors import RequestError
from kubeflow_tpu_torch.serving.server import ModelServer

CFG_J = JM.DecoderConfig(vocab_size=101, d_model=64, n_layers=2, n_heads=4,
                         n_kv_heads=2, d_ff=128)
# byte-level prompts need the 256-id vocabulary
CFG256_J = JM.DecoderConfig(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
                            n_kv_heads=2, d_ff=128)
ORACLE_LEN = 64  # forward_full runs at one padded shape: one compile


def _port_cfg(cfg):
    return TM.DecoderConfig(**{f: getattr(cfg, f) for f in TM.DecoderConfig.__dataclass_fields__})


def _params(cfg, seed):
    jp = JM.init(jax.random.PRNGKey(seed), cfg)
    return jp, TM.params_from_jax({k: np.asarray(v) for k, v in jp.items()}, "cpu")


@pytest.fixture(scope="module")
def params():
    return _params(CFG_J, 0)


@pytest.fixture(scope="module")
def params256():
    return _params(CFG256_J, 1)


def _oracle_logits(jp, cfg, toks):
    """JAX forward_full logits for every position of ``toks`` (causal, so
    right-padding to ORACLE_LEN leaves them unchanged)."""
    padded = np.zeros((1, ORACLE_LEN), np.int32)
    padded[0, :len(toks)] = toks
    return np.asarray(JM.forward_full(jp, cfg, jnp.asarray(padded)))[0, :len(toks)]


def assert_greedy_equivalent(jp, cfg, prompt, got, tie_eps=5e-2):
    """Follow the ENGINE's trajectory and require each emitted token's
    oracle logit to lie within ``tie_eps`` of the oracle max at that step.
    tie_eps is the cross-framework bf16 logit tolerance of
    test_torch_model.py (the JAX package's own within-framework check uses
    1e-3)."""
    logits = _oracle_logits(jp, cfg, list(prompt) + list(got))
    for i, g in enumerate(got):
        row = logits[len(prompt) - 1 + i]
        assert float(row[g]) >= float(row.max()) - tie_eps, (
            f"token {g} (logit {float(row[g]):.4f}) not tied with oracle argmax "
            f"{int(row.argmax())} (logit {float(row.max()):.4f}) at step {i}")


def _greedy_with_gap(jp, cfg, prompt, n):
    """The JAX oracle's greedy continuation and its smallest top-1/top-2
    logit gap along the way (a near-tie can legally flip across
    frameworks)."""
    toks, gap = list(prompt), float("inf")
    for _ in range(n):
        row = _oracle_logits(jp, cfg, toks)[-1]
        top2 = np.sort(row)[-2:]
        gap = min(gap, float(top2[1] - top2[0]))
        toks.append(int(row.argmax()))
    return toks[len(prompt):], gap


def _leak_free(eng):
    s = eng.stats
    return (s["active_slots"] == 0
            and s["free_pages"] + s["cached_pages"] == eng.ec.num_pages - 1)


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "gather"])
def test_engine_concurrent_prompts_pass_greedy_oracle(params, paged):
    """6 concurrent requests on 4 slots — queueing, slot rotation, a
    bucketed short-prefill group and two chunked prompts (prefill_chunk 16)
    — all pass the tie-aware greedy oracle; no page leaks."""
    jp, tp = params
    eng = Engine(tp, _port_cfg(CFG_J),
                 EngineConfig(max_slots=4, num_pages=64, page_size=8,
                              max_pages_per_slot=16, prefill_chunk=16,
                              paged_kernel=paged),
                 device="cpu")
    prompts = [[5, 7, 9, 11], list(range(1, 41)), [42],
               [13 + i % 50 for i in range(20)], [99, 98, 97, 96, 95], [7]]
    eng.start()
    try:
        futs = [eng.generate_async(p, 6) for p in prompts]
        results = [f.result(timeout=120) for f in futs]
        for p, r in zip(prompts, results):
            assert r["num_tokens"] == 6 and not r["truncated"]
            assert 0 < r["ttft_s"] <= r["latency_s"]
            assert_greedy_equivalent(jp, CFG_J, p, r["tokens"])
        assert eng.stats["prefill_dispatches"] < len(prompts) + 4  # grouped
        assert eng.stats["decode_steps"] > 0
        assert _leak_free(eng)
    finally:
        eng.stop()


def test_engine_rejects_bad_requests(params):
    _, tp = params
    eng = Engine(tp, _port_cfg(CFG_J),
                 EngineConfig(max_slots=1, num_pages=16, page_size=8,
                              max_pages_per_slot=4), device="cpu")
    try:
        for toks, n in (([], 4), ([5, 500], 4), (list(range(30)), 10)):
            with pytest.raises(RequestError):
                eng.generate_async(toks, n)
    finally:
        eng.stop()


def _post(port, path, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


CANDIDATES = ["hello world", "The quick brown fox", "kubeflow on an H100",
              "paged attention", "abc", "serve Llama-3 please", "jax", "12345"]
# a prompt whose greedy trajectory keeps every top-1/top-2 logit gap above
# this is "tie-stable": twice the largest cross-framework logit difference
# seen at this size (0.035, test_torch_model.py), so both engines must pick
# the same token at every step and the bytes must agree exactly
STABLE_GAP = 0.07


def test_http_generate_and_predict_match_jax_jetstream(params256):
    jp, tp = params256
    n = 8
    ec = dict(max_slots=2, num_pages=64, page_size=8, max_pages_per_slot=16)
    jm = JJetStreamModel("llm", engine=JEngine(jp, CFG256_J, JEngineConfig(**ec)))
    tm = JetStreamModel("llm", engine=Engine(tp, _port_cfg(CFG256_J),
                                             EngineConfig(**ec), device="cpu"))
    server = ModelServer([tm], port=0)
    jm.load()
    server.start()
    try:
        assert _get(server.port, "/v2/health/live") == (200, {"status": "alive"})
        assert _get(server.port, "/v2/health/ready")[0] == 200
        assert _get(server.port, "/v2/models/llm/ready")[1]["ready"] is True
        assert _get(server.port, "/v2/models/nope/ready")[0] == 404

        stable = 0
        for prompt in CANDIDATES:
            body = {"text_input": prompt, "parameters": {"max_tokens": n}}
            code, out = _post(server.port, "/v2/models/llm/generate", body)
            assert code == 200, out
            ref = jm.generate(body)
            assert out["model_name"] == "llm"
            assert set(ref) <= set(out)
            assert out["tokens"] == ref["tokens"] == n
            assert out["prompt_tokens"] == ref["prompt_tokens"]
            ids = list(prompt.encode())
            assert_greedy_equivalent(jp, CFG256_J, ids, out["token_ids"])
            oracle, gap = _greedy_with_gap(jp, CFG256_J, ids, n)
            if gap > STABLE_GAP:  # no near-tie: the bytes must agree exactly
                stable += 1
                assert ref["token_ids"] == oracle
                assert out["token_ids"] == oracle
                assert out["text_output"] == ref["text_output"]
        assert stable >= 2, "too few tie-stable prompts to compare bytes"

        code, out = _post(server.port, "/v1/models/llm:predict",
                          {"instances": [{"prompt": "abc", "max_tokens": 4}, "hello world"]})
        assert code == 200
        preds = out["predictions"]
        ref = jm.predict({"instances": [{"prompt": "abc", "max_tokens": 4}, "hello world"]})
        assert [p["tokens"] for p in preds] == [r["tokens"] for r in ref] == [4, 32]
        assert all(set(r) <= set(p) for p, r in zip(preds, ref))

        code, out = _post(server.port, "/v2/models/llm/generate",
                          {"text_input": "x", "parameters": {"adapter": "a1"}})
        assert code == 400 and "unknown adapter 'a1'" in out["error"]
        code, out = _post(server.port, "/v2/models/llm/generate",
                          {"text_input": "x", "parameters": {"max_tokens": "many"}})
        assert code == 400
        assert _post(server.port, "/v2/models/nope/generate", {})[0] == 404
        assert _leak_free(tm.engine)
        assert tm.health()["state"] == "SERVING"
    finally:
        server.stop()
        tm.engine.stop()
        jm.engine.stop()


def test_entry_points_refuse_a_missing_card(params):
    """Without a card the entry points raise instead of carrying on on the
    CPU; ``device="cpu"`` must be asked for."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    _, tp = params
    cfg = _port_cfg(CFG_J)
    with pytest.raises(RuntimeError, match="cuda"):
        TM.init(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        Engine(tp, cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        JetStreamModel("llm")
    eng = Engine(tp, cfg, EngineConfig(max_slots=1, num_pages=8, page_size=8,
                                       max_pages_per_slot=2), device="cpu")
    assert eng.device == torch.device("cpu")
    eng.stop()


def test_jetstream_model_loads_a_model_dir(params, tmp_path):
    """Loader path: config.json + params.npz (float16, as hf_convert writes
    it) + engine.json; the weights land as the JAX package's load_params
    casts them (bf16), bit for bit."""
    jp, _ = params
    d = tmp_path / "llm"
    d.mkdir()
    cfg = {f: getattr(CFG_J, f) for f in ("vocab_size", "d_model", "n_layers",
                                          "n_heads", "n_kv_heads", "d_ff")}
    (d / "config.json").write_text(json.dumps(cfg))
    (d / "engine.json").write_text(json.dumps({"max_slots": 2, "num_pages": 32,
                                               "page_size": 8, "paged_kernel": True,
                                               "not_a_field": 1}))
    np.savez(d / "params.npz", **{k: np.asarray(v, np.float16) for k, v in jp.items()})
    ref = JM.load_params(str(d), CFG_J)
    m = JetStreamModel("tiny", str(d), device="cpu")
    m.load()
    try:
        assert m.engine.ec.max_slots == 2 and m.engine.ec.num_pages == 32
        for k, v in ref.items():
            np.testing.assert_array_equal(m.engine.params[k].view(torch.int16).numpy(),
                                          np.asarray(v).view(np.int16))
        out = m.predict({"instances": [{"prompt": "\x05\x07", "max_tokens": 3}]})
        assert out[0]["tokens"] == 3
    finally:
        m.engine.stop()
