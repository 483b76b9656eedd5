"""Port parity: the model server's routes, held against the JAX package's.

Every route this slice adds is answered by both packages' ``ModelServer``
(each serving its ``JetStreamModel`` on carried-over weights and a V2 model
that doubles its input tensor) with the same status and the same JSON shape; ids, ``created``,
timings and the V2 ``platform`` are left out of the comparison.  The OpenAI
routes answer unary and streamed, with the null ``adapter``, ``brownout``
and ``constrain`` parameters the OpenAI handler always passes accepted; a
structured ``response_format`` is served by both packages, and a malformed
one is refused by both in the OpenAI error schema with the same message.  ``/engine/health`` reads SERVING, then
DRAINING (503) while ``stop()`` drains an in-flight stream, then DEAD.
``/metrics`` read by the JAX package's own ``scrape_metrics`` carries the
gauges the ingress's least-loaded pick and the autoscaler read."""

import json
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

from kubeflow_tpu.serving.autoscaler import scrape_metrics
from kubeflow_tpu.serving import server as JS
from kubeflow_tpu.serving.engine import Engine as JEngine
from kubeflow_tpu.serving.engine import EngineConfig as JEngineConfig
from kubeflow_tpu.serving.engine import model as JM
from kubeflow_tpu.serving.engine.serve import JetStreamModel as JJetStreamModel
from kubeflow_tpu_torch.serving import server as TS
from kubeflow_tpu_torch.serving.engine import engine as E
from kubeflow_tpu_torch.serving.engine import model as TM
from kubeflow_tpu_torch.serving.engine.serve import JetStreamModel

CFG_J = JM.DecoderConfig(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
                         n_kv_heads=2, d_ff=128)
CFG_T = TM.DecoderConfig(**{f: getattr(CFG_J, f) for f in TM.DecoderConfig.__dataclass_fields__})
GEO = dict(max_slots=2, num_pages=64, page_size=8, max_pages_per_slot=16)
# fields whose values differ run to run or by package
VOLATILE = {"id", "created", "ttft_s", "latency_s", "last_tick_age_s", "ticks",
            "last_request_timestamp", "platform"}


def _doubler(mod):
    class Doubler(mod.Model):
        """A V2 model: twice its input tensor."""

        def predict(self, payload, headers=None):
            return mod.v2_inputs_to_arrays(payload)["x"] * 2

    return Doubler("dbl")


@pytest.fixture(scope="module")
def servers():
    jp = JM.init(jax.random.PRNGKey(2), CFG_J)
    tp = TM.params_from_jax({k: np.asarray(v) for k, v in jp.items()}, "cpu")
    jm = JJetStreamModel("llm", engine=JEngine(jp, CFG_J, JEngineConfig(**GEO)))
    tm = JetStreamModel("llm", engine=E.Engine(tp, CFG_T, E.EngineConfig(**GEO), device="cpu"))
    jsrv = JS.ModelServer([jm, _doubler(JS)], port=0)
    tsrv = TS.ModelServer([tm, _doubler(TS)], port=0)
    jsrv.start()
    tsrv.start()
    yield tsrv, jsrv
    tsrv.stop()
    jsrv.stop()
    tm.engine.stop()
    jm.engine.stop()


def _req(port, method, path, body=None, headers=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data, method=method,
                                 headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


def _shape(obj):
    """The JSON shape: dict keys (volatile values as their type), list
    element shapes, and other values' types."""
    if isinstance(obj, dict):
        return {k: (type(v).__name__ if k in VOLATILE else _shape(v)) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_shape(v) for v in obj]
    return type(obj).__name__


def _sse(raw: bytes) -> list:
    events = []
    for block in raw.split(b"\n\n"):
        if block.startswith(b"data: "):
            data = block[len(b"data: "):]
            events.append(data.decode() if data == b"[DONE]" else json.loads(data))
    return events


GETS = ["/", "/healthz", "/v2/health/live", "/v2/health/ready", "/v1/models", "/v2",
        "/v2/models", "/openai/v1/models", "/v1/models/llm", "/v1/models/nope",
        "/v2/models/llm", "/v2/models/llm/ready", "/v2/models/nope", "/engine/health",
        "/no/such/route"]


@pytest.mark.parametrize("path", GETS)
def test_get_routes_match(servers, path):
    tsrv, jsrv = servers
    (code, _, body), (rcode, _, rbody) = (_req(s.port, "GET", path) for s in (tsrv, jsrv))
    assert code == rcode
    got, ref = json.loads(body), json.loads(rbody)
    assert _shape(got) == _shape(ref)
    if path == "/v2/models/llm":
        assert got["platform"] == "pytorch" and ref["platform"] == "jax"


CHAT = {"model": "llm",
        "messages": [{"role": "system", "content": "be brief"},
                     {"role": "user", "content": [{"type": "text", "text": "hi there"}]}],
        "max_tokens": 6}
POSTS = {
    "infer": ("/v2/models/dbl/infer",
              {"inputs": [{"name": "x", "shape": [2, 2], "datatype": "FP32",
                           "data": [1.0, 2.0, 3.5, 4.0]}]}),
    "generate": ("/v2/models/llm/generate",
                 {"text_input": "hello", "parameters": {"max_tokens": 5, "adapter": None,
                                                        "brownout": None, "constrain": None}}),
    "completions": ("/openai/v1/completions", {"model": "llm", "prompt": "hello",
                                               "max_tokens": 5}),
    # two models served: a body naming none matches none
    "completions_no_model": ("/openai/v1/completions", {"prompt": "hello"}),
    "completions_named": ("/openai/v1/completions",
                          {"model": "llm", "prompt": "hello", "max_tokens": None}),
    "chat": ("/openai/v1/chat/completions", CHAT),
    "chat_no_messages": ("/openai/v1/chat/completions", {"model": "llm", "messages": []}),
    "bad_max_tokens": ("/openai/v1/completions",
                       {"model": "llm", "prompt": "x", "max_tokens": 0}),
    "unknown_model": ("/openai/v1/completions", {"model": "nope", "prompt": "x"}),
    "bad_response_format": ("/openai/v1/chat/completions",
                            {**CHAT, "response_format": {"type": "yaml"}}),
    "v2_unknown_model": ("/v2/models/nope/infer", {"inputs": []}),
    "generate_unknown_model": ("/v2/models/nope/generate", {"text_input": "x"}),
}


@pytest.mark.parametrize("case", sorted(POSTS))
def test_post_routes_match(servers, case):
    tsrv, jsrv = servers
    path, body = POSTS[case]
    (code, _, raw), (rcode, _, rraw) = (_req(s.port, "POST", path, body) for s in (tsrv, jsrv))
    assert code == rcode, (raw, rraw)
    got, ref = json.loads(raw), json.loads(rraw)
    assert _shape(got) == _shape(ref)
    if case == "infer":
        assert got == ref
        assert got["outputs"][0]["data"] == [2.0, 4.0, 7.0, 8.0]
    if code != 200:
        assert got == ref  # the same error, in the same schema


@pytest.mark.parametrize("chat", [False, True], ids=["completions", "chat"])
def test_openai_stream_matches(servers, chat):
    tsrv, jsrv = servers
    path = "/openai/v1/chat/completions" if chat else "/openai/v1/completions"
    body = {**(CHAT if chat else {"model": "llm", "prompt": "hello"}), "max_tokens": 6,
            "stream": True}
    (code, ctype, raw), (rcode, rctype, rraw) = (_req(s.port, "POST", path, body)
                                                 for s in (tsrv, jsrv))
    assert code == rcode == 200 and ctype == rctype == "text/event-stream"
    got, ref = _sse(raw), _sse(rraw)
    assert got[-1] == ref[-1] == "[DONE]"
    # chunk shapes: the first (role in a chat), the middle ones, the final
    assert _shape(got[0]) == _shape(ref[0]) and _shape(got[-2]) == _shape(ref[-2])
    assert all(_shape(c) == _shape(got[1]) for c in got[1:-2])
    assert got[-2]["choices"][0]["finish_reason"] == "length"
    if chat:
        assert got[0]["choices"][0]["delta"]["role"] == "assistant"
        assert not any("role" in c["choices"][0]["delta"] for c in got[1:-1])
    key = "delta" if chat else None
    text = "".join((c["choices"][0][key].get("content", "") if key else c["choices"][0]["text"])
                   for c in got[:-1])
    unary = json.loads(_req(tsrv.port, "POST", path, {**body, "stream": False})[2])
    want = unary["choices"][0]["message"]["content"] if chat else unary["choices"][0]["text"]
    assert text == want


def test_structured_response_format_is_refused_in_openai_schema(servers):
    """Constrained decoding is served: a well-formed structured
    ``response_format`` answers 200 in both packages, unary and streamed.
    A malformed one (a schema the compiler refuses, an unknown format type)
    is refused by both in the OpenAI error schema, with the same message."""
    tsrv, jsrv = servers
    for rf in ({"type": "json_object"},
               {"type": "json_schema", "json_schema": {"schema": {"type": "object"}}}):
        for stream in (False, True):
            codes = [_req(s.port, "POST", "/openai/v1/chat/completions",
                          {**CHAT, "response_format": rf, "stream": stream})[0]
                     for s in (tsrv, jsrv)]
            assert codes == [200, 200]
    for rf in ({"type": "json_schema", "json_schema": {"schema": {"type": "frobnicate"}}},
               {"type": "xml"}):
        for stream in (False, True):
            errs = []
            for srv in (tsrv, jsrv):
                code, _, raw = _req(srv.port, "POST", "/openai/v1/chat/completions",
                                    {**CHAT, "response_format": rf, "stream": stream})
                assert code == 400
                errs.append(json.loads(raw)["error"])
            assert errs[0] == errs[1] and errs[0]["type"] == "invalid_request_error"
    code, _, raw = _req(tsrv.port, "POST", "/openai/v1/chat/completions",
                        {**CHAT, "response_format": {"type": "text"}})
    assert code == 200


def test_generate_stream_route_matches(servers):
    tsrv, jsrv = servers
    body = {"text_input": "hello", "parameters": {"max_tokens": 6}}
    hdr = {"X-Stream-Resume": "1", "traceparent": "00-" + "a" * 32 + "-" + "b" * 16 + "-01",
           "X-Resume-From": "b" * 16, "X-Request-Trace": "0"}
    (code, ctype, raw), (rcode, rctype, rraw) = (
        _req(s.port, "POST", "/v2/models/llm/generate_stream", body, hdr) for s in (tsrv, jsrv))
    assert code == rcode == 200 and ctype == rctype == "text/event-stream"
    got, ref = _sse(raw), _sse(rraw)
    assert _shape(got[-1]) == _shape(ref[-1])
    assert sum(len(e.get("token_ids", ())) for e in got) == 6
    # a client fault before the stream starts is a plain 400
    bad = {"text_input": "x", "parameters": {"max_tokens": "many"}}
    (code, _, raw), (rcode, _, rraw) = (
        _req(s.port, "POST", "/v2/models/llm/generate_stream", bad) for s in (tsrv, jsrv))
    assert code == rcode == 400 and json.loads(raw) == json.loads(rraw)


def test_metrics_scraped_by_the_jax_packages_scraper(servers):
    tsrv, jsrv = servers
    got, ref = scrape_metrics(tsrv.port), scrape_metrics(jsrv.port)
    for key in ("engine_queue_depth", "engine_active_slots", "inflight_requests"):
        assert isinstance(got[key], float) and key in ref
    tm, jm = tsrv.models["llm"], jsrv.models["llm"]
    assert set(tm.extra_metrics()) == set(jm.extra_metrics())
    assert got["engine_serving"] == 1.0
    # every gauge of the port's exposition is one the JAX package renders;
    # the engine registry's labelled series appear as their events happen
    # (a prefix-cache hit needs an identical prompt to have finished first),
    # so those compare by metric family
    assert {k for k in got if "{" not in k} <= {k for k in ref if "{" not in k}
    assert {k.split("{")[0] for k in got} <= {k.split("{")[0] for k in ref}


def test_engine_health_serving_draining_dead(servers, monkeypatch):
    """A fresh replica: SERVING; DRAINING (503) while stop() drains an
    in-flight stream, which still completes; DEAD (503) after."""
    real = E.decode_step_sample

    def slow(*a, **kw):
        time.sleep(0.01)
        return real(*a, **kw)

    monkeypatch.setattr(E, "decode_step_sample", slow)
    eng = E.Engine(servers[0].models["llm"].engine.params, CFG_T, E.EngineConfig(**GEO),
                   device="cpu")
    srv = TS.ModelServer([JetStreamModel("llm", engine=eng)], port=0)
    srv.start()
    try:
        code, _, raw = _req(srv.port, "GET", "/engine/health")
        health = json.loads(raw)
        assert code == 200 and health["state"] == "SERVING"
        assert set(health["models"]["llm"]) == {"state", "role", "last_tick_age_s", "ticks",
                                                "ticks_failed", "restarts"}
        out = {}
        t = threading.Thread(target=lambda: out.update(r=_req(
            srv.port, "POST", "/v2/models/llm/generate_stream",
            {"text_input": "hello", "parameters": {"max_tokens": 60}})))
        t.start()
        deadline = time.monotonic() + 30
        while eng.stats["decode_steps"] < 5:
            assert time.monotonic() < deadline
            time.sleep(0.005)
        stopper = threading.Thread(target=eng.stop)
        stopper.start()
        seen = []
        while stopper.is_alive():
            code, _, raw = _req(srv.port, "GET", "/engine/health")
            state = (code, json.loads(raw)["state"])
            if not seen or seen[-1] != state:
                seen.append(state)
            time.sleep(0.01)
        stopper.join(timeout=30)
        t.join(timeout=30)
        # a poll can race stop()'s first statement (SERVING) or answer
        # after its last (DEAD); in between only DRAINING, and never back
        walk = [(200, "SERVING"), (503, "DRAINING"), (503, "DEAD")]
        assert (503, "DRAINING") in seen
        assert seen == [s for s in walk if s in seen], seen
        events = _sse(out["r"][2])
        assert events[-1]["done"] and events[-1]["tokens"] == 60
        code, _, raw = _req(srv.port, "GET", "/engine/health")
        assert code == 503 and json.loads(raw)["state"] == "DEAD"
    finally:
        srv.stop()
        eng.stop()


def test_engine_health_degraded_while_a_request_retries(servers, monkeypatch):
    """A decode step that fails once puts its request mid-retry: the
    replica reads DEGRADED (still 200: it serves) until the retry commits,
    then SERVING again; the request completes in full."""
    real = E.decode_step_sample
    calls, retrying, release = [0], threading.Event(), threading.Event()

    def flaky(*a, **kw):
        calls[0] += 1
        if calls[0] == 3:
            raise RuntimeError("injected decode failure")
        if calls[0] == 4:  # the retry: hold it until health has been read
            retrying.set()
            release.wait(timeout=30)
        return real(*a, **kw)

    monkeypatch.setattr(E, "decode_step_sample", flaky)
    eng = E.Engine(servers[0].models["llm"].engine.params, CFG_T, E.EngineConfig(**GEO),
                   device="cpu")
    srv = TS.ModelServer([JetStreamModel("llm", engine=eng)], port=0)
    srv.start()
    try:
        out = {}
        t = threading.Thread(target=lambda: out.update(r=_req(
            srv.port, "POST", "/v2/models/llm/generate",
            {"text_input": "hello", "parameters": {"max_tokens": 8}})))
        t.start()
        assert retrying.wait(timeout=30)
        code, _, raw = _req(srv.port, "GET", "/engine/health")
        health = json.loads(raw)
        release.set()
        t.join(timeout=30)
        assert code == 200 and health["state"] == "DEGRADED"
        assert health["models"]["llm"]["ticks_failed"] == 1
        assert out["r"][0] == 200 and json.loads(out["r"][2])["tokens"] == 8
        code, _, raw = _req(srv.port, "GET", "/engine/health")
        assert code == 200 and json.loads(raw)["state"] == "SERVING"
        assert eng._retrying == 0
    finally:
        release.set()
        srv.stop()
        eng.stop()


@pytest.mark.parametrize("exc, printed", [(BrokenPipeError(32, "Broken pipe"), False),
                                          (ConnectionResetError(104, "reset"), False),
                                          (ValueError("a handler bug"), True)])
def test_a_client_that_hung_up_leaves_no_traceback(exc, printed, capsys):
    """A readiness probe past its timeout closes its socket before the
    answer is written; that write's error is not reported, a handler's is."""
    srv = TS.ModelServer([_doubler(TS)])
    try:
        try:
            raise exc
        except Exception:  # noqa: BLE001 — what socketserver's thread sees
            srv.httpd.handle_error(None, ("127.0.0.1", 1))
        err = capsys.readouterr().err
        assert ("Traceback" in err) is printed
        assert (type(exc).__name__ in err) is printed
    finally:
        srv.httpd.server_close()
