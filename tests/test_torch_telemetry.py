"""Port parity: request spans, the trace surfaces, dispatch chaos, flight
dumps, /metrics and the /engine/* observability routes, held against the
JAX package on the CPU.

Both engines run on the same weights and take the same request sequence,
every request submitted before the loop starts so both loops tick the same
schedule:
  * the span phase sequences agree — plain, under seeded dispatch-error
    retries, and under a chaos preemption storm (preempted → readmitted →
    resumed);
  * the same ``FaultConfig`` seed poisons the same rows and fails the same
    request ids with NonFiniteLogits (sync prefill/decode and the
    pipelined ``nan_phase="decode"`` path), and ``dispatch_error_rate=1``
    escalates to TickFailure after ``max_consecutive_failures`` with a
    ``tick_failure_escalation`` flight dump whose header and event fields
    match;
  * over HTTP, the ``X-Request-Trace`` field (unary, and the stream's final
    event) has the same keys and adopts an inbound ``traceparent``;
    ``/metrics`` renders the same metric families with the same label sets;
    ``/engine/{perf, trace, incidents, waterfall, latency}`` and ``POST
    /engine/profile`` answer with the same status and JSON keys.
The port's ``TickProfiler`` writes a Chrome trace of N work ticks with
``torch.profiler``; a capture armed while another profiler runs in the
process reports ``last_error`` instead of an empty trace."""

import glob
import json
import os
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from kubeflow_tpu.core import tracing as JTr
from kubeflow_tpu.serving import server as JS
from kubeflow_tpu.serving.engine import Engine as JEngine
from kubeflow_tpu.serving.engine import EngineConfig as JEngineConfig
from kubeflow_tpu.serving.engine import model as JM
from kubeflow_tpu.serving.engine.faults import FaultConfig as JFaultConfig
from kubeflow_tpu.serving.engine.scheduler import SchedulerConfig as JSchedulerConfig
from kubeflow_tpu.serving.engine.serve import JetStreamModel as JJetStreamModel
from kubeflow_tpu_torch.serving import server as TS
from kubeflow_tpu_torch.serving.engine import model as TM
from kubeflow_tpu_torch.serving.engine.engine import Engine, EngineConfig
from kubeflow_tpu_torch.serving.engine.faults import FaultConfig
from kubeflow_tpu_torch.serving.engine.scheduler import SchedulerConfig
from kubeflow_tpu_torch.serving.engine.serve import JetStreamModel
from kubeflow_tpu_torch.serving.errors import NonFiniteLogits, TickFailure

CFG_J = JM.DecoderConfig(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
                         n_kv_heads=2, d_ff=128)
CFG_T = TM.DecoderConfig(**{f: getattr(CFG_J, f) for f in TM.DecoderConfig.__dataclass_fields__})
GEO = dict(max_slots=4, num_pages=64, page_size=8, max_pages_per_slot=12, prefill_chunk=16)
PROMPTS = [[1, 2, 3, 4] * 4, [9, 8, 7, 6, 5, 4, 3], [5, 9, 2, 6, 5, 3, 5, 8] * 4,
           [11, 12, 13]]
MAX_NEW = 10


@pytest.fixture(scope="module")
def params():
    jp = JM.init(jax.random.PRNGKey(3), CFG_J)
    return jp, TM.params_from_jax({k: np.asarray(v) for k, v in jp.items()}, "cpu")


def _engines(params, tmp_path=None, jkw=None, tkw=None, **kw):
    jp, tp = params
    jx = dict(kw, **(jkw or {}))
    tx = dict(kw, **(tkw or {}))
    if tmp_path is not None:
        jx["flight_dir"] = str(tmp_path / "jax_flight")
        tx["flight_dir"] = str(tmp_path / "port_flight")
    return (JEngine(jp, CFG_J, JEngineConfig(**GEO, **jx)),
            Engine(tp, CFG_T, EngineConfig(**GEO, **tx), device="cpu"))


def _drive(engine, prompts=PROMPTS, max_new=MAX_NEW):
    """Submit everything, then start: -> (results or exceptions, spans);
    the engine's last stats stay on ``engine.final_stats``."""
    futs = [engine.generate_async(list(p), max_new) for p in prompts]
    engine.start()
    out = []
    try:
        for f in futs:
            try:
                out.append(f.result(timeout=120))
            except Exception as e:  # noqa: BLE001 — typed engine faults
                out.append(e)
        spans = [engine.trace(i) for i in range(len(prompts))]
        engine.final_stats = engine.stats
        return out, spans
    finally:
        engine.stop()


def _injected(engine):
    """The chaos injector's counters (idle ticks after the drive, counted
    in ``ticks_seen``, depend on the host's timing)."""
    return {k: v for k, v in engine.final_stats["chaos"].items() if k != "ticks_seen"}


def _phases(span):
    return [e["phase"] for e in span["events"]]


CASES = {
    "plain_sync": dict(pipeline_depth=0),
    "plain_pipelined": dict(pipeline_depth=1),
    "retries": dict(pipeline_depth=0, max_consecutive_failures=20,
                    chaos=("dispatch", dict(seed=5, dispatch_error_rate=0.3))),
    "preempt_storm": dict(pipeline_depth=0, chaos=("preempt", dict(preempt_every=4)),
                          scheduler="swap"),
}


def _case_kwargs(case):
    kw = dict(CASES[case])
    jkw, tkw = {}, {}
    if "chaos" in kw:
        _, ckw = kw.pop("chaos")
        jkw["chaos"], tkw["chaos"] = JFaultConfig(**ckw), FaultConfig(**ckw)
    if "scheduler" in kw:
        pol = kw.pop("scheduler")
        jkw["scheduler"] = JSchedulerConfig(swap_policy=pol)
        tkw["scheduler"] = SchedulerConfig(swap_policy=pol)
    return kw, jkw, tkw


@pytest.mark.parametrize("case", sorted(CASES))
def test_span_phase_sequences_match(params, case):
    kw, jkw, tkw = _case_kwargs(case)
    jeng, teng = _engines(params, jkw=jkw, tkw=tkw, **kw)
    jres, jspans = _drive(jeng)
    tres, tspans = _drive(teng)
    # the schedule depends on lengths only (no stop id), not on which
    # near-tied token either framework picks
    assert [len(r["tokens"]) for r in tres] == [len(r["tokens"]) for r in jres]
    assert [_phases(s) for s in tspans] == [_phases(s) for s in jspans]
    assert set(tspans[0]) == set(jspans[0])
    for s in tspans:
        assert s["outcome"] == "done" and s["cls"] == "interactive"
        assert s["ttft_s"] >= s["queue_wait_s"] >= 0 and s["latency_s"] >= s["ttft_s"]
    if case == "retries":
        assert _injected(teng) == _injected(jeng)
        assert _injected(teng)["injected_dispatch_errors"] > 0
        assert teng.final_stats["ticks_failed"] == jeng.final_stats["ticks_failed"] > 0
    if case == "preempt_storm":
        assert any("preempted" in _phases(s) and "resumed" in _phases(s) for s in tspans)


NAN_CASES = {
    "sync_any_phase": dict(pipeline_depth=0, chaos=dict(seed=3, nan_logit_rate=0.3)),
    "pipelined_decode_target": dict(pipeline_depth=1, chaos=dict(
        seed=1, nan_logit_rate=1.0, target_rids=(2,), nan_phase="decode")),
    "sync_prefill": dict(pipeline_depth=0, chaos=dict(
        seed=0, nan_logit_rate=1.0, target_rids=(1, 3), nan_phase="prefill")),
}


@pytest.mark.parametrize("case", sorted(NAN_CASES))
def test_same_seed_poisons_the_same_requests(params, case, tmp_path):
    kw = dict(NAN_CASES[case])
    ckw = kw.pop("chaos")
    jeng, teng = _engines(params, tmp_path, jkw={"chaos": JFaultConfig(**ckw)},
                          tkw={"chaos": FaultConfig(**ckw)}, **kw)
    jres, jspans = _drive(jeng)
    tres, tspans = _drive(teng)
    jfail = [i for i, r in enumerate(jres) if isinstance(r, Exception)]
    tfail = [i for i, r in enumerate(tres) if isinstance(r, NonFiniteLogits)]
    assert tfail == jfail and tfail
    assert all(type(jres[i]).__name__ == "NonFiniteLogits" for i in jfail)
    for i, (a, b) in enumerate(zip(tres, jres)):
        if i not in tfail:
            assert len(a["tokens"]) == len(b["tokens"]) == MAX_NEW
    assert _injected(teng) == _injected(jeng)
    assert [s["outcome"] for s in tspans] == [s["outcome"] for s in jspans]
    # one nan_guard_trip dump per poisoned tick, in both
    tdumps = sorted(glob.glob(str(tmp_path / "port_flight" / "*.jsonl")))
    jdumps = sorted(glob.glob(str(tmp_path / "jax_flight" / "*.jsonl")))
    assert len(tdumps) == len(jdumps) > 0
    for a, b in zip(tdumps, jdumps):
        ha, hb = (json.loads(open(p).readline()) for p in (a, b))
        assert ha["reason"] == hb["reason"] == "nan_guard_trip"
        assert ha.keys() == hb.keys()


def _read_dump(path):
    with open(path) as f:
        lines = [json.loads(line) for line in f]
    return lines[0], lines[1:]


def test_dispatch_errors_escalate_with_a_flight_dump(params, tmp_path):
    ckw = dict(seed=0, dispatch_error_rate=1.0)
    jeng, teng = _engines(params, tmp_path, jkw={"chaos": JFaultConfig(**ckw)},
                          tkw={"chaos": FaultConfig(**ckw)}, pipeline_depth=1,
                          max_consecutive_failures=3)
    jres, _ = _drive(jeng, PROMPTS[:2])
    tres, tspans = _drive(teng, PROMPTS[:2])
    assert all(isinstance(r, TickFailure) for r in tres)
    assert all(type(r).__name__ == "TickFailure" for r in jres)
    assert [str(r) for r in tres] == [str(r) for r in jres]
    assert [s["outcome"] for s in tspans] == ["failed", "failed"]
    assert teng.final_stats["ticks_failed"] == jeng.final_stats["ticks_failed"] == 3
    (tpath,) = glob.glob(str(tmp_path / "port_flight" / "*.jsonl"))
    (jpath,) = glob.glob(str(tmp_path / "jax_flight" / "*.jsonl"))
    th, tev = _read_dump(tpath)
    jh, jev = _read_dump(jpath)
    assert th["reason"] == jh["reason"] == "tick_failure_escalation"
    assert th.keys() == jh.keys() and th["rids"] == jh["rids"] == [0, 1]
    assert [e["phase"] for e in tev] == [e["phase"] for e in jev]
    assert [e["outcome"] for e in tev] == [e["outcome"] for e in jev] == ["error"] * 3
    for a, b in zip(tev, jev):
        assert a.keys() == b.keys()
        assert (a["slots"], a["rids"], a["shape"]) == (b["slots"], b["rids"], b["shape"])
    # the traces name the dump that concerns them
    tid = tspans[0]["trace_id"]
    assert teng.trace_by_id(tid)["flight_dumps"] == [tpath]


def test_telemetry_off_keeps_no_spans(params):
    _, tp = params
    eng = Engine(tp, CFG_T, EngineConfig(**GEO, telemetry=False), device="cpu")
    res, spans = _drive(eng, PROMPTS[:2])
    assert all(len(r["tokens"]) == MAX_NEW for r in res)
    assert spans == [None, None]
    assert eng.latency_budget() == {"classes": {}, "samples": {}}
    assert "engine_ttft_seconds_count" not in eng.telemetry.render()


# ------------------------------------------------------------- HTTP surfaces


@pytest.fixture(scope="module")
def servers(params):
    jp, tp = params
    jm = JJetStreamModel("llm", engine=JEngine(jp, CFG_J, JEngineConfig(**GEO)))
    tm = JetStreamModel("llm", engine=Engine(tp, CFG_T, EngineConfig(**GEO), device="cpu"))
    js, ts = JS.ModelServer([jm], port=0), TS.ModelServer([tm], port=0)
    js.start()
    ts.start()
    yield {"jax": js, "port": ts}
    for srv, m in ((js, jm), (ts, tm)):
        srv.stop()
        m.engine.stop()


def _req(port, path, body=None, headers=None):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json",
                                          **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            raw = r.read()
            status = r.status
    except urllib.error.HTTPError as e:
        raw, status = e.read(), e.code
    text = raw.decode()
    if path.endswith("generate_stream"):
        return status, [json.loads(line[len("data: "):]) for line in text.splitlines()
                        if line.startswith("data: ")]
    try:
        return status, json.loads(text)
    except ValueError:
        return status, text


def _both(servers, path, body=None, headers=None):
    return {k: _req(s.port, path, body, headers) for k, s in servers.items()}


def _keys(x):
    """The nested key structure of a JSON value (lists by their first item)."""
    if isinstance(x, dict):
        return {k: _keys(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_keys(x[0])] if x else []
    return type(x).__name__ if x is not None else None


def _key_set(x, prefix=""):
    """Flat dotted key paths of a JSON value (a tick's timeline segments
    name whatever phases that tick ran: their keys are data)."""
    out = set()
    if isinstance(x, dict):
        for k, v in x.items():
            out.add(prefix + k)
            if k != "segments":
                out |= _key_set(v, prefix + k + ".")
    elif isinstance(x, list) and x:
        out |= _key_set(x[0], prefix + "[].")
    return out


def test_request_trace_field_and_traceparent(servers):
    ctx = JTr.TraceContext.mint()
    hdr = {"X-Request-Trace": "1", "traceparent": ctx.traceparent()}
    body = {"text_input": "trace me", "parameters": {"max_tokens": 6}}
    got = _both(servers, "/v2/models/llm/generate", body, hdr)
    (ts, tout), (js, jout) = got["port"], got["jax"]
    assert ts == js == 200
    assert tout["tokens"] == jout["tokens"] == 6
    tt, jt = tout["trace"], jout["trace"]
    assert set(tt) == set(jt)
    assert tt["trace_id"] == ctx.trace_id and tt["parent_id"] == ctx.span_id
    assert [e["phase"] for e in tt["events"]] == [e["phase"] for e in jt["events"]]
    assert [e["phase"] for e in tt["events"]] == ["queued", "admitted", "prefill",
                                                 "first_token", "done"]
    # no header, no field
    assert "trace" not in _req(servers["port"].port, "/v2/models/llm/generate", body)[1]
    # the stream's final event carries it, with a resume link from X-Resume-From
    hdr["X-Resume-From"] = "00f067aa0ba902b7"
    sgot = _both(servers, "/v2/models/llm/generate_stream", body, hdr)
    tfin, jfin = sgot["port"][1][-1], sgot["jax"][1][-1]
    assert set(tfin) == set(jfin) and "trace" in tfin
    assert set(tfin["trace"]) == set(jfin["trace"])
    assert tfin["trace"]["links"] == jfin["trace"]["links"] == [
        {"type": "resumed_from", "span_id": "00f067aa0ba902b7"}]
    # the trace route finds the span by its id
    st, tr = _req(servers["port"].port, f"/engine/trace/{ctx.trace_id.upper()}")
    sj, jr = _req(servers["jax"].port, f"/engine/trace/{ctx.trace_id}")
    assert st == sj == 200 and set(tr) == set(jr)
    assert len(tr["spans"]) == len(jr["spans"]) == 2
    assert {s["span_id"] for s in tr["spans"]} >= {tt["span_id"]}


def _families(text):
    """metric family -> set of label-name tuples of its samples (values and
    label values dropped, except the class/outcome/reason labels that the
    same drive must produce alike)."""
    fams: dict = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        name, _, rest = line.partition("{")
        if not rest:
            name = line.split(" ")[0]
            labels = ()
        else:
            body = rest.rsplit("}", 1)[0]
            labels = tuple(sorted(kv.split("=", 1)[0] for kv in body.split(",") if kv))
        fams.setdefault(name, set()).add(labels)
    return fams


def test_metrics_families_and_label_sets_match(servers):
    body = {"text_input": "count me", "parameters": {"max_tokens": 5}}
    for _ in range(2):
        _both(servers, "/v2/models/llm/generate", body)
    got = {k: v[1] for k, v in _both(servers, "/metrics").items()}
    tf, jf = _families(got["port"]), _families(got["jax"])
    assert tf.keys() == jf.keys()
    for name in tf:
        assert tf[name] == jf[name], name
    # one # TYPE line per family, and the engine's histograms are there
    types = [ln.split(" ")[2] for ln in got["port"].splitlines() if ln.startswith("# TYPE ")]
    assert len(types) == len(set(types))
    assert 'engine_ttft_seconds_bucket{' in got["port"]
    assert 'model="llm"' in got["port"]


def test_engine_routes_answer_alike(servers):
    body = {"text_input": "route me", "parameters": {"max_tokens": 4}}
    rids = {k: v[1]["trace"]["rid"] for k, v in _both(
        servers, "/v2/models/llm/generate", body, {"X-Request-Trace": "1"}).items()}
    for path in ("/engine/perf", "/engine/perf?view=cache", "/engine/incidents",
                 "/engine/latency", "/engine/incidents/nope", "/engine/waterfall/99999",
                 "/engine/waterfall/abc", "/engine/trace/" + "0" * 32):
        got = _both(servers, path)
        (ts, tb), (js, jb) = got["port"], got["jax"]
        assert ts == js, path
        assert _key_set(tb) == _key_set(jb), path
    wf = {k: _req(s.port, f"/engine/waterfall/{rids[k]}") for k, s in servers.items()}
    assert wf["port"][0] == wf["jax"][0] == 200
    assert _key_set(wf["port"][1]) == _key_set(wf["jax"][1])
    segs = wf["port"][1]["segments"]
    assert sum(s["dur_s"] for s in segs) == pytest.approx(wf["port"][1]["wall_s"], abs=1e-3)
    perf = _req(servers["port"].port, "/engine/perf")[1]["models"]["llm"]
    assert perf["platform"] == "cpu" and perf["mfu"] > 0 and 0 < perf["goodput_ratio"] <= 1
    lat = _req(servers["port"].port, "/engine/latency")[1]["models"]["llm"]
    assert "interactive" in lat["classes"]
    for bad in ({"ticks": 0}, {"ticks": "x"}, {"ticks": 2, "dir": 5},
                {"ticks": 2, "model": "nope"}):
        got = _both(servers, "/engine/profile", bad)
        assert got["port"][0] == got["jax"][0], bad


def _wait(pred, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.01)
    return False


def test_profile_route_captures_a_chrome_trace(servers, tmp_path):
    port = servers["port"].port
    st, out = _req(port, "/engine/profile", {"ticks": 3})
    assert st == 200 and out["started"] and out["model"] == "llm"
    # a second capture while the first is armed: 409, as in the JAX server
    assert _req(port, "/engine/profile", {"ticks": 3})[0] == 409
    _req(port, "/v2/models/llm/generate", {"text_input": "profile me",
                                           "parameters": {"max_tokens": 6}})
    eng = servers["port"].models["llm"].engine
    assert _wait(lambda: not eng.profiler_active)
    prof = eng.perf_snapshot()["profiler"]
    assert prof["last_error"] is None and prof["captures"] >= 1
    run = prof["runs"][-1]
    assert run["state"] == "complete" and run["nbytes"] > 0
    (trace,) = glob.glob(os.path.join(out["dir"], "*.json"))
    events = json.load(open(trace))["traceEvents"]
    assert any(e.get("ph") == "X" for e in events)


def test_overlapping_profiler_reports_last_error(params):
    _, tp = params
    eng = Engine(tp, CFG_T, EngineConfig(**GEO), device="cpu")
    eng.start()
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            eng.trace_n_ticks(2)
            eng.generate(list(PROMPTS[0]), 4)
            assert _wait(lambda: not eng.profiler_active)
        prof = eng.perf_snapshot()["profiler"]
        assert prof["last_error"] and prof["captures"] == 0
        assert prof["runs"][-1]["state"] == "error"
        # the engine served on, and a later capture (no profiler running) works
        eng.trace_n_ticks(2)
        eng.generate(list(PROMPTS[1]), 4)
        assert _wait(lambda: not eng.profiler_active)
        assert eng.perf_snapshot()["profiler"]["captures"] == 1
    finally:
        eng.stop()
