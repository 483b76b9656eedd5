"""Port replicas behind the JAX package's ingress (``ServiceProxy``).

Two port replicas (``JetStreamModel`` + ``ModelServer`` on the CPU) stand
behind the reference ingress, built as tests/test_fleet.py builds its fleet:
- a replica killed mid-decode (``engine.stop(drain=False)`` when the
  ingress has relayed N tokens from it) loses nothing: the ingress
  re-admits the stream on the survivor with ``resume_token_ids``, and the
  client's text equals the unchaosed run's, with the full token count and
  no page leaked on the survivor;
- the ingress's least-loaded pick reads a numeric load from each port
  replica's ``/metrics``;
- the active ``/engine/health`` probe sees a draining port replica and
  stops routing to it;
- a client's ``traceparent``, relayed by the ingress, makes the port
  replica's engine span a child of the relay hop, and the ingress's
  ``GET /debug/trace/<id>`` assembles a tree that holds it.
The port has no chaos config: the decode step is slowed by a wrapper (as
the port's other tests poison it), so "mid-decode" is deterministic."""

import json
import threading
import time
import urllib.request

from kubeflow_tpu.core import tracing as JTr

import pytest

from kubeflow_tpu.core.api import APIServer
from kubeflow_tpu.serving.api import LABEL_ISVC
from kubeflow_tpu.serving.controllers import POD_PORT_ANNOTATION, PROXY_PORT_ANNOTATION
from kubeflow_tpu.serving.engine.faults import FleetChaos, FleetFaultConfig
from kubeflow_tpu.serving.router import RELAY_TIMEOUT_ANNOTATION, ServiceProxy
from kubeflow_tpu.utils.net import find_free_ports
from kubeflow_tpu_torch.serving.engine import engine as E
from kubeflow_tpu_torch.serving.engine import model as TM
from kubeflow_tpu_torch.serving.engine.serve import JetStreamModel
from kubeflow_tpu_torch.serving.server import ModelServer

# vocab >= 256: the byte tokenizer addresses ids 0..255
CFG = TM.DecoderConfig(vocab_size=288, d_model=32, n_layers=1, n_heads=2,
                       n_kv_heads=1, d_ff=64)
GEO = dict(max_slots=4, page_size=8, num_pages=96, max_pages_per_slot=24)
PROMPT = "the quick brown fox jumps over the lazy dog"
N = 20


@pytest.fixture(scope="module")
def params():
    return TM.init(CFG, "cpu", seed=0)


@pytest.fixture
def slow_decode(monkeypatch):
    real = E.decode_step_sample

    def slow(*a, **kw):
        time.sleep(0.01)
        return real(*a, **kw)

    monkeypatch.setattr(E, "decode_step_sample", slow)


class Fleet:
    """n port replicas behind one ServiceProxy (a bare APIServer with a
    Service and one Ready Pod per replica)."""

    def __init__(self, params, n, chaos=None):
        self.api = APIServer()
        self.proxy = ServiceProxy(self.api)
        self.proxy.chaos = chaos
        self.port = find_free_ports(1)[0]
        self.api.create({
            "apiVersion": "v1", "kind": "Service",
            "metadata": {"name": "fleet", "labels": {LABEL_ISVC: "fleet"},
                         "annotations": {PROXY_PORT_ANNOTATION: str(self.port),
                                         RELAY_TIMEOUT_ANNOTATION: "2.0"}},
            "spec": {"selector": {"app": "fleet"}}})
        self.engines, self.servers = [], []
        for i in range(n):
            eng = E.Engine(params, CFG, E.EngineConfig(**GEO), device="cpu")
            srv = ModelServer([JetStreamModel("fleet", engine=eng)], port=0)
            srv.start()
            self.api.create({
                "apiVersion": "v1", "kind": "Pod",
                "metadata": {"name": f"fleet-{i}", "labels": {"app": "fleet"},
                             "annotations": {POD_PORT_ANNOTATION: str(srv.port)}},
                "spec": {},
                "status": {"phase": "Running",
                           "conditions": [{"type": "Ready", "status": "True"}]}})
            self.engines.append(eng)
            self.servers.append(srv)
        self.proxy.sync()

    def state(self):
        (state,) = self.proxy._states.values()
        return state

    def close(self):
        self.proxy.shutdown()
        for srv in self.servers:
            srv.stop()
        for eng in self.engines:
            eng.stop(drain=False)


def _stream(port, prompt, n, timeout=60):
    """Client-side SSE read of /generate_stream: (text, events, final)."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v2/models/fleet/generate_stream",
        data=json.dumps({"text_input": prompt, "parameters": {"max_tokens": n}}).encode(),
        headers={"Content-Type": "application/json"})
    pieces, events, final, buf = [], [], None, b""
    with urllib.request.urlopen(req, timeout=timeout) as r:
        while True:
            chunk = r.read1(65536)
            if not chunk:
                break
            buf += chunk
            while b"\n\n" in buf:
                raw, buf = buf.split(b"\n\n", 1)
                for line in raw.splitlines():
                    if not line.startswith(b"data:"):
                        continue
                    ev = json.loads(line[5:].strip())
                    events.append(ev)
                    if ev.get("done") and "error" not in ev:
                        final = ev
                    elif "error" not in ev and ev.get("text_output"):
                        pieces.append(ev["text_output"])
    return "".join(pieces), events, final


def _post(port, body, timeout=60):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/v2/models/fleet/generate",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def _leaked(eng) -> int:
    s = eng.stats
    return (eng.ec.num_pages - 1) - s["free_pages"] - s["cached_pages"]


def test_stream_survives_a_replica_killed_mid_decode(params, slow_decode):
    fleet = Fleet(params, 2)
    try:
        ref, _, ref_final = _stream(fleet.port, PROMPT, N)
        assert ref_final["tokens"] == N
    finally:
        fleet.close()

    chaos = FleetChaos(FleetFaultConfig(kill=(0, 1), kill_after_tokens=6))
    fleet = Fleet(params, 2, chaos)
    killed = []  # ONE victim: whichever replica relays 6 tokens first

    def kill_maker(i):
        def cb():
            if not killed:
                killed.append(i)
                fleet.engines[i].stop(drain=False)
        return cb

    for i, srv in enumerate(fleet.servers):
        chaos.register_replica(i, srv.port, kill_cb=kill_maker(i))
    try:
        txt, events, final = _stream(fleet.port, PROMPT, N)
        assert len(killed) == 1
        # byte-level continuity: no duplicated and no dropped token
        assert txt == ref
        assert final["tokens"] == N
        assert not any("error" in e for e in events)
        victim, survivor = killed[0], 1 - killed[0]
        assert fleet.engines[victim].health()["state"] == "DEAD"
        assert _leaked(fleet.engines[survivor]) == 0
    finally:
        fleet.close()


def test_least_loaded_pick_reads_port_replica_loads(params):
    fleet = Fleet(params, 2)
    try:
        # every pick scrapes each replica's /metrics with a 0.1 s timeout,
        # which a loaded CPU can miss once; a replica without /metrics
        # would read None on every pick
        for i in range(10):
            code, out = _post(fleet.port, {"text_input": f"load probe {i}",
                                           "parameters": {"max_tokens": 3}})
            assert code == 200 and out["tokens"] == 3
            state = fleet.state()
            loads = {p: state.loads.get(p) for p in (s.port for s in fleet.servers)}
            if i >= 3 and all(v is not None and isinstance(v[1], float)
                              for v in loads.values()):
                break
            time.sleep(0.3)  # past the load TTL: the next pick re-scrapes
        assert all(v is not None and isinstance(v[1], float) for v in loads.values()), loads
    finally:
        fleet.close()


def test_active_probe_stops_routing_to_a_draining_replica(params, slow_decode):
    fleet = Fleet(params, 2)
    try:
        assert _post(fleet.port, {"text_input": "warm", "parameters": {"max_tokens": 2}})[0] == 200
        draining, other = fleet.servers[0].port, fleet.servers[1].port
        eng = fleet.engines[0]
        # an in-flight request keeps the replica's stop() draining
        held = threading.Thread(target=lambda: _post(
            draining, {"text_input": "a long one", "parameters": {"max_tokens": 150}}))
        held.start()
        while eng.stats["decode_steps"] < 3:
            time.sleep(0.005)
        stopper = threading.Thread(target=eng.stop)
        stopper.start()
        while eng.health()["state"] != "DRAINING":
            time.sleep(0.002)
        state = fleet.state()
        with state.lock:
            for h in state.health.values():
                h.probed_at = 0.0  # due for an active probe now
        picks = {fleet.proxy._pick_backend(state) for _ in range(4)}
        assert picks == {other}
        assert state.health[draining].state == "draining"
        stopper.join(timeout=30)
        held.join(timeout=30)
    finally:
        fleet.close()


def test_relayed_traceparent_assembles_the_port_engine_span(params):
    fleet = Fleet(params, 2)
    try:
        ctx = JTr.TraceContext.mint()
        req = urllib.request.Request(
            f"http://127.0.0.1:{fleet.port}/v2/models/fleet/generate",
            data=json.dumps({"text_input": "trace this hop",
                             "parameters": {"max_tokens": 4}}).encode(),
            headers={"Content-Type": "application/json",
                     "traceparent": ctx.traceparent(), "X-Request-Trace": "1"})
        with urllib.request.urlopen(req, timeout=60) as r:
            assert r.headers["X-Trace-Id"] == ctx.trace_id
            out = json.loads(r.read())
        engine_span = out["trace"]
        assert engine_span["trace_id"] == ctx.trace_id
        assert [e["phase"] for e in engine_span["events"]] == [
            "queued", "admitted", "prefill", "first_token", "done"]
        with urllib.request.urlopen(
                f"http://127.0.0.1:{fleet.port}/debug/trace/{ctx.trace_id}",
                timeout=60) as r:
            tree = json.loads(r.read())
        spans = {sp["span_id"]: sp for sp in tree["spans"]}
        assert engine_span["span_id"] in spans
        mine = spans[engine_span["span_id"]]
        assert mine["component"] == "engine"
        # the engine span hangs off the ingress hop that relayed it
        hop = spans[mine["parent_id"]]
        assert hop["component"] != "engine" and hop["trace_id"] == ctx.trace_id

        def walk(nodes):
            for n in nodes:
                yield n
                yield from walk(n.get("children") or ())

        assert engine_span["span_id"] in {n["span_id"] for n in walk(tree["tree"])}
        assert sorted(tree["replicas_queried"]) == ["fleet-0", "fleet-1"]
    finally:
        fleet.close()
