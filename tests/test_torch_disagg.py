"""Port parity: disaggregated prefill/decode serving in kubeflow_tpu_torch.

A request split across a prefill replica (``parameters.kv_handoff``: one
token, its committed KV exported as one KVPG frame under a one-shot handle)
and a decode replica (``parameters.handoff``: the frame pulled over
``GET /engine/kv_handoff/<handle>``, verified and scattered, decode with no
prefill) against the JAX package's:
- the handoff store answers the same sequence of puts and pulls the same;
- port -> port, the split output equals the unified port engine's byte for
  byte at both pipeline depths, unary and stream, and the decode engine
  never prefills;
- over HTTP, a JAX prefill replica hands off to a port decode replica and
  a port prefill replica to a JAX decode replica, tie-aware against the JAX
  ``forward_full``; the two packages' frames carry the same header and meta
  and each package reads the other's;
- every handoff fault class degrades to a re-prefill with zero leaked pages
  on both replicas, the outcome counts equal to the JAX engines';
- bad bodies get the JAX package's 400 messages; a bogus ``kv_import``
  raises one ``handoff_degradation`` incident and the same waste on both;
- a port-only and a mixed (JAX prefill, port decode) role-split fleet serve
  behind the reference ``ServiceProxy`` with ``disagg: "all"``."""

import json
import time
import urllib.request

import jax
import numpy as np
import pytest

from kubeflow_tpu.core.api import APIServer
from kubeflow_tpu.serving import disagg as JD
from kubeflow_tpu.serving.api import LABEL_ISVC
from kubeflow_tpu.serving.controllers import POD_PORT_ANNOTATION, PROXY_PORT_ANNOTATION
from kubeflow_tpu.serving.engine import Engine as JEngine
from kubeflow_tpu.serving.engine import EngineConfig as JEngineConfig
from kubeflow_tpu.serving.engine import model as JM
from kubeflow_tpu.serving.engine.faults import HandoffFaultConfig as JHandoffFaultConfig
from kubeflow_tpu.serving.engine.kvstore import unpack_frame as j_unpack_frame
from kubeflow_tpu.serving.engine.serve import JetStreamModel as JJetStreamModel
from kubeflow_tpu.serving.errors import RequestError as JRequestError
from kubeflow_tpu.serving.router import ServiceProxy
from kubeflow_tpu.serving.server import ModelServer as JModelServer
from kubeflow_tpu.utils.net import find_free_ports
from kubeflow_tpu_torch.serving import disagg as D
from kubeflow_tpu_torch.serving.engine import engine as E
from kubeflow_tpu_torch.serving.engine import model as TM
from kubeflow_tpu_torch.serving.engine.faults import HandoffFaultConfig
from kubeflow_tpu_torch.serving.engine.kvstore import unpack_frame
from kubeflow_tpu_torch.serving.engine.serve import JetStreamModel
from kubeflow_tpu_torch.serving.errors import RequestError
from kubeflow_tpu_torch.serving.server import ModelServer

# vocab >= 256: the byte tokenizer addresses ids 0..255
CFG_J = JM.DecoderConfig(vocab_size=288, d_model=32, n_layers=1, n_heads=2,
                         n_kv_heads=1, d_ff=64)
CFG_T = TM.DecoderConfig(**{f: getattr(CFG_J, f) for f in TM.DecoderConfig.__dataclass_fields__})
NUM_PAGES = 96
GEO = dict(max_slots=2, page_size=8, num_pages=NUM_PAGES, max_pages_per_slot=24)
PROMPT = "the quick brown fox jumps over the lazy dog"
# page_size 8: 16 is an exact page boundary (the export runs one page short
# of pages_for(L), which the import must cover)
LENGTHS = (15, 16, 17, 43)
TIE_EPS = 5e-2
ORACLE_LEN = 128

_forward = jax.jit(lambda p, t: JM.forward_full(p, CFG_J, t))


@pytest.fixture(scope="module")
def params():
    jp = JM.init(jax.random.PRNGKey(0), CFG_J)
    return jp, TM.params_from_jax({k: np.asarray(v) for k, v in jp.items()}, "cpu")


def _port(params, role="unified", **kw):
    eng = E.Engine(params[1], CFG_T, E.EngineConfig(**{**GEO, "role": role, **kw}),
                   device="cpu")
    eng.start()
    return eng


def _jax(params, role="unified", **kw):
    eng = JEngine(params[0], CFG_J, JEngineConfig(**{**GEO, "role": role, **kw}))
    eng.start()
    return eng


def _leak(eng) -> int:
    s = eng.stats
    return (NUM_PAGES - 1) - s["free_pages"] - s["cached_pages"]


def _gen(model, prompt, mt, **params):
    return model.generate({"text_input": prompt, "parameters": {"max_tokens": mt, **params}})


def _handoff(pre, port):
    return {"handoff": {"handle": (pre.get("handoff") or {}).get("handle"),
                        "source_port": port, "token_ids": pre["token_ids"]}}


def _outcomes(eng) -> dict:
    return {dict(k)["outcome"]: v for k, v in eng.telemetry.kv_handoff.series().items()}


def assert_tie_aware(jp, prompt: str, got: list):
    """Every served token within TIE_EPS of the JAX ``forward_full`` max
    logit along its own trajectory."""
    ids = list(prompt.encode())
    toks = ids + list(got)
    padded = np.zeros((1, ORACLE_LEN), np.int32)
    padded[0, :len(toks)] = toks
    rows = np.asarray(_forward(jp, padded))[0, len(ids) - 1:len(toks) - 1]
    for i, g in enumerate(got):
        assert rows[i, g] >= rows[i].max() - TIE_EPS, (i, g, int(rows[i].argmax()))


class _Pair:
    """A prefill replica behind a ModelServer (the pull endpoint) and a
    decode replica behind its own, of either package."""

    def __init__(self, params, prefill="port", decode="port", prefill_kw=None,
                 decode_kw=None, depth=1):
        mk = {"port": lambda role, kw: _port(params, role, pipeline_depth=depth, **kw),
              "jax": lambda role, kw: _jax(params, role, pipeline_depth=depth, **kw)}
        srv = {"port": lambda eng: ModelServer([JetStreamModel("m", engine=eng)], port=0),
               "jax": lambda eng: JModelServer([JJetStreamModel("m", "", engine=eng)], port=0)}
        self.ep = mk[prefill]("prefill", prefill_kw or {})
        self.ed = mk[decode]("decode", decode_kw or {})
        self.sp, self.sd = srv[prefill](self.ep), srv[decode](self.ed)
        self.sp.start()
        self.sd.start()
        self.mp, self.md = self.sp.models["m"], self.sd.models["m"]

    def split(self, prompt, mt, stream=False):
        pre = _gen(self.mp, prompt, mt, kv_handoff=True)
        body = {"text_input": prompt, "parameters": {"max_tokens": mt,
                                                     **_handoff(pre, self.sp.port)}}
        if not stream:
            return pre, self.md.generate(body)
        events = list(self.md.generate_stream(body, headers={"X-Stream-Resume": "1"}))
        ids = [i for e in events for i in e.get("token_ids", [])]
        text = "".join(e.get("text_output", "") for e in events if not e.get("done"))
        return pre, {"token_ids": ids, "text_output": text, "tokens": events[-1]["tokens"]}

    def close(self):
        for s in (self.sp, self.sd):
            s.stop()
        for e in (self.ep, self.ed):
            e.stop(drain=False)


def test_handoff_store_answers_like_jax():
    """The same puts and pulls on both packages' stores: the same outcomes
    (one-shot, expiry, chaos pre-expiry, oldest-first budget eviction, an
    over-budget refusal) and the same counters."""
    stores = []
    for mod in (JD, D):
        clock = [100.0]
        stores.append((mod.HandoffStore(ttl_s=10.0, max_bytes=100,
                                        clock=lambda c=clock: c[0]), clock))
    logs = []
    for hs, clock in stores:
        log = []
        h = hs.put(b"x" * 40, {"resume_len": 5})
        log += [h is not None, hs.pull(h), hs.pull(h), hs.pull("nope")]
        h2 = hs.put(b"y" * 40, {})
        clock[0] += 11.0
        log.append(hs.pull(h2))
        log.append(hs.pull(hs.put(b"z" * 40, {}, ttl_s=0.0)))
        a, b = hs.put(b"a" * 60, {}), hs.put(b"b" * 60, {})
        log += [hs.pull(a), hs.pull(b)[0], hs.put(b"w" * 101, {}), hs.drop(b)]
        log += [hs.stats(), hs.sweep()]
        logs.append(log)
    assert logs[0] == logs[1]
    assert D.ROLES == JD.ROLES and D.ROLE_ANNOTATION == JD.ROLE_ANNOTATION
    assert D.normalize_role(None) == JD.normalize_role(None) == "unified"
    with pytest.raises(ValueError):
        D.normalize_role("both")
    body = {"text_input": "x" * 100, "parameters": {"max_tokens": 16}}
    for mode in ("auto", "all"):
        assert D.should_disaggregate(body, mode, 64, 1.0) == \
            JD.should_disaggregate(body, mode, 64, 1.0)
    assert D.model_from_path("/v2/models/m/generate_stream") == "m"


@pytest.mark.parametrize("stream", [False, True], ids=["unary", "stream"])
@pytest.mark.parametrize("depth", [0, 1])
def test_port_split_equals_unified_port_engine(params, depth, stream):
    eu = _port(params, pipeline_depth=depth)
    mu = JetStreamModel("m", engine=eu)
    pair = _Pair(params, depth=depth)
    try:
        for plen in LENGTHS:
            prompt = (PROMPT * 3)[:plen]
            ref = _gen(mu, prompt, 12)
            pre, out = pair.split(prompt, 12, stream=stream)
            assert pre["token_ids"] == ref["token_ids"][:1]
            assert pre["handoff"]["resume_len"] == plen + 1
            assert out["token_ids"] == ref["token_ids"], plen
            assert out["text_output"] == ref["text_output"]
            assert out["tokens"] == 12
        assert pair.ed.stats["prefill_dispatches"] == 0, "the decode replica prefilled"
        assert _outcomes(pair.ed) == {"import": len(LENGTHS)}
        assert _outcomes(pair.ep) == {"export": len(LENGTHS), "pull": len(LENGTHS)}
        assert pair.ep.stats["handoff"]["pending"] == 0
        assert pair.ed.stats["swap_used_bytes"] == 0
        assert _leak(pair.ep) == _leak(pair.ed) == _leak(eu) == 0
    finally:
        pair.close()
        eu.stop(drain=False)


def _post(port, body, stream=False):
    path = "generate_stream" if stream else "generate"
    req = urllib.request.Request(f"http://127.0.0.1:{port}/v2/models/m/{path}",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


@pytest.mark.parametrize("prefill,decode", [("jax", "port"), ("port", "jax")])
def test_handoff_across_packages_over_http(params, prefill, decode):
    pair = _Pair(params, prefill=prefill, decode=decode)
    try:
        for plen in (16, 43):
            prompt = (PROMPT * 3)[:plen]
            pre = _post(pair.sp.port, {"text_input": prompt,
                                       "parameters": {"max_tokens": 10, "kv_handoff": True}})
            out = _post(pair.sd.port, {"text_input": prompt, "parameters": {
                "max_tokens": 10, **_handoff(pre, pair.sp.port)}})
            assert out["tokens"] == 10 and out["token_ids"][:1] == pre["token_ids"]
            assert_tie_aware(params[0], prompt, out["token_ids"])
        # imported, not degraded: a silent re-prefill would pass on tokens
        assert _outcomes(pair.ed) == {"import": 2}
        assert pair.ed.stats["prefill_dispatches"] == 0
        assert _leak(pair.ep) == _leak(pair.ed) == 0
    finally:
        pair.close()


def _bf16_to_f32(a) -> np.ndarray:
    return (np.asarray(a).view(np.uint16).astype(np.uint32) << 16).view(np.float32)


def test_handoff_frames_agree_across_packages(params):
    """The same prompt exported by each package: the same frame header and
    meta (the first token aside, which is compared tie-aware), KV within
    the bf16 logit tolerance, and each package unpacks the other's frame."""
    ej, ep = _jax(params, "prefill"), _port(params, "prefill")
    try:
        prompt = (PROMPT * 3)[:43]
        frames = {}
        for name, eng in (("jax", ej), ("port", ep)):
            r = eng.generate(list(prompt.encode()), 1, handoff=True)
            frames[name] = eng.pull_handoff(r["handoff"]["handle"])
        (jblob, jh), (pblob, ph) = unpack_frame(frames["jax"]), unpack_frame(frames["port"])
        for h in (jh, ph):
            assert_tie_aware(params[0], prompt, h["meta"].pop("generated"))
        assert {k: v for k, v in jh.items() if k != "crc"} == \
            {k: v for k, v in ph.items() if k != "crc"}
        assert ph["meta"] == {"resume_len": 44, "page_size": 8, "pages": 6, "adapter_id": 0}
        for a, b in zip(jblob, pblob):
            np.testing.assert_allclose(_bf16_to_f32(a), _bf16_to_f32(b), rtol=TIE_EPS,
                                       atol=TIE_EPS)
        # the JAX package reads the port's frame, bit for bit
        jb2, jh2 = j_unpack_frame(frames["port"])
        assert jh2["meta"]["resume_len"] == 44
        for a, b in zip(jb2, pblob):
            assert np.array_equal(np.asarray(a).view(np.uint16), np.asarray(b).view(np.uint16))
    finally:
        ej.stop(drain=False)
        ep.stop(drain=False)


# fault class -> (prefill engine's chaos, decode engine's chaos), as kwargs
FAULTS = {
    "torn": ({}, {"torn_pull_on": 1}),
    "slow": ({}, {"slow_pull_s": 0.2, "slow_pull_every": 1}),
    "dead_link": ({}, {"dead_link_on": 1}),
    "expired": ({"expire_export_on": 1}, {}),
}


@pytest.fixture(scope="module")
def unified_ref(params):
    eu = _port(params)
    try:
        return _gen(JetStreamModel("m", engine=eu), PROMPT, 10)
    finally:
        eu.stop(drain=False)


@pytest.mark.parametrize("fault", sorted(FAULTS) + ["double_pull"])
def test_every_handoff_fault_class_degrades_like_jax(params, unified_ref, fault):
    """Torn transfer, slow link (which completes WITHOUT degrading, as in
    the JAX package: the handoff pull has no budget past its socket
    timeout), dead link, expired handle and a second decode replica
    presenting a consumed handle: each request completes with the unified
    tokens, no page leaks on either replica, and each replica's outcome
    counts equal the JAX engine's under the same fault config."""
    counts = {}
    for pkg, cfg in (("port", HandoffFaultConfig), ("jax", JHandoffFaultConfig)):
        pkw, dkw = FAULTS.get(fault, ({}, {}))
        pair = _Pair(params, prefill=pkg, decode=pkg,
                     prefill_kw={"handoff_chaos": cfg(**pkw)} if pkw else {},
                     decode_kw={"handoff_chaos": cfg(**dkw)} if dkw else {})
        mk = _port if pkg == "port" else _jax
        ed2 = mk(params, "decode")
        md2 = (JetStreamModel("m", engine=ed2) if pkg == "port"
               else JJetStreamModel("m", "", engine=ed2))
        try:
            pre, out = pair.split(PROMPT, 10)
            outs = [out]
            if fault == "double_pull":
                outs.append(md2.generate({"text_input": PROMPT, "parameters": {
                    "max_tokens": 10, **_handoff(pre, pair.sp.port)}}))
            for o in outs:
                assert o["tokens"] == 10
                if pkg == "port":
                    assert o["token_ids"] == unified_ref["token_ids"], fault
                else:
                    assert_tie_aware(params[0], PROMPT, o["token_ids"])
            assert _leak(pair.ep) == _leak(pair.ed) == _leak(ed2) == 0
            assert pair.ed.stats["swap_used_bytes"] == 0
            counts[pkg] = (_outcomes(pair.ep), _outcomes(pair.ed), _outcomes(ed2))
        finally:
            pair.close()
            ed2.stop(drain=False)
    assert counts["port"] == counts["jax"]
    _, dec, dec2 = counts["port"]
    degraded = dec2 if fault == "double_pull" else dec
    assert degraded.get("degraded", 0) == (0 if fault == "slow" else 1), counts


BAD_BODIES = {
    "kv_handoff_session": {"kv_handoff": True, "session_id": "s"},
    "kv_handoff_resume": {"kv_handoff": True, "resume_token_ids": [1]},
    "empty_token_ids": {"handoff": {"handle": "h", "token_ids": []}},
    "handoff_not_object": {"handoff": "junk"},
    "forged_handle": {"handoff": {"handle": "../../debug/trace/x", "source_port": 80,
                                  "token_ids": [1]}},
    "bad_port": {"handoff": {"handle": "ab" * 16, "source_port": 99999999,
                             "token_ids": [1]}},
    "handoff_resume": {"handoff": {"handle": "ab" * 16, "token_ids": [1]},
                       "resume_token_ids": [2]},
    "stream_kv_handoff": {"kv_handoff": True},
}


@pytest.fixture(scope="module")
def both_models(params):
    ep, ej = _port(params), _jax(params)
    yield JetStreamModel("m", engine=ep), JJetStreamModel("m", "", engine=ej)
    ep.stop(drain=False)
    ej.stop(drain=False)


@pytest.mark.parametrize("case", sorted(BAD_BODIES))
def test_bad_bodies_get_the_jax_messages(both_models, case):
    body = {"text_input": "x", "parameters": BAD_BODIES[case]}
    msgs = []
    for model, exc in zip(both_models, (RequestError, JRequestError)):
        call = model.generate_stream if case.startswith("stream") else model.generate
        with pytest.raises(exc) as e:
            call(body)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    assert _leak(both_models[0].engine) == 0


def test_bogus_kv_import_is_one_handoff_incident_on_both(params):
    """A kv_import whose resume_len disagrees with the prompt degrades at
    submit: the request completes, one ``handoff_degradation`` incident
    opens, and the re-prefill's waste covers the same positions on both."""
    kw = dict(incidents=True, incident_debounce_s=0.5, incident_resolve_s=1.0,
              incident_poll_s=0.05)
    waste = []
    for mk in (_port, _jax):
        eng = mk(params, **kw)
        try:
            r = eng.generate([1, 2, 3, 4, 5], 6, kv_import=(b"x", 5, 999))
            assert r["num_tokens"] == 6
            deadline = time.monotonic() + 30
            while not eng.incident_list() and time.monotonic() < deadline:
                time.sleep(0.02)
            incs = eng.incident_list()
            assert [i["cause"] for i in incs] == ["handoff_degradation"]
            assert _outcomes(eng) == {"degraded": 1}
            snap = eng.perf.snapshot()
            # (a pipelined row finishing behind a dispatch adds
            # pipeline_drop waste on either package, timing-dependent)
            waste.append((snap["waste_positions"]["handoff_degraded"],
                          snap["waste_flops"]["handoff_degraded"]))
        finally:
            eng.stop(drain=False)
    assert waste[0] == waste[1]
    assert waste[0][0] == 5


def _fleet(params, kinds, ann):
    """A Service with ``ann`` and one Ready pod per (package, role)."""
    api = APIServer()
    proxy = ServiceProxy(api)
    svc_port = find_free_ports(1)[0]
    api.create({"apiVersion": "v1", "kind": "Service",
                "metadata": {"name": "m", "labels": {LABEL_ISVC: "m"},
                             "annotations": {PROXY_PORT_ANNOTATION: str(svc_port), **ann}},
                "spec": {"selector": {"app": "m"}}})
    engines, servers = [], []
    for i, (pkg, role) in enumerate(kinds):
        if pkg == "port":
            eng = _port(params, role)
            srv = ModelServer([JetStreamModel("m", engine=eng)], port=0)
        else:
            eng = _jax(params, role)
            srv = JModelServer([JJetStreamModel("m", "", engine=eng)], port=0)
        srv.start()
        api.create({"apiVersion": "v1", "kind": "Pod",
                    "metadata": {"name": f"m-{i}", "labels": {"app": "m"},
                                 "annotations": {POD_PORT_ANNOTATION: str(srv.port),
                                                 JD.ROLE_ANNOTATION: role}},
                    "spec": {},
                    "status": {"phase": "Running",
                               "conditions": [{"type": "Ready", "status": "True"}]}})
        engines.append(eng)
        servers.append(srv)
    proxy.sync()
    return proxy, svc_port, engines, servers


@pytest.mark.parametrize("prefill_pkg", ["port", "jax"], ids=["port_only", "mixed"])
def test_role_split_fleet_behind_the_reference_proxy(params, unified_ref, prefill_pkg):
    """``disagg: "all"``: the ingress runs the prefill phase on the prefill
    pod and the decode phase on the port's decode pod, unary and stream."""
    proxy, svc, (ep, ed), servers = _fleet(
        params, [(prefill_pkg, "prefill"), ("port", "decode")],
        {JD.DISAGG_ANNOTATION: "all"})
    try:
        before = dict(JD.PLACEMENTS.series())
        body = {"text_input": PROMPT, "parameters": {"max_tokens": 10}}
        out = _post(svc, body)
        raw = urllib.request.urlopen(urllib.request.Request(
            f"http://127.0.0.1:{svc}/v2/models/m/generate_stream",
            data=json.dumps(body).encode(), headers={"Content-Type": "application/json"}),
            timeout=120).read().decode()
        events = [json.loads(ln[5:]) for ln in raw.splitlines() if ln.startswith("data:")]
        text = "".join(e.get("text_output", "") for e in events if not e.get("done"))
        assert events[-1]["done"] and events[-1]["tokens"] == 10
        delta = {k: v - before.get(k, 0) for k, v in JD.PLACEMENTS.series().items()}
        assert delta.get((("role", "prefill"),)) == 2
        assert delta.get((("role", "decode"),)) == 2
        assert ep.stats["handoff"]["exports"] == 2
        assert ed.stats["prefill_dispatches"] == 0
        assert _outcomes(ed) == {"import": 2}
        if prefill_pkg == "port":
            assert out["token_ids"] == unified_ref["token_ids"]
            assert text == unified_ref["text_output"]
        else:
            assert_tie_aware(params[0], PROMPT, out["token_ids"])
            assert text == out["text_output"]
        assert _leak(ep) == _leak(ed) == 0
    finally:
        proxy.shutdown()
        for s in servers:
            s.stop()
        for e in (ep, ed):
            e.stop(drain=False)
