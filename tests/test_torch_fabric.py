"""Port parity: the fleet KV fabric in kubeflow_tpu_torch.

A finishing request's committed full-page prefix is published as one KVPG
frame into a multi-reader ``FabricStore`` (``GET /engine/kv_fabric/<key>``);
another replica handed ``parameters.fabric = {key, source_port, pages}``
pulls it, verifies it, scatters the pages whose chain hashes match its
prompt and prefills only the tail.  Against the JAX package's:
- the store answers the same sequence of publishes and pulls the same, and
  the text fingerprints, keys and match depths are equal for the same text
  (the reference router places on them);
- port -> port, a fabric hit equals the fabric-off port engine byte for
  byte at both pipeline depths, unary and stream, prefilling only the tail;
- over HTTP, a JAX owner's prefix warms a port replica and a port owner's a
  JAX replica, tie-aware against the JAX ``forward_full``; the two
  packages' frames carry the same header and meta;
- every fabric fault class degrades to a re-prefill attributed
  ``fabric_degraded`` with zero leaked pages, the outcome counts equal to
  the JAX engines'; bad bodies get the JAX package's 400 messages;
- the frame route serves repeatable bytes and 404s forged keys, and the
  reference ``ServiceProxy``'s cache-aware placement picks the port replica
  that published a prefix (``/fleet/cache``)."""

import json
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

from kubeflow_tpu.core.api import APIServer
from kubeflow_tpu.serving import disagg as JD
from kubeflow_tpu.serving import kvfabric as JF
from kubeflow_tpu.serving.api import LABEL_ISVC
from kubeflow_tpu.serving.controllers import POD_PORT_ANNOTATION, PROXY_PORT_ANNOTATION
from kubeflow_tpu.serving.engine import Engine as JEngine
from kubeflow_tpu.serving.engine import EngineConfig as JEngineConfig
from kubeflow_tpu.serving.engine import model as JM
from kubeflow_tpu.serving.engine.faults import FabricFaultConfig as JFabricFaultConfig
from kubeflow_tpu.serving.engine.serve import JetStreamModel as JJetStreamModel
from kubeflow_tpu.serving.errors import RequestError as JRequestError
from kubeflow_tpu.serving.router import ServiceProxy
from kubeflow_tpu.serving.server import ModelServer as JModelServer
from kubeflow_tpu.utils.net import find_free_ports
from kubeflow_tpu_torch.serving import kvfabric as F
from kubeflow_tpu_torch.serving.engine import engine as E
from kubeflow_tpu_torch.serving.engine import model as TM
from kubeflow_tpu_torch.serving.engine.faults import FabricFaultConfig
from kubeflow_tpu_torch.serving.engine.kvstore import unpack_frame
from kubeflow_tpu_torch.serving.engine.serve import JetStreamModel
from kubeflow_tpu_torch.serving.errors import RequestError
from kubeflow_tpu_torch.serving.server import ModelServer

# vocab >= 256: the byte tokenizer addresses ids 0..255
CFG_J = JM.DecoderConfig(vocab_size=288, d_model=32, n_layers=1, n_heads=2,
                         n_kv_heads=1, d_ff=64)
CFG_T = TM.DecoderConfig(**{f: getattr(CFG_J, f) for f in TM.DecoderConfig.__dataclass_fields__})
NUM_PAGES = 96
PAGE = 8
GEO = dict(max_slots=2, page_size=PAGE, num_pages=NUM_PAGES, max_pages_per_slot=24)
# a shared "system prompt" of several full pages and fingerprint rungs
SHARED = "You are a helpful assistant. Answer concisely and cite. " * 2
PROMPT = SHARED + "Q?"
TIE_EPS = 5e-2
ORACLE_LEN = 160

_forward = jax.jit(lambda p, t: JM.forward_full(p, CFG_J, t))


@pytest.fixture(scope="module")
def params():
    jp = JM.init(jax.random.PRNGKey(0), CFG_J)
    return jp, TM.params_from_jax({k: np.asarray(v) for k, v in jp.items()}, "cpu")


def _engine(params, pkg, **kw):
    kw = {**GEO, "fabric": True, **kw}
    if pkg == "port":
        eng = E.Engine(params[1], CFG_T, E.EngineConfig(**kw), device="cpu")
    else:
        eng = JEngine(params[0], CFG_J, JEngineConfig(**kw))
    eng.start()
    return eng


def _model(pkg, eng, name="m"):
    return JetStreamModel(name, engine=eng) if pkg == "port" else JJetStreamModel(name, "", engine=eng)


def _served(pkg, eng, name="m"):
    srv = (ModelServer if pkg == "port" else JModelServer)([_model(pkg, eng, name)], port=0)
    srv.start()
    return srv


def _leak(eng) -> int:
    s = eng.stats
    return (NUM_PAGES - 1) - s["free_pages"] - s["cached_pages"]


def _gen(model, prompt, mt, **params):
    return model.generate({"text_input": prompt, "parameters": {"max_tokens": mt, **params}})


def _outcomes(eng) -> dict:
    return {dict(k)["outcome"]: v for k, v in eng.telemetry.kv_fabric.series().items()}


def _hint(eng, srv) -> dict:
    """The pull hint for ``eng``'s most recent publish, as the router
    injects it."""
    view = eng.fabric_view()
    assert view, "nothing published"
    return {"fabric": {"key": view[0]["key"], "source_port": srv.port,
                       "pages": view[0]["pages"]}}


def assert_tie_aware(jp, prompt: str, got: list):
    ids = list(prompt.encode())
    toks = ids + list(got)
    padded = np.zeros((1, ORACLE_LEN), np.int32)
    padded[0, :len(toks)] = toks
    rows = np.asarray(_forward(jp, padded))[0, len(ids) - 1:len(toks) - 1]
    for i, g in enumerate(got):
        assert rows[i, g] >= rows[i].max() - TIE_EPS, (i, g, int(rows[i].argmax()))


@pytest.fixture(scope="module")
def cold(params):
    """PROMPT on a fabric-off port engine: the oracle of every port run."""
    eng = _engine(params, "port", fabric=False)
    try:
        return _gen(_model("port", eng), PROMPT, 10)
    finally:
        eng.stop(drain=False)


def test_fabric_store_and_fingerprints_match_jax():
    """The same publishes and pulls on both packages' stores: the same
    outcomes (multi-reader, TTL refreshed on pull, chaos pre-expiry, LRU
    budget eviction, an over-budget refusal, a republish in place), the
    same counters and the same placement view; and the same fingerprint
    ladders, keys and match depths for the same text."""
    logs = []
    for mod in (JF, F):
        clock = [100.0]
        fs = mod.FabricStore(ttl_s=10.0, max_bytes=100, clock=lambda c=clock: c[0])
        log = [fs.publish("a" * 16, b"x" * 40, {"pages": 3, "fps": ["f"]})]
        log += [fs.pull("a" * 16) for _ in range(3)]
        log += [fs.pull("f" * 16), fs.covers("a" * 16, 3), fs.covers("a" * 16, 4)]
        clock[0] += 8.0
        log.append(fs.pull("a" * 16)[0])
        clock[0] += 11.0
        log.append(fs.pull("a" * 16))
        log.append(fs.publish("b" * 16, b"y" * 40, {}, ttl_s=0.0))
        clock[0] += 0.1
        log.append(fs.pull("b" * 16))
        log += [fs.publish("c" * 16, b"c" * 40, {"pages": 2}),
                fs.publish("d" * 16, b"d" * 40, {"pages": 2}), fs.pull("c" * 16)[0],
                fs.publish("e" * 16, b"e" * 40, {"pages": 2}), fs.pull("d" * 16),
                fs.publish("9" * 16, b"z" * 101, {}), fs.publish("c" * 16, b"C" * 30, {})]
        log += [fs.view(), fs.stats(), fs.sweep()]
        logs.append(log)
    assert logs[0] == logs[1]
    for text in ("", "short", SHARED, PROMPT * 40, "héllo wörld " * 20):
        assert F.fingerprints(text) == JF.fingerprints(text)
        assert F.match_depth(F.fingerprints(text), F.fingerprints(SHARED)) == \
            JF.match_depth(JF.fingerprints(text), JF.fingerprints(SHARED))
    assert F.FP_LADDER == JF.FP_LADDER
    assert F.fabric_key(2 ** 64 + 5) == JF.fabric_key(2 ** 64 + 5) == "0000000000000005"


@pytest.mark.parametrize("stream", [False, True], ids=["unary", "stream"])
@pytest.mark.parametrize("depth", [0, 1])
def test_port_fabric_hit_equals_the_cold_port_engine(params, cold, depth, stream):
    ea, eb = _engine(params, "port", pipeline_depth=depth), _engine(params, "port",
                                                                   pipeline_depth=depth)
    sa, mb = _served("port", ea), _model("port", eb)
    try:
        first = _gen(sa.models["m"], PROMPT, 10)  # publishes on A
        assert first["token_ids"] == cold["token_ids"]
        body = {"text_input": PROMPT, "parameters": {"max_tokens": 10, **_hint(ea, sa)}}
        if stream:
            events = list(mb.generate_stream(body, headers={"X-Stream-Resume": "1"}))
            out = {"token_ids": [i for e in events for i in e.get("token_ids", [])],
                   "fabric": events[-1].get("fabric")}
        else:
            out = mb.generate(body)
        assert out["token_ids"] == cold["token_ids"]
        assert out["fabric"] == {"restore": "hit"}
        assert _outcomes(eb) == {"import": 1, "hit": 1, "publish": 1}
        assert _outcomes(ea) == {"publish": 1, "pull": 1}
        # B prefilled only the tail past the scattered prefix pages
        covered = min(ea.fabric_view()[0]["pages"], (len(PROMPT) - 1) // PAGE) * PAGE
        assert eb.perf.snapshot()["positions_by_kind"]["prefill"] == len(PROMPT) - covered
        assert _leak(ea) == _leak(eb) == 0
    finally:
        sa.stop()
        ea.stop(drain=False)
        eb.stop(drain=False)


def _post(port, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/v2/models/m/generate",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


@pytest.mark.parametrize("owner,puller", [("jax", "port"), ("port", "jax")])
def test_fabric_across_packages_over_http(params, owner, puller):
    ea, eb = _engine(params, owner), _engine(params, puller)
    sa, sb = _served(owner, ea), _served(puller, eb)
    try:
        _post(sa.port, {"text_input": PROMPT, "parameters": {"max_tokens": 10}})
        out = _post(sb.port, {"text_input": PROMPT,
                              "parameters": {"max_tokens": 10, **_hint(ea, sa)}})
        assert out["fabric"] == {"restore": "hit"} and out["tokens"] == 10
        assert_tie_aware(params[0], PROMPT, out["token_ids"])
        assert _outcomes(eb) == {"import": 1, "hit": 1, "publish": 1}
        covered = min(ea.fabric_view()[0]["pages"], (len(PROMPT) - 1) // PAGE) * PAGE
        assert eb.perf.snapshot()["positions_by_kind"]["prefill"] == len(PROMPT) - covered
        assert _leak(ea) == _leak(eb) == 0
    finally:
        for s in (sa, sb):
            s.stop()
        for e in (ea, eb):
            e.stop(drain=False)


def test_fabric_frames_agree_across_packages(params):
    """The same prompt published by each package: the same key, view entry
    and frame header and meta (chain hashes, pages, model, fingerprints)."""
    frames, views = {}, {}
    for pkg in ("jax", "port"):
        eng = _engine(params, pkg)
        try:
            _gen(_model(pkg, eng), PROMPT, 4)
            views[pkg] = [{k: v for k, v in e.items() if k != "age_s"}
                          for e in eng.fabric_view()]
            frames[pkg] = eng.pull_fabric(views[pkg][0]["key"])
        finally:
            eng.stop(drain=False)
    assert views["jax"] == views["port"]
    (_, jh), (_, ph) = unpack_frame(frames["jax"]), unpack_frame(frames["port"])
    assert {k: v for k, v in jh.items() if k != "crc"} == \
        {k: v for k, v in ph.items() if k != "crc"}
    pages = (len(PROMPT) + 4 - 2) // PAGE
    assert ph["meta"]["pages"] == pages and len(ph["meta"]["hashes"]) == pages
    assert ph["meta"]["model"] == "m"
    assert ph["meta"]["fps"] == F.fingerprints(PROMPT[:pages * PAGE])


# fault class -> (owner's EngineConfig kwargs, puller's chaos kwargs,
# a prompt the owner serves instead of PROMPT, the owner's model name)
FAULTS = {
    "torn": ({}, {"torn_pull_on": 1}, None, "m"),
    "flip": ({}, {"flip_pull_on": 1}, None, "m"),
    "slow": ({}, {"slow_pull_s": 0.6, "slow_pull_every": 1}, None, "m"),
    "dead_link": ({}, {"dead_link_on": 1}, None, "m"),
    "expired": ({"expire_publish_on": 1}, {}, None, "m"),
    "budget": ({"fabric_max_bytes": 64}, {}, None, "m"),
    # chain hashes that share nothing with the prompt: the engine's hash
    # gate, not the fingerprint heuristic, refuses the frame
    "wrong_prompt": ({}, {}, "completely different text " * 4, "m"),
    # a same-shape sibling model's frame: the meta model id refuses it
    "sibling_model": ({}, {}, None, "sibling"),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_every_fabric_fault_class_degrades_like_jax(params, cold, monkeypatch, fault):
    owner_kw, chaos_kw, owner_prompt, owner_name = FAULTS[fault]
    counts = {}
    for pkg, cfg, model_cls in (("port", FabricFaultConfig, JetStreamModel),
                                ("jax", JFabricFaultConfig, JJetStreamModel)):
        if fault == "slow":
            monkeypatch.setattr(model_cls, "_FABRIC_PULL_TIMEOUT_S", 0.2)
        okw = {k: v for k, v in owner_kw.items() if k != "expire_publish_on"}
        if "expire_publish_on" in owner_kw:
            okw["fabric_chaos"] = cfg(expire_publish_on=1)
        ea = _engine(params, pkg, **okw)
        eb = _engine(params, pkg, **({"fabric_chaos": cfg(**chaos_kw)} if chaos_kw else {}))
        sa, mb = _served(pkg, ea, owner_name), _model(pkg, eb)
        try:
            _gen(sa.models[owner_name], owner_prompt or PROMPT, 10)
            hint = (_hint(ea, sa) if ea.fabric_view() else
                    {"fabric": {"key": "0" * 16, "source_port": sa.port, "pages": 4}})
            out = _gen(mb, PROMPT, 10, **hint)
            assert out["fabric"] == {"restore": "degraded"}, (pkg, out)
            if pkg == "port":
                assert out["token_ids"] == cold["token_ids"]
            else:
                assert_tie_aware(params[0], PROMPT, out["token_ids"])
            assert eb.perf.snapshot()["waste_flops"].get("fabric_degraded", 0) > 0
            assert _leak(ea) == _leak(eb) == 0
            counts[pkg] = (_outcomes(ea), _outcomes(eb))
        finally:
            sa.stop()
            ea.stop(drain=False)
            eb.stop(drain=False)
    assert counts["port"] == counts["jax"]
    assert counts["port"][1].get("degraded") == 1 and "hit" not in counts["port"][1]


@pytest.mark.parametrize("case", ["parking_budget", "hash_mismatch"])
def test_engine_side_fabric_degrades_like_jax(params, case):
    """Imports the engine itself refuses: a frame past the parking budget
    (at submit) and one sharing no chain hash with the prompt (at
    admission).  Each completes, opens one ``fabric_degradation`` incident
    and charges the same ``fabric_degraded`` positions on both packages."""
    kw = dict(incidents=True, incident_debounce_s=0.5, incident_resolve_s=1.0,
              incident_poll_s=0.05, fabric_max_bytes=64)
    prompt = list(range(1, 19))  # 2 full pages + a tail
    blob = (np.zeros((1, 2, 1, PAGE, 16), np.float32),) * 2
    imp = ((blob, [1, 2], 100) if case == "parking_budget"
           else (blob, np.asarray([7, 9], np.uint64), 32))
    got = []
    for pkg in ("port", "jax"):
        eng = _engine(params, pkg, **kw)
        try:
            r = eng.generate(prompt, 4, fabric_import=imp)
            assert r["num_tokens"] == 4 and r["fabric"] == {"restore": "degraded"}
            deadline = time.monotonic() + 30
            while not eng.incident_list() and time.monotonic() < deadline:
                time.sleep(0.02)
            assert [i["cause"] for i in eng.incident_list()] == ["fabric_degradation"]
            snap = eng.perf.snapshot()
            got.append((_outcomes(eng), snap["waste_positions"]["fabric_degraded"],
                        snap["waste_flops"]["fabric_degraded"]))
            assert _leak(eng) == 0
        finally:
            eng.stop(drain=False)
    assert got[0] == got[1]
    assert got[0][1] == len(prompt)


BAD_BODIES = {
    "forged_key": {"fabric": {"key": "../../etc", "source_port": 80}},
    "bad_port": {"fabric": {"key": "ab" * 8, "source_port": 99999999}},
    "not_object": {"fabric": "junk"},
    "with_handoff": {"fabric": {"key": "ab" * 8, "source_port": 9999},
                     "handoff": {"handle": "ab" * 16, "source_port": 9999,
                                 "token_ids": [1]}},
}


@pytest.mark.parametrize("case", sorted(BAD_BODIES))
def test_fabric_bad_bodies_get_the_jax_messages(params, case):
    msgs = []
    for pkg, exc in (("port", RequestError), ("jax", JRequestError)):
        eng = _engine(params, pkg)
        try:
            with pytest.raises(exc) as e:
                _model(pkg, eng).generate({"text_input": "x",
                                           "parameters": BAD_BODIES[case]})
            msgs.append(str(e.value))
        finally:
            eng.stop(drain=False)
    assert msgs[0] == msgs[1]


def test_frame_routes_serve_bytes_and_404(params):
    """``/engine/kv_fabric/<key>`` serves the same verifiable bytes on every
    pull and 404s a forged or unknown key (a miss counted once), a repeat
    publish of a covered prefix skips its snapshot, and on a server of two
    models the owner is found without charging the other a miss;
    ``/engine/kv_handoff/<handle>`` serves a prefill phase's frame once."""
    ea, eo = _engine(params, "port", role="prefill"), _engine(params, "port")
    srv = ModelServer([JetStreamModel("m", engine=ea), JetStreamModel("other", engine=eo)],
                      port=0)
    srv.start()
    base = f"http://127.0.0.1:{srv.port}/engine"
    try:
        _gen(srv.models["m"], PROMPT, 6)
        key = ea.fabric_view()[0]["key"]
        datas = [urllib.request.urlopen(f"{base}/kv_fabric/{key}", timeout=10).read()
                 for _ in range(2)]
        assert datas[0] == datas[1] and unpack_frame(datas[0])[1]["meta"]["pages"] >= 1
        for bad in ("0" * 16, "not-a-key"):
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(f"{base}/kv_fabric/{bad}", timeout=10)
            assert e.value.code == 404
        assert ea.stats["fabric"]["pulls"] == 2
        # two models: neither is charged a miss while probing for an owner
        assert ea.stats["fabric"]["misses"] == 0 and eo.stats["fabric"]["misses"] == 0
        _gen(srv.models["m"], PROMPT, 6)
        assert _outcomes(ea).get("publish_skipped") == 1
        pre = _gen(srv.models["m"], PROMPT, 6, kv_handoff=True)
        url = f"{base}/kv_handoff/{pre['handoff']['handle']}"
        assert unpack_frame(urllib.request.urlopen(url, timeout=10).read())[1]["meta"][
            "resume_len"] == len(PROMPT) + 1
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(url, timeout=10)  # one-shot
        assert e.value.code == 404
        assert ea.stats["handoff"]["refused"] == 1
        assert _leak(ea) == _leak(eo) == 0
    finally:
        srv.stop()
        ea.stop(drain=False)
        eo.stop(drain=False)


def test_cache_aware_placement_picks_the_publishing_port_replica(params, cold):
    """Three port replicas with the fabric on behind the reference proxy:
    the first shared-prefix request publishes on one; after a
    ``/fleet/cache`` refresh, follow-ups land on that owner
    (``ingress_placements_total{reason="cache"}``) or pull from it, and
    every answer equals the fabric-off port engine's."""
    api = APIServer()
    proxy = ServiceProxy(api)
    svc = find_free_ports(1)[0]
    api.create({"apiVersion": "v1", "kind": "Service",
                "metadata": {"name": "m", "labels": {LABEL_ISVC: "m"},
                             "annotations": {PROXY_PORT_ANNOTATION: str(svc)}},
                "spec": {"selector": {"app": "m"}}})
    engines, servers = [], []
    for i in range(3):
        eng = _engine(params, "port")
        srv = _served("port", eng)
        api.create({"apiVersion": "v1", "kind": "Pod",
                    "metadata": {"name": f"m-{i}", "labels": {"app": "m"},
                                 "annotations": {POD_PORT_ANNOTATION: str(srv.port)}},
                    "spec": {},
                    "status": {"phase": "Running",
                               "conditions": [{"type": "Ready", "status": "True"}]}})
        engines.append(eng)
        servers.append(srv)
    proxy.sync()
    oracle = _engine(params, "port", fabric=False)
    mo = _model("port", oracle)
    try:
        first = _post(svc, {"text_input": SHARED + "Q1?", "parameters": {"max_tokens": 8}})
        assert first["token_ids"] == _gen(mo, SHARED + "Q1?", 8)["token_ids"]
        with urllib.request.urlopen(f"http://127.0.0.1:{svc}/fleet/cache", timeout=10) as r:
            view = json.loads(r.read())
        published = [n for n, rec in view["replicas"].items()
                     if (rec["models"]["m"]["cache"] or {}).get("fabric")]
        owners = [e for e in engines if e.fabric_view()]
        assert len(published) == 1 and len(owners) == 1
        assert owners[0].fabric_view()[0]["fps"] == F.fingerprints(SHARED + "Q1?")[
            :len(owners[0].fabric_view()[0]["fps"])]
        before = dict(JD.PLACEMENTS.series())
        for i in range(2, 6):
            prompt = SHARED + f"Q{i}?"
            out = _post(svc, {"text_input": prompt, "parameters": {"max_tokens": 8}})
            assert out["token_ids"] == _gen(mo, prompt, 8)["token_ids"], i
        delta = {k: v - before.get(k, 0) for k, v in JD.PLACEMENTS.series().items()}
        picks = delta.get((("reason", "cache"),), 0)
        hits = sum(_outcomes(e).get("hit", 0) for e in engines)
        assert picks >= 1 and picks + hits >= 3, (delta, hits)
        for eng in engines:
            assert _leak(eng) == 0
    finally:
        proxy.shutdown()
        for s in servers:
            s.stop()
        for e in engines + [oracle]:
            e.stop(drain=False)
