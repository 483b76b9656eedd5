"""Port parity: the incident plane (``EngineConfig(incidents=True)``).

The port's ``serving/incidents.py`` is a copy: the same symptom sets
classify to the same root cause and rule, and the chaos-class contract
(``EXPECTED_INCIDENT_CAUSES``, ``EXPECTED_REMEDIATIONS``) is the JAX
package's.  Both engines, fed at the same sites, open the same incidents:
a ``die_on_tick`` loop death is one ``replica_death`` incident whose
bundle is on disk and whose evidence cites the dying requests' traces and
the watchdog's flight dump; a lone NaN-guard trip is ``unknown``; queue
rejections past ``max_queue_depth`` are ``capacity``.  ``GET
/engine/incidents`` and ``/engine/incidents/<id>`` answer with the same
keys on both servers.  The plane is off by default."""

import json
import os
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

from kubeflow_tpu.serving import incidents as JI
from kubeflow_tpu.serving import server as JS
from kubeflow_tpu.serving.engine import Engine as JEngine
from kubeflow_tpu.serving.engine import EngineConfig as JEngineConfig
from kubeflow_tpu.serving.engine import faults as JF
from kubeflow_tpu.serving.engine import model as JM
from kubeflow_tpu.serving.engine.serve import JetStreamModel as JJetStreamModel
from kubeflow_tpu_torch.serving import incidents as TI
from kubeflow_tpu_torch.serving import server as TS
from kubeflow_tpu_torch.serving.engine import faults as TF
from kubeflow_tpu_torch.serving.engine import model as TM
from kubeflow_tpu_torch.serving.engine.engine import Engine, EngineConfig
from kubeflow_tpu_torch.serving.engine.serve import JetStreamModel

CFG_J = JM.DecoderConfig(vocab_size=13, d_model=64, n_layers=2, n_heads=4,
                         n_kv_heads=2, d_ff=128)
CFG_T = TM.DecoderConfig(**{f: getattr(CFG_J, f) for f in TM.DecoderConfig.__dataclass_fields__})
GEO = dict(max_slots=2, num_pages=64, page_size=8, max_pages_per_slot=12,
           watchdog_interval_s=0.02, incidents=True, incident_poll_s=0.02,
           incident_debounce_s=0.5, incident_resolve_s=30.0)
PROMPTS = [[1, 2, 3, 4] * 3, [5, 6, 7, 8, 9, 10, 11]]

SYMPTOMS = [
    [{"kind": "watchdog"}],
    [{"kind": "watchdog"}, {"kind": "degradation", "source": "storage"}],
    [{"kind": "degradation", "source": "storage"}, {"kind": "degradation", "source": "storage"},
     {"kind": "degradation", "source": "fabric"}],
    [{"kind": "degradation", "source": "nowhere"}],
    [{"kind": "slo_burn", "metric": "tpot", "prefill_active": 2}],
    [{"kind": "slo_burn", "metric": "ttft", "prefill_active": 0}],
    [{"kind": "queue_growth"}],
    [{"kind": "nan_guard"}],
    [{"kind": "tick_overrun"}],
    [{"kind": "constraint_stall"}, {"kind": "queue_growth"}],
    [],
]


@pytest.mark.parametrize("i", range(len(SYMPTOMS)))
def test_classify_matches(i):
    assert TI.classify(SYMPTOMS[i]) == JI.classify(SYMPTOMS[i])


def test_chaos_contract_tables_match():
    assert TF.EXPECTED_INCIDENT_CAUSES == JF.EXPECTED_INCIDENT_CAUSES
    assert TF.EXPECTED_REMEDIATIONS == JF.EXPECTED_REMEDIATIONS
    assert [d.name for d in TI.engine_detectors()] == [d.name for d in JI.engine_detectors()]
    assert set(TI.CAUSES) == set(JI.CAUSES)


@pytest.fixture(scope="module")
def params():
    jp = JM.init(jax.random.PRNGKey(0), CFG_J)
    return jp, TM.params_from_jax({k: np.asarray(v) for k, v in jp.items()}, "cpu")


def _wait(pred, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.01)
    return False


def _fail_all(futs):
    for f in futs:
        try:
            f.result(timeout=60)
        except Exception:  # noqa: BLE001 — the chaos under test fails them
            pass


def _death(engine):
    futs = [engine.generate_async(list(p), 30) for p in PROMPTS]
    engine.start()
    try:
        _fail_all(futs)
        # the bundle is written just after the incident is listed
        assert _wait(lambda: [i for i in engine.incident_list() if i["bundle_path"]])
        incs = engine.incident_list()
        return incs, engine.incident_get(incs[0]["id"])
    finally:
        engine.stop()


def test_die_on_tick_opens_one_replica_death_incident(params, tmp_path):
    jp, tp = params
    jec = JEngineConfig(**GEO, chaos=JF.FaultConfig(die_on_tick=4),
                        incident_dir=str(tmp_path / "jax"), flight_dir=str(tmp_path / "jf"))
    tec = EngineConfig(**GEO, chaos=TF.FaultConfig(die_on_tick=4),
                       incident_dir=str(tmp_path / "port"), flight_dir=str(tmp_path / "tf"))
    jincs, jinc = _death(JEngine(jp, CFG_J, jec))
    tincs, tinc = _death(Engine(tp, CFG_T, tec, device="cpu"))
    assert len(tincs) == len(jincs) == 1
    assert tinc["cause"] == jinc["cause"] == TF.EXPECTED_INCIDENT_CAUSES["engine:die_on_tick"]
    assert tinc["classification"] == jinc["classification"]
    assert tinc["detector"] == jinc["detector"] == "watchdog"
    assert set(tinc) == set(jinc)
    assert set(tinc["evidence"]) == set(jinc["evidence"])
    assert len(tinc["evidence"]["trace_ids"]) == len(jinc["evidence"]["trace_ids"]) == 2
    assert tinc["evidence"]["flight_dump"].startswith(str(tmp_path / "tf"))
    # the manager snapshots the metrics window on its own thread, before or
    # after the restart lands
    assert tinc["evidence"]["metrics"].keys() == jinc["evidence"]["metrics"].keys()
    bundle = tinc["bundle_path"]
    assert bundle.startswith(str(tmp_path / "port")) and os.path.exists(bundle)
    on_disk = json.load(open(bundle))
    assert on_disk["id"] == tinc["id"] and on_disk["cause"] == "replica_death"
    assert TI.timeline(tinc)[0].keys() == JI.timeline(jinc)[0].keys()


SIGNALS = {
    # a lone NaN-guard trip: numeric divergence, no taxonomy shape
    "nan_guard": (dict(chaos=dict(nan_logit_rate=1.0, target_rids=(0,),
                                  nan_phase="prefill")), ("nan_guard", "unknown")),
    # a rejection past max_queue_depth: admission pressure
    "queue_growth": (dict(max_queue_depth=1), ("admission_pressure", "capacity")),
}


@pytest.mark.parametrize("signal", sorted(SIGNALS))
def test_lone_signals_classify_alike(params, tmp_path, signal):
    jp, tp = params
    kw, want = SIGNALS[signal]
    out = {}
    for name in ("jax", "port"):
        ekw = dict(GEO, incident_dir=str(tmp_path / name),
                   flight_dir=str(tmp_path / (name + "_f")),
                   max_queue_depth=kw.get("max_queue_depth", 0))
        if name == "jax":
            if "chaos" in kw:
                ekw["chaos"] = JF.FaultConfig(**kw["chaos"])
            eng = JEngine(jp, CFG_J, JEngineConfig(**ekw))
        else:
            if "chaos" in kw:
                ekw["chaos"] = TF.FaultConfig(**kw["chaos"])
            eng = Engine(tp, CFG_T, EngineConfig(**ekw), device="cpu")
        fut = eng.generate_async(list(PROMPTS[0]), 4)
        errors = []
        if signal == "queue_growth":
            try:
                eng.generate_async(list(PROMPTS[1]), 4)  # the queue holds one
            except Exception as e:  # noqa: BLE001 — EngineOverloaded
                errors.append(type(e).__name__)
        eng.start()
        try:
            _fail_all([fut])
            assert _wait(lambda: eng.incident_list())
            out[name] = (errors, [(i["detector"], i["cause"]) for i in eng.incident_list()])
        finally:
            eng.stop()
    assert out["port"] == out["jax"]
    assert out["port"][1] == [want]


def test_plane_is_off_by_default(params):
    _, tp = params
    eng = Engine(tp, CFG_T, EngineConfig(max_slots=2, num_pages=64, page_size=8,
                                         max_pages_per_slot=12), device="cpu")
    assert eng.incidents is None and eng.incident_list() == []
    assert eng.incident_open_count() == 0 and "incidents" not in eng.stats
    eng.stop()


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_incident_routes_answer_alike(params, tmp_path):
    jp, tp = params
    jec = JEngineConfig(**GEO, chaos=JF.FaultConfig(die_on_tick=4),
                        incident_dir=str(tmp_path / "jax"), flight_dir=str(tmp_path / "jf"))
    tec = EngineConfig(**GEO, chaos=TF.FaultConfig(die_on_tick=4),
                       incident_dir=str(tmp_path / "port"), flight_dir=str(tmp_path / "tf"))
    models = {"jax": JJetStreamModel("llm", engine=JEngine(jp, CFG_J, jec)),
              "port": JetStreamModel("llm", engine=Engine(tp, CFG_T, tec, device="cpu"))}
    servers = {"jax": JS.ModelServer([models["jax"]], port=0),
               "port": TS.ModelServer([models["port"]], port=0)}
    got = {}
    started = []
    try:
        for k, srv in servers.items():
            srv.start()
            started.append(k)
            eng = models[k].engine
            _fail_all([eng.generate_async(list(p), 30) for p in PROMPTS])
            assert _wait(lambda: eng.incident_list())
            status, listing = _get(srv.port, "/engine/incidents")
            iid = listing["incidents"][0]["id"]
            got[k] = (status, listing, _get(srv.port, f"/engine/incidents/{iid}"),
                      _get(srv.port, "/engine/incidents/inc-nope"))
            metrics = urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/metrics", timeout=30).read().decode()
            assert "\nincidents_open{" in metrics
    finally:
        for k in started:
            servers[k].stop()
        for m in models.values():
            m.engine.stop()
    (ts, tl, (tds, td), (tns, _)), (js, jl, (jds, jd), (jns, _)) = got["port"], got["jax"]
    assert ts == js == 200 and tds == jds == 200 and tns == jns == 404
    assert tl["open"] == jl["open"] == 1
    assert set(tl) == set(jl) and set(tl["incidents"][0]) == set(jl["incidents"][0])
    assert tl["incidents"][0]["model"] == "llm"
    assert set(td) == set(jd) == {"incident", "timeline"}
    assert [e["step"] for e in td["timeline"]] == [e["step"] for e in jd["timeline"]]
