"""Port parity: the self-driving fleet remediator (``serving/remediator.py``).

Twins of ``tests/test_remediation.py``'s tests.  Each scenario is written
once against a kit of one package's modules and runs on both: on the port it
makes the reference test's assertions, and its record (the decisions each
remediator annotated, the floors it proposed, the quarantine and status
blocks, the bundles' remediation blocks) must equal the JAX package's record
for the same fault on the same explicit clock.  Wall-clock stamps (``wall``,
``since_wall``) and the managers' ``t_s`` offsets (monotonic time since the
incident opened) are taken out before the comparison; everything else is
compared exactly, but a live manager's random incident ids, which are
masked.  The ingress e2e runs through the port's ``ServiceProxy``
and model server alone."""

from __future__ import annotations

import copy
import importlib
import json
import re
import time
import types
import urllib.request
from pathlib import Path

import pytest

pytestmark = pytest.mark.remediation

PORT, REF = "kubeflow_tpu_torch", "kubeflow_tpu"
_CLOCK_KEYS = {"wall", "since_wall", "t_s"}
_INCIDENT_ID = re.compile(r"inc-[0-9a-f]+")  # a live manager's random id


def _kit(pkg: str) -> types.SimpleNamespace:
    def m(name):
        return importlib.import_module(f"{pkg}.{name}")

    ctl, sapi, disagg = m("serving.controllers"), m("serving.api"), m("serving.disagg")
    faults = m("serving.engine.faults")
    return types.SimpleNamespace(
        pkg=pkg, APIServer=m("core.api").APIServer, I=m("serving.incidents"),
        R=m("serving.remediator"), asc_mod=m("serving.autoscaler"),
        ConcurrencyAutoscaler=m("serving.autoscaler").ConcurrencyAutoscaler,
        LABEL_ISVC=sapi.LABEL_ISVC,
        TARGET_CONCURRENCY_ANNOTATION=sapi.TARGET_CONCURRENCY_ANNOTATION,
        DEPLOYMENT_FOR_SERVICE_ANNOTATION=ctl.DEPLOYMENT_FOR_SERVICE_ANNOTATION,
        POD_PORT_ANNOTATION=ctl.POD_PORT_ANNOTATION,
        PROXY_PORT_ANNOTATION=ctl.PROXY_PORT_ANNOTATION,
        DISAGG_ANNOTATION=disagg.DISAGG_ANNOTATION, ROLE_ANNOTATION=disagg.ROLE_ANNOTATION,
        HandoffStore=disagg.HandoffStore, pod_role=disagg.pod_role,
        EXPECTED_INCIDENT_CAUSES=faults.EXPECTED_INCIDENT_CAUSES,
        EXPECTED_REMEDIATIONS=faults.EXPECTED_REMEDIATIONS,
        StormFaultConfig=faults.StormFaultConfig,
        FabricStore=m("serving.kvfabric").FabricStore)


@pytest.fixture(scope="module")
def kits():
    return {PORT: _kit(PORT), REF: _kit(REF)}


def _norm(x):
    """``x`` without its clock stamps and with a live manager's random
    incident ids masked (see the module docstring)."""
    if isinstance(x, dict):
        return {k: _norm(v) for k, v in x.items() if k not in _CLOCK_KEYS}
    if isinstance(x, (list, tuple)):
        return [_norm(v) for v in x]
    if isinstance(x, str):
        return _INCIDENT_ID.sub("inc-*", x)
    return x


def _both(kits, scenario, *args, **kw):
    """Run ``scenario`` on both packages: the port's record must be the
    reference's."""
    port = scenario(kits[PORT], *args, **kw)
    ref = scenario(kits[REF], *args, **kw)
    assert _norm(port) == _norm(ref)
    return port


def _wait(pred, timeout=30.0, msg="condition"):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if pred():
            return
        time.sleep(0.02)
    raise TimeoutError(f"timed out waiting for {msg}")


# --------------------------------------------------------------- test doubles


class _StubMgr:
    """An incident source the rails scenarios drive with synthetic incident
    dicts — annotations are recorded, never re-clocked."""

    def __init__(self, *incidents):
        self.incidents = list(incidents)
        self.annotations = []  # (incident_id, action, status)

    def list(self):
        return [copy.deepcopy(i) for i in self.incidents]

    def annotate_remediation(self, incident_id, action, status=None):
        if not any(i["id"] == incident_id for i in self.incidents):
            return False
        self.annotations.append((incident_id, dict(action), status))
        return True


class _AscSpy:
    """Records floor proposals; never scales anything."""

    def __init__(self):
        self.calls = []

    def propose_floor(self, deployment, replicas, ttl_s=30.0, reason=""):
        self.calls.append((deployment, int(replicas)))

    def proposals(self):
        return {}


def _inc(inc_id, cause, scope="ingress:svc", symptoms=()):
    return {"id": inc_id, "state": "open", "cause": cause, "scope": scope,
            "symptoms": list(symptoms)}


def _deployment(K, name="d", replicas=2, target="4"):
    return {"apiVersion": "apps/v1", "kind": "Deployment",
            "metadata": {"name": name,
                         "annotations": {K.TARGET_CONCURRENCY_ANNOTATION: target}},
            "spec": {"replicas": replicas,
                     "selector": {"matchLabels": {"app": name}},
                     "template": {"metadata": {"labels": {"app": name}},
                                  "spec": {"containers": [{"name": "c", "command": ["x"]}]}}}}


def _service(K, name="svc", deployments=("d",), extra_ann=None):
    ann = {K.DEPLOYMENT_FOR_SERVICE_ANNOTATION: json.dumps(list(deployments))}
    ann.update(extra_ann or {})
    return {"apiVersion": "v1", "kind": "Service",
            "metadata": {"name": name, "annotations": ann, "labels": {K.LABEL_ISVC: name}},
            "spec": {"selector": {"app": name}}}


def _pod(K, name, role=None, ready=True, port=None):
    ann = {}
    if role is not None:
        ann[K.ROLE_ANNOTATION] = role
    if port is not None:
        ann[K.POD_PORT_ANNOTATION] = str(port)
    return {"apiVersion": "v1", "kind": "Pod",
            "metadata": {"name": name, "labels": {"app": "svc"}, "annotations": ann},
            "spec": {},
            "status": {"phase": "Running",
                       "conditions": [{"type": "Ready", "status": "True" if ready else "False"}]}}


def _api_with(K, *objs):
    api = K.APIServer()
    for o in objs:
        api.create(o)
    return api


def _cfg(K, **kw):
    base = dict(cooldown_s=0.0, rate_budget=100, rate_window_s=60.0,
                flap_max=100, flap_window_s=60.0)
    base.update(kw)
    return K.R.RemediatorConfig(**base)


# ----------------------------------------------------------------- contract


def _contract(K):
    assert set(K.EXPECTED_REMEDIATIONS) == set(K.EXPECTED_INCIDENT_CAUSES)
    for key, spec in K.EXPECTED_REMEDIATIONS.items():
        assert spec["cause"] == K.EXPECTED_INCIDENT_CAUSES[key]
        assert spec["playbook"] == K.R.CAUSE_PLAYBOOK[spec["cause"]], key
        assert spec["playbook"] in K.R.PLAYBOOKS
    assert set(K.R.CAUSE_PLAYBOOK) == set(K.I.CAUSES)
    return {"remediations": K.EXPECTED_REMEDIATIONS, "playbook": K.R.CAUSE_PLAYBOOK,
            "playbooks": sorted(K.R.PLAYBOOKS), "tiers": list(K.R.QUARANTINE_TIERS)}


def test_expected_remediations_contract(kits):
    """chaos class -> cause -> playbook, one table in each package, and the
    two packages' tables equal (the port's faults.py keeps the playbook
    table as a literal, pinned here to the port's remediator)."""
    _both(kits, _contract)


# ------------------------------------------------------------------- rails


def _cooldown(K):
    mgr = _StubMgr(_inc("a", "capacity", scope="ingress:s1"),
                   _inc("b", "capacity", scope="ingress:s2"))
    asc = _AscSpy()
    r = K.R.FleetRemediator(api=_api_with(K, _deployment(K)), autoscaler=asc,
                            config=_cfg(K, cooldown_s=5.0))
    r.attach(mgr)
    r._process(1000.0)
    assert len(asc.calls) == 1
    r._process(1004.0)
    assert len(asc.calls) == 1
    r._process(1006.0)
    assert len(asc.calls) == 2
    assert [s for _, _, s in mgr.annotations] == ["in_flight", "deferred", "in_flight"]
    assert mgr.annotations[1][1]["playbook"] == "prescale"
    return {"calls": asc.calls, "annotations": mgr.annotations}


def test_cooldown_defers_then_executes(kits):
    _both(kits, _cooldown)


def _rate_budget(K):
    mgr = _StubMgr(*[_inc(f"i{k}", "capacity", scope=f"ingress:s{k}") for k in range(3)])
    asc = _AscSpy()
    r = K.R.FleetRemediator(api=_api_with(K, _deployment(K)), autoscaler=asc,
                            config=_cfg(K, rate_budget=2))
    r.attach(mgr)
    r._process(2000.0)
    assert len(asc.calls) == 2
    r._process(2001.0)
    assert len(asc.calls) == 2
    r._process(2070.0)
    assert len(asc.calls) == 3
    return {"calls": asc.calls, "annotations": mgr.annotations}


def test_rate_budget_throttles_across_playbooks(kits):
    _both(kits, _rate_budget)


def _starved(K):
    mgr = _StubMgr(_inc("a", "capacity"))
    r = K.R.FleetRemediator(api=_api_with(K, _deployment(K)), autoscaler=_AscSpy(),
                            config=_cfg(K, rate_budget=0, defer_max=2))
    r.attach(mgr)
    r._process(0.0)
    assert [s for _, _, s in mgr.annotations] == ["deferred"]
    r._process(1.0)
    assert len(mgr.annotations) == 1
    r._process(2.0)
    assert len(mgr.annotations) == 2
    _, action, status = mgr.annotations[-1]
    assert status == "escalated" and action["playbook"] == "needs_human"
    assert "starved" in action["detail"]["reason"]
    return {"annotations": mgr.annotations, "status": r.status()}


def test_starved_incident_escalates_past_defer_max(kits):
    _both(kits, _starved)


def _flap(K):
    asc = _AscSpy()
    mgr = _StubMgr()
    r = K.R.FleetRemediator(api=_api_with(K, _deployment(K)), autoscaler=asc,
                            config=_cfg(K, flap_max=2))
    r.attach(mgr)
    esc0 = K.R.INCIDENTS_ESCALATED.value(cause="capacity")
    for k, t in ((1, 0.0), (2, 1.0)):
        mgr.incidents.append(_inc(f"i{k}", "capacity", scope="ingress:s1"))
        r._process(t)
    assert len(asc.calls) == 2
    mgr.incidents.append(_inc("i3", "capacity", scope="ingress:s1"))
    r._process(2.0)
    assert len(asc.calls) == 2 and r.escalations == 1
    assert K.R.INCIDENTS_ESCALATED.value(cause="capacity") == esc0 + 1
    assert mgr.annotations[-1][2] == "escalated"
    mgr.incidents.append(_inc("i4", "capacity", scope="ingress:s1"))
    r._process(3.0)
    assert r.escalations == 2 and len(asc.calls) == 2
    mgr.incidents.append(_inc("i5", "capacity", scope="ingress:s1"))
    r._process(70.0)
    assert len(asc.calls) == 3
    return {"calls": asc.calls, "annotations": mgr.annotations, "escalations": r.escalations}


def test_flap_guard_escalates_and_sticks(kits):
    _both(kits, _flap)


def _dry_run(K):
    api = _api_with(K, _deployment(K), _service(K, extra_ann={K.DISAGG_ANNOTATION: "auto"}),
                    _pod(K, "p0"), _pod(K, "p1"))
    patches = []
    orig = api.patch
    api.patch = lambda *a, **k: (patches.append(a[0]), orig(*a, **k))[1]
    asc = _AscSpy()
    mgr = _StubMgr(_inc("c1", "capacity"),
                   _inc("c2", "prefill_interference", scope="engine:m"),
                   _inc("c3", "storage_degradation"))
    r = K.R.FleetRemediator(api=api, autoscaler=asc, config=_cfg(K, dry_run=True))
    r.attach(mgr)
    dry0 = K.R.REMEDIATION_ACTIONS.value(playbook="prescale", outcome="dry_run")
    r._process(100.0)
    assert asc.calls == [] and patches == [] and r.quarantine.list() == {}
    assert len(mgr.annotations) == 3
    for _, action, status in mgr.annotations:
        assert status == "dry_run" and action["outcome"] == "dry_run"
        assert action["dry_run"] is True
    by_id = {i: a for i, a, _ in mgr.annotations}
    assert by_id["c1"]["detail"]["proposals"][0]["proposed_floor"] == 3
    assert [f["role"] for f in by_id["c2"]["detail"]["flips"]] == ["prefill", "decode"]
    assert by_id["c3"]["detail"]["tier"] == "storage"
    assert K.R.REMEDIATION_ACTIONS.value(playbook="prescale", outcome="dry_run") == dry0 + 1
    r._process(101.0)
    assert len(mgr.annotations) == 3
    return {"annotations": mgr.annotations, "status": r.status()}


def test_dry_run_annotates_with_zero_actuator_calls(kits):
    _both(kits, _dry_run)


# ------------------------------------------------------------- arbitration


def _never_writes(K):
    api = _api_with(K, _deployment(K, replicas=1), _service(K))
    asc = K.ConcurrencyAutoscaler(api)
    mgr = _StubMgr(_inc("rd", "replica_death",
                        symptoms=[{"kind": "breaker_open", "backend": "127.0.0.1:9"}]))
    r = K.R.FleetRemediator(api=api, autoscaler=asc, config=_cfg(K))
    r.attach(mgr)
    patched = []
    orig = api.patch
    api.patch = lambda *a, **k: (patched.append(a[0]), orig(*a, **k))[1]
    r._process(1000.0)
    assert patched == []
    proposals = asc.proposals()
    assert proposals["d"]["floor"] == 2 and "replace_replica" in proposals["d"]["reason"]
    assert mgr.annotations[0][1]["detail"]["ejected_backends"] == ["127.0.0.1:9"]
    assert asc.sync()
    assert api.get("Deployment", "d")["spec"]["replicas"] == 2
    assert patched.count("Deployment") == 1
    asc.sync()
    assert api.get("Deployment", "d")["spec"]["replicas"] == 2
    assert patched.count("Deployment") == 1
    return {"annotations": mgr.annotations,
            "proposal": {k: v for k, v in proposals["d"].items()
                         if k in ("floor", "reason")}}


def test_arbitration_remediator_never_writes_replicas(kits):
    _both(kits, _never_writes)


def _expire(K):
    api = _api_with(K, _deployment(K, replicas=2))
    asc = K.ConcurrencyAutoscaler(api)
    asc.propose_floor("d", 3, ttl_s=0.01)
    time.sleep(0.05)
    assert asc.proposals() == {}
    asc.sync()
    assert api.get("Deployment", "d")["spec"]["replicas"] == 2
    return api.get("Deployment", "d")["spec"]


def test_arbitration_proposals_expire(kits):
    _both(kits, _expire)


def _clamped(K):
    api = _api_with(K, _deployment(K, replicas=1))
    asc = K.ConcurrencyAutoscaler(api)
    asc.propose_floor("d", 50, ttl_s=30.0)
    asc.sync()
    assert api.get("Deployment", "d")["spec"]["replicas"] == 3
    return api.get("Deployment", "d")["spec"]["replicas"]


def test_proposal_clamped_to_max_replicas(kits):
    _both(kits, _clamped)


# -------------------------------------------------------------- quarantine


def _probe_streak(K):
    mgr = _StubMgr(_inc("q1", "storage_degradation"))
    r = K.R.FleetRemediator(config=_cfg(K, probe_interval_s=0.0, healthy_probes=2))
    r.attach(mgr)
    reads = [True, False, True, True]
    enforced = []
    r.quarantine.register("storage", enforce=enforced.append, probe=lambda: reads.pop(0))
    r._process(0.0)
    assert r.quarantine.active("storage") and enforced == [True]
    assert K.R.REMEDIATION_QUARANTINED.value(tier="storage") == 1.0
    r._process(1.0)
    r._process(2.0)
    assert r.quarantine.active("storage")
    r._process(3.0)
    assert not r.quarantine.active("storage") and enforced == [True, False]
    assert K.R.REMEDIATION_QUARANTINED.value(tier="storage") == 0.0
    lifted = [a for a in r.status()["actions"] if a["outcome"] == "lifted"]
    assert len(lifted) == 1 and lifted[0]["target"] == "storage"
    return {"annotations": mgr.annotations, "status": r.status(), "enforced": enforced}


def test_quarantine_probe_streak_gates_unquarantine(kits):
    _both(kits, _probe_streak)


def _fabric_quarantine(K):
    fs = K.FabricStore()
    assert fs.publish("k", b"frame", {"pages": 2})
    fs.set_quarantined(True)
    assert fs.quarantined()
    assert fs.pull("k") == ("miss", None)
    assert not fs.publish("k2", b"x", {"pages": 1})
    assert not fs.covers("k", 1)
    assert fs.view() == []
    assert fs.quarantine_refusals == 2
    assert fs.stats()["quarantined"] is True
    fs.set_quarantined(False)
    assert fs.pull("k") == ("ok", b"frame")
    return fs.stats()


def test_fabric_store_quarantine_enforcement(kits):
    _both(kits, _fabric_quarantine)


def _handoff_quarantine(K):
    hs = K.HandoffStore()
    handle = hs.put(b"kv", {"pages": 1})
    assert handle is not None
    hs.set_quarantined(True)
    assert hs.pull(handle) == ("miss", None)
    assert hs.put(b"kv2", {"pages": 1}) is None
    assert hs.quarantine_refusals == 2
    hs.set_quarantined(False)
    assert hs.pull(handle) == ("ok", b"kv")
    return hs.quarantine_refusals


def test_handoff_store_quarantine_enforcement(kits):
    _both(kits, _handoff_quarantine)


# -------------------------------------------------------- scale-down veto


class _VetoMgr:
    def __init__(self, unremediated=1):
        self.unremediated = unremediated

    def open_count(self):
        return 1

    def unremediated_open_count(self):
        return self.unremediated

    def feed(self, *a, **k):
        pass


def _veto_release(K, monkeypatch):
    mgr = _VetoMgr(unremediated=1)
    api = _api_with(K, _deployment(K, replicas=3))
    a = K.ConcurrencyAutoscaler(api, incidents=mgr)
    monkeypatch.setattr(K.asc_mod, "SCALE_DOWN_WINDOW", 0.0)
    held = [a.sync() for _ in range(3)]
    assert not any(held)
    assert api.get("Deployment", "d")["spec"]["replicas"] == 3
    mgr.unremediated = 0
    a.sync()
    assert a.sync()
    assert api.get("Deployment", "d")["spec"]["replicas"] == 1
    return held


def test_scale_down_veto_releases_when_remediation_in_flight(kits, monkeypatch):
    _both(kits, _veto_release, monkeypatch)


def _veto_bounded(K, monkeypatch):
    mgr = _VetoMgr(unremediated=1)
    api = _api_with(K, _deployment(K, replicas=3))
    a = K.ConcurrencyAutoscaler(api, incidents=mgr)
    monkeypatch.setattr(K.asc_mod, "SCALE_DOWN_WINDOW", 0.0)
    monkeypatch.setattr(K.asc_mod, "INCIDENT_VETO_MAX_HOLD_S", 0.0)
    a.sync()
    assert a.sync()
    assert api.get("Deployment", "d")["spec"]["replicas"] == 1
    return 1


def test_scale_down_veto_bounded_by_max_hold(kits, monkeypatch):
    _both(kits, _veto_bounded, monkeypatch)


def _unremediated(K, tmp_path):
    mgr = K.I.IncidentManager("t", K.I.IncidentConfig(bundle_dir=str(tmp_path)),
                              detectors=K.I.engine_detectors())
    mgr.feed("watchdog", detail="died", trace_ids=[])
    mgr._process(time.monotonic())
    inc_id = mgr.list()[0]["id"]
    counts = [(mgr.open_count(), mgr.unremediated_open_count())]
    action = {"playbook": "replace_replica", "outcome": "dry_run"}
    for status in ("dry_run", "in_flight", "escalated"):
        assert mgr.annotate_remediation(inc_id, action, status=status)
        counts.append((mgr.open_count(), mgr.unremediated_open_count()))
    assert counts == [(1, 1), (1, 1), (1, 0), (1, 0)]
    assert not mgr.annotate_remediation("inc-nope", action)
    return {"counts": counts, "remediation": mgr.get(inc_id)["remediation"]}


def test_unremediated_open_count_statuses(kits, tmp_path):
    port = _unremediated(kits[PORT], tmp_path / "port")
    ref = _unremediated(kits[REF], tmp_path / "ref")
    assert _norm(port) == _norm(ref)


# ------------------------------------------------------ predictive prescale


def _forecast(K):
    storm = K.StormFaultConfig(duration_s=100.0, base_qps=4.0, diurnal_period_s=0.0,
                               diurnal_depth=0.0, burst_every_s=10.0, burst_len_s=2.0,
                               burst_x=3.0)
    assert K.R.storm_rate_qps(storm, 5.0) == 4.0
    assert K.R.storm_rate_qps(storm, 10.5) == 12.0
    assert K.R.forecast_peak_qps(storm, 3.0, 2.0) == 4.0
    assert K.R.forecast_peak_qps(storm, 8.75, 2.0) == 12.0
    asc = _AscSpy()
    r = K.R.FleetRemediator(autoscaler=asc, config=_cfg(K, forecast_horizon_s=2.0,
                                                        forecast_headroom=1.2))
    r.set_forecast(storm, per_replica_qps=2.0, deployment="d", t0=1000.0)
    r._process(1003.0)
    assert asc.calls == [("d", 3)]
    r._process(1007.0)
    assert asc.calls == [("d", 3)]
    r._process(1008.75)
    assert asc.calls == [("d", 3), ("d", 8)]
    proposed = [a for a in r.status()["actions"] if a["outcome"] == "proposed"]
    assert [a["detail"]["proposed_floor"] for a in proposed] == [3, 8]
    assert proposed[-1]["detail"]["t_s"] < 10.0
    r.clear_forecast()
    r._process(1009.0)
    assert len(asc.calls) == 2 and r.status()["forecast_armed"] is False
    return {"calls": asc.calls, "proposed": [a["detail"] | {"at": a["detail"]["t_s"]}
                                             for a in proposed]}


def test_forecast_proposes_before_the_burst(kits):
    _both(kits, _forecast)


def test_storm_envelope_matches_the_reference_on_a_grid(kits):
    """``storm_rate_qps`` / ``forecast_peak_qps`` on the diurnal and burst
    defaults, every 0.05 s of a 4 s storm, equal the JAX package's."""
    cfgs = [kits[p].StormFaultConfig(seed=3) for p in (PORT, REF)]
    for t in [i * 0.05 for i in range(80)]:
        assert kits[PORT].R.storm_rate_qps(cfgs[0], t) == kits[REF].R.storm_rate_qps(cfgs[1], t)
        assert (kits[PORT].R.forecast_peak_qps(cfgs[0], t, 0.5)
                == kits[REF].R.forecast_peak_qps(cfgs[1], t, 0.5))


# ------------------------------------- e2e: one closed bundle per cause


def _live_mgr(K, tmp_path, scope, detectors):
    return K.I.IncidentManager(
        scope, K.I.IncidentConfig(debounce_s=0.1, resolve_s=0.1, bundle_dir=str(tmp_path)),
        detectors=detectors)


def _closed_bundle(K, mgr, tmp_path, inc_id, playbook):
    mgr._process(time.monotonic() + 0.3)
    inc = mgr.get(inc_id)
    assert inc["state"] == "resolved"
    assert inc["remediation"]["playbook"] == playbook
    steps = [row["step"] for row in K.I.timeline(inc)]
    assert steps.index("classified") < steps.index("remediation") < steps.index("resolved")
    bundles = [json.loads(p.read_text()) for p in Path(tmp_path).glob("*.json")]
    mine = [b for b in bundles if b.get("id") == inc_id]
    assert mine and mine[0]["remediation"]["playbook"] == playbook
    assert mine[0]["state"] == "resolved"
    return {"steps": steps, "remediation": mine[0]["remediation"]}


def _e2e(scenario):
    """A test that runs ``scenario(K, tmp_dir, ...)`` on both packages, each
    in a bundle dir of its own, and compares the records."""

    def test(kits, tmp_path, **kw):
        port = scenario(kits[PORT], tmp_path / "port", **kw)
        ref = scenario(kits[REF], tmp_path / "ref", **kw)
        assert _norm(port) == _norm(ref)

    return test


def _replica_death(K, tmp):
    mgr = _live_mgr(K, tmp, "ingress:svc", K.I.ingress_detectors())
    asc = _AscSpy()
    r = K.R.FleetRemediator(api=_api_with(K, _deployment(K), _service(K)),
                            autoscaler=asc, config=_cfg(K))
    r.attach(mgr)
    mgr.feed("breaker_open", backend="127.0.0.1:9", trace_ids=[])
    mgr._process(time.monotonic())
    inc = mgr.list()[0]
    assert inc["cause"] == "replica_death"
    r._process(time.monotonic())
    assert asc.calls == [("d", 3)]
    rem = mgr.get(inc["id"])["remediation"]
    assert rem["status"] == "in_flight"
    assert rem["actions"][0]["detail"]["ejected_backends"] == ["127.0.0.1:9"]
    return {"calls": asc.calls, **_closed_bundle(K, mgr, tmp, inc["id"], "replace_replica")}


def test_e2e_replica_death_replaces_replica(kits, tmp_path):
    _e2e(_replica_death)(kits, tmp_path)


def _split_roles(K, tmp):
    mgr = _live_mgr(K, tmp, "engine:m", K.I.engine_detectors())
    api = _api_with(K, _service(K, extra_ann={K.DISAGG_ANNOTATION: "auto"}),
                    _pod(K, "p0"), _pod(K, "p1"), _pod(K, "p2"))
    r = K.R.FleetRemediator(api=api, config=_cfg(K))
    r.attach(mgr)
    mgr.feed("slo_burn", metric="tpot", class_name="interactive", prefill_active=2, trace_ids=[])
    mgr._process(time.monotonic())
    inc = mgr.list()[0]
    assert inc["cause"] == "prefill_interference"
    r._process(time.monotonic())
    roles = [K.pod_role(api.get("Pod", p)) for p in ("p0", "p1", "p2")]
    assert roles == ["prefill", "decode", "unified"]
    return {"roles": roles, **_closed_bundle(K, mgr, tmp, inc["id"], "split_roles")}


def test_e2e_prefill_interference_splits_roles(kits, tmp_path):
    _e2e(_split_roles)(kits, tmp_path)


def _split_last_unified(K, tmp):
    mgr = _live_mgr(K, tmp, "engine:m", K.I.engine_detectors())
    api = _api_with(K, _service(K, extra_ann={K.DISAGG_ANNOTATION: "auto"}),
                    _pod(K, "p0"), _pod(K, "p1", role="decode"))
    r = K.R.FleetRemediator(api=api, config=_cfg(K))
    r.attach(mgr)
    mgr.feed("slo_burn", metric="tpot", prefill_active=1, trace_ids=[])
    mgr._process(time.monotonic())
    inc_id = mgr.list()[0]["id"]
    r._process(time.monotonic())
    assert K.pod_role(api.get("Pod", "p0")) == "unified"
    rem = mgr.get(inc_id)["remediation"]
    assert rem["status"] == "failed" and rem["actions"][0]["outcome"] == "skipped"
    return rem


def test_e2e_split_roles_keeps_last_unified_replica(kits, tmp_path):
    _e2e(_split_last_unified)(kits, tmp_path)


def _split_no_disagg(K, tmp):
    mgr = _live_mgr(K, tmp, "engine:m", K.I.engine_detectors())
    api = _api_with(K, _service(K), _pod(K, "p0"), _pod(K, "p1"))
    r = K.R.FleetRemediator(api=api, config=_cfg(K))
    r.attach(mgr)
    mgr.feed("slo_burn", metric="tpot", prefill_active=1, trace_ids=[])
    mgr._process(time.monotonic())
    inc_id = mgr.list()[0]["id"]
    r._process(time.monotonic())
    assert K.pod_role(api.get("Pod", "p0")) == "unified"
    rem = mgr.get(inc_id)["remediation"]
    assert rem["status"] == "failed" and rem["actions"][0]["outcome"] == "skipped"
    assert "disagg" in rem["actions"][0]["detail"]["reason"]
    return rem


def test_e2e_split_roles_refuses_without_disagg_routing(kits, tmp_path):
    _e2e(_split_no_disagg)(kits, tmp_path)


def _capacity(K, tmp):
    mgr = _live_mgr(K, tmp, "ingress:svc", K.I.ingress_detectors())
    asc = _AscSpy()
    r = K.R.FleetRemediator(api=_api_with(K, _deployment(K), _service(K)),
                            autoscaler=asc, config=_cfg(K))
    r.attach(mgr)
    mgr.feed("shed", class_name="batch", shed=7, trace_ids=[])
    mgr._process(time.monotonic())
    inc = mgr.list()[0]
    assert inc["cause"] == "capacity"
    r._process(time.monotonic())
    assert asc.calls == [("d", 3)]
    return {"calls": asc.calls, **_closed_bundle(K, mgr, tmp, inc["id"], "prescale")}


def test_e2e_capacity_prescales(kits, tmp_path):
    _e2e(_capacity)(kits, tmp_path)


def _degradation(K, tmp, source):
    mgr = _live_mgr(K, tmp, "engine:m", K.I.engine_detectors())
    r = K.R.FleetRemediator(config=_cfg(K, probe_interval_s=0.0, healthy_probes=2))
    r.attach(mgr)
    mgr.feed("degradation", source=source, outcome="recompute", trace_ids=[])
    mgr._process(time.monotonic())
    inc = mgr.list()[0]
    assert inc["cause"] == f"{source}_degradation"
    now = time.monotonic()
    r._process(now)
    active = [r.quarantine.active(source)]
    r._process(now + 1)
    active.append(r.quarantine.active(source))
    closed = _closed_bundle(K, mgr, tmp, inc["id"], "quarantine_tier")
    r._process(now + 2)
    active.append(r.quarantine.active(source))
    r._process(now + 3)
    active.append(r.quarantine.active(source))
    assert active == [True, True, True, False]
    lifted = [a for a in r.status()["actions"] if a["outcome"] == "lifted"]
    assert lifted and lifted[-1]["target"] == source
    return {"active": active, "actions": r.status()["actions"], **closed}


@pytest.mark.parametrize("source", ["storage", "handoff", "fabric"])
def test_e2e_degradation_quarantines_and_lifts(kits, tmp_path, source):
    _e2e(_degradation)(kits, tmp_path, source=source)


def _observe(K, tmp):
    mgr = _live_mgr(K, tmp, "engine:m", K.I.engine_detectors())
    asc = _AscSpy()
    r = K.R.FleetRemediator(api=_api_with(K, _deployment(K)), autoscaler=asc, config=_cfg(K))
    r.attach(mgr)
    mgr.feed("nan_guard", detail="nan in logits", trace_ids=[])
    mgr._process(time.monotonic())
    inc = mgr.list()[0]
    assert inc["cause"] == "unknown"
    r._process(time.monotonic())
    assert asc.calls == [] and r.quarantine.list() == {}
    assert mgr.get(inc["id"])["remediation"]["status"] == "observing"
    return _closed_bundle(K, mgr, tmp, inc["id"], "observe")


def test_e2e_unknown_cause_observes(kits, tmp_path):
    _e2e(_observe)(kits, tmp_path)


def test_fleet_remediation_endpoint_over_failover(kits):
    """Through the port's ServiceProxy and model server with live threads:
    a 500ing backend drives failover -> replica_death; the attached port
    remediator proposes a pre-warm floor (annotating the live bundle), the
    autoscaler applies it, and GET /fleet/remediation serves the action
    log and the proposals.  Zero human actions."""
    K = kits[PORT]
    from kubeflow_tpu_torch.serving.router import ServiceProxy
    from kubeflow_tpu_torch.serving.server import Model, ModelServer
    from kubeflow_tpu_torch.utils.net import find_free_ports

    class _Echo(Model):
        def load(self):
            self.ready = True

        def predict(self, payload, headers=None):
            return {"predictions": payload.get("instances", [])}

    class _Failing(Model):
        def load(self):
            self.ready = True

        def predict(self, payload, headers=None):
            raise RuntimeError("boom")

    api = K.APIServer()
    proxy = ServiceProxy(api)
    asc = K.ConcurrencyAutoscaler(api)
    rem = K.R.FleetRemediator(api=api, autoscaler=asc)
    proxy.attach_remediator(rem)
    srv_bad = ModelServer([_Failing("m")], port=0)
    srv_ok = ModelServer([_Echo("m")], port=0)
    srv_bad.start()
    srv_ok.start()
    svc_port = find_free_ports(1)[0]
    try:
        api.create(_service(K, extra_ann={K.PROXY_PORT_ANNOTATION: str(svc_port)}))
        api.create(_deployment(K, replicas=1))
        for i, port in enumerate((srv_bad.port, srv_ok.port)):
            api.create(_pod(K, f"svc-{i}", port=port))
        proxy.sync()
        rem.start()
        for i in range(6):
            req = urllib.request.Request(
                f"http://127.0.0.1:{svc_port}/v1/models/m:predict",
                data=json.dumps({"instances": [i]}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=30) as r:
                assert r.status == 200
        _wait(lambda: rem.status()["actions"], timeout=10.0, msg="remediation action")
        with urllib.request.urlopen(f"http://127.0.0.1:{svc_port}/fleet/remediation",
                                    timeout=30) as resp:
            body = json.loads(resp.read())
        assert body["human_actions"] == 0
        acts = [a for a in body["actions"] if a["playbook"] == "replace_replica"]
        assert acts and acts[0]["outcome"] == "executed"
        assert body["proposals"]["d"]["floor"] == 2
        mgr = proxy._states[("default", "svc")].incidents
        open_incs = [i for i in mgr.list() if i["state"] == "open"]
        assert open_incs[0]["cause"] == "replica_death"
        assert open_incs[0]["remediation"]["status"] == "in_flight"
        asc.sync()
        assert api.get("Deployment", "d")["spec"]["replicas"] == 2
    finally:
        rem.stop()
        proxy.shutdown()
        srv_bad.stop()
        srv_ok.stop()
