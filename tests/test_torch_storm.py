"""Port parity: the storm fault family and the storm through the ingress.

- ``storm_schedule`` draws the JAX package's arrival list, request by
  request (exact equality), for seeds 0-7 and for ``tests/test_overload.py``'s
  storm.
- The storm e2e of ``tests/test_overload.py`` through the port's
  ``ServiceProxy`` (the overload annotation at limit 4, rate 0) into a port
  replica serving the JAX package's tiny decoder weights (carried across by
  ``model.params_from_jax``), with the port's ``FleetRemediator`` attached
  (``attach_remediator``) and an autoscaler of the test's own that is never
  synced: every arrival answered 200 or 429 with Retry-After and a reason,
  shedding happens, every 200 carries its 8 tokens, the storm lands as ONE
  capacity incident from ``admission_pressure`` citing its shed total, the
  engine itself sheds and rejects nothing, and the remediator executes one
  ``prescale`` whose floor is the deployment's current replicas + 1, with no
  human action.
- The JAX package's own run of the same storm (its proxy, engine and
  remediator) holds to the same invariants; the per-request outcomes depend
  on timing and are not compared."""

from __future__ import annotations

import dataclasses
import importlib
import json
import threading
import time
import types
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

from kubeflow_tpu.serving.engine import faults as JF
from kubeflow_tpu.serving.engine import model as JM
from kubeflow_tpu_torch.serving.engine import faults as TF

pytestmark = pytest.mark.overload

# vocab >= 256: the port's byte tokenizer addresses ids 0..255
SHAPE = dict(vocab_size=288, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=128)
GEO = dict(max_slots=4, num_pages=256, page_size=8, max_pages_per_slot=20)
OVERLOAD = json.dumps({"limit": 4, "min_limit": 2, "rate": 0, "adjust_interval_s": 0.2,
                       "brownout": False})
STORM = dict(seed=7, duration_s=1.5, base_qps=40.0, burst_every_s=0.75, burst_len_s=0.25,
             burst_x=3.0, tenants=3, prompt_len_median=32, prompt_len_max=128, max_tokens=8)
SVC, DEPLOY = "ovl", "ovl-predictor-1"


@pytest.mark.parametrize("kw", [dict(seed=s) for s in range(8)] + [STORM],
                         ids=[f"seed{s}" for s in range(8)] + ["overload_test"])
def test_storm_schedule_is_the_reference_schedule(kw):
    port = TF.storm_schedule(TF.StormFaultConfig(**kw))
    ref = JF.storm_schedule(JF.StormFaultConfig(**kw))
    assert port and [dataclasses.asdict(a) for a in port] == [
        dataclasses.asdict(a) for a in ref]
    assert dataclasses.asdict(TF.StormFaultConfig(**kw)) == dataclasses.asdict(
        JF.StormFaultConfig(**kw))


def test_storm_schedule_is_a_pure_function_of_its_config():
    cfg = TF.StormFaultConfig(seed=3, duration_s=2.0)
    a, b = TF.storm_schedule(cfg), TF.storm_schedule(cfg)
    assert a == b
    assert [x.t_s for x in a] == sorted(x.t_s for x in a)
    assert all(x.t_s < cfg.duration_s and 4 <= x.prompt_len <= cfg.prompt_len_max
               for x in a)
    assert {x.priority for x in a} <= {n for n, _ in cfg.classes}


# ------------------------------------------------------------- the storm e2e


@pytest.fixture(scope="module")
def jax_params():
    return JM.init(jax.random.PRNGKey(0), JM.DecoderConfig(**SHAPE))


def _kit(pkg: str, jax_params) -> types.SimpleNamespace:
    def m(name):
        return importlib.import_module(f"{pkg}.{name}")

    eng_mod, model_mod = m("serving.engine.engine"), m("serving.engine.model")
    cfg = model_mod.DecoderConfig(**SHAPE)
    if pkg == "kubeflow_tpu_torch":
        params = model_mod.params_from_jax(
            {k: np.asarray(v) for k, v in jax_params.items()}, "cpu")

        def engine():
            return eng_mod.Engine(params, cfg, eng_mod.EngineConfig(**GEO), device="cpu")
    else:
        def engine():
            return eng_mod.Engine(jax_params, cfg, eng_mod.EngineConfig(**GEO))
    ctl, router = m("serving.controllers"), m("serving.router")
    return types.SimpleNamespace(
        APIServer=m("core.api").APIServer, ServiceProxy=router.ServiceProxy,
        OVERLOAD_ANNOTATION=router.OVERLOAD_ANNOTATION,
        LABEL_ISVC=m("serving.api").LABEL_ISVC,
        TARGET_CONCURRENCY_ANNOTATION=m("serving.api").TARGET_CONCURRENCY_ANNOTATION,
        POD_PORT_ANNOTATION=ctl.POD_PORT_ANNOTATION,
        PROXY_PORT_ANNOTATION=ctl.PROXY_PORT_ANNOTATION,
        DEPLOYMENT_FOR_SERVICE_ANNOTATION=ctl.DEPLOYMENT_FOR_SERVICE_ANNOTATION,
        JetStreamModel=m("serving.engine.serve").JetStreamModel,
        ModelServer=m("serving.server").ModelServer,
        ConcurrencyAutoscaler=m("serving.autoscaler").ConcurrencyAutoscaler,
        R=m("serving.remediator"), faults=m("serving.engine.faults"),
        find_free_ports=m("utils.net").find_free_ports, engine=engine)


def _post(port, payload, headers, timeout=120):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v2/models/{SVC}/generate", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", **headers})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, dict(r.headers), json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read())


def _wait(pred, timeout):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        got = pred()
        if got:
            return got
        time.sleep(0.05)
    return pred()


def storm_through_ingress(K) -> dict:
    """One package's storm e2e; returns its invariants."""
    api = K.APIServer()
    proxy = K.ServiceProxy(api)
    svc_port = K.find_free_ports(1)[0]
    api.create({"apiVersion": "v1", "kind": "Service",
                "metadata": {"name": SVC, "labels": {K.LABEL_ISVC: SVC},
                             "annotations": {K.PROXY_PORT_ANNOTATION: str(svc_port),
                                             K.OVERLOAD_ANNOTATION: OVERLOAD,
                                             K.DEPLOYMENT_FOR_SERVICE_ANNOTATION:
                                                 json.dumps([DEPLOY])}},
                "spec": {"selector": {"app": SVC}}})
    api.create({"apiVersion": "apps/v1", "kind": "Deployment",
                "metadata": {"name": DEPLOY,
                             "annotations": {K.TARGET_CONCURRENCY_ANNOTATION: "4"}},
                "spec": {"replicas": 1, "selector": {"matchLabels": {"app": SVC}},
                         "template": {"metadata": {"labels": {"app": SVC}},
                                      "spec": {"containers": [{"name": "c",
                                                               "command": ["x"]}]}}}})
    eng = K.engine()
    srv = K.ModelServer([K.JetStreamModel(SVC, "", engine=eng)], port=0)
    srv.start()
    api.create({"apiVersion": "v1", "kind": "Pod",
                "metadata": {"name": f"{SVC}-0", "labels": {"app": SVC},
                             "annotations": {K.POD_PORT_ANNOTATION: str(srv.port)}},
                "spec": {},
                "status": {"phase": "Running",
                           "conditions": [{"type": "Ready", "status": "True"}]}})
    proxy.sync()
    # an autoscaler of the test's own, never synced: the proposed floor stays a
    # proposal
    rem = K.R.FleetRemediator(api=api, autoscaler=K.ConcurrencyAutoscaler(api))
    proxy.attach_remediator(rem)
    rem.start()
    try:
        storm = K.faults.storm_schedule(K.faults.StormFaultConfig(**STORM))
        results, lock = [], threading.Lock()

        def fire(arr):
            rec = _post(svc_port, {"text_input": "a" * arr.prompt_len,
                                   "parameters": {"max_tokens": arr.max_tokens,
                                                  "priority": arr.priority,
                                                  "deadline_s": 60.0}},
                        {"X-Tenant-Id": arr.tenant})
            with lock:
                results.append(rec)

        t0 = time.monotonic()
        threads = []
        for arr in storm:
            delay = t0 + arr.t_s - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            th = threading.Thread(target=fire, args=(arr,))
            th.start()
            threads.append(th)
        for th in threads:
            th.join(timeout=180)
        shed = [(h, b) for st, h, b in results if st == 429]
        oks = [b for st, _, b in results if st == 200]
        state = proxy._states[("default", SVC)]
        incs = _wait(lambda: [i for i in state.incidents.list() if i["cause"] == "capacity"],
                     10.0)
        acts = _wait(lambda: [a for a in rem.status()["actions"]
                              if a["playbook"] == "prescale"], 10.0)
        # re-read: the bundle carries the remediation once it is annotated
        incs = [i for i in state.incidents.list() if i["cause"] == "capacity"]
        with urllib.request.urlopen(f"http://127.0.0.1:{svc_port}/fleet/remediation",
                                    timeout=30) as r:
            body = json.loads(r.read())
        ev = (incs[0]["evidence"].get("overload") or {}) if incs else {}
        s = eng.stats
        return {
            "arrivals_over_40": len(storm) > 40,
            "all_answered": len(results) == len(storm),
            "codes": sorted({st for st, _, _ in results} | {200, 429}),
            "shed": bool(shed), "ok": bool(oks),
            "retry_after": all(float(h["Retry-After"]) > 0 for h, _ in shed),
            "reasons_known": all(b["reason"] in ("quota", "concurrency", "deadline")
                                 for _, b in shed),
            "tokens": sorted({b.get("tokens") for b in oks}),
            "capacity_incidents": len(incs),
            "detector": incs[0]["detector"] if incs else None,
            "shed_total_cited": ev.get("shed_total", 0) > 0 and "stage" in ev,
            "engine_shed_rejected": (s["requests_shed"], s["requests_rejected"]),
            "human_actions": body["human_actions"],
            "prescale": [(a["outcome"], [(p["deployment"], p["current"], p["proposed_floor"])
                                         for p in a["detail"].get("proposals", ())])
                         for a in acts],
            "proposal": body["proposals"].get(DEPLOY, {}).get("floor"),
            "bundle_playbook": ((incs[0].get("remediation") or {}).get("playbook")
                                if incs else None),
        }
    finally:
        rem.stop()
        proxy.shutdown()
        srv.stop()
        eng.stop(drain=False)


@pytest.fixture(scope="module")
def port_run(jax_params):
    return storm_through_ingress(_kit("kubeflow_tpu_torch", jax_params))


def test_storm_through_the_port_ingress_is_one_remediated_capacity_incident(port_run):
    want = {"arrivals_over_40": True, "all_answered": True, "codes": [200, 429],
            "shed": True, "ok": True, "retry_after": True, "reasons_known": True,
            "tokens": [8], "capacity_incidents": 1, "detector": "admission_pressure",
            "shed_total_cited": True, "engine_shed_rejected": (0, 0), "human_actions": 0,
            "prescale": [("executed", [(DEPLOY, 1, 2)])], "proposal": 2,
            "bundle_playbook": "prescale"}
    assert port_run == want


def test_storm_invariants_match_the_reference_run(port_run, jax_params):
    """The same storm through the JAX package's proxy, engine and
    remediator: the same invariants (not the same per-request outcomes)."""
    assert storm_through_ingress(_kit("kubeflow_tpu", jax_params)) == port_run
