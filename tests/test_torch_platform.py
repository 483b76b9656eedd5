"""Port parity: the port's platform (``platform/*``, ``core/authz.py``)
against the JAX package's.

Each scenario of tests/test_platform.py, and the two Pipelines web UI
scenarios of tests/test_pipelines.py, runs on both planes: the JAX package's
``Cluster(cpu_nodes=1)`` and the port's ``Cluster`` with one CPU node and one
GPU node of two cards, each with its own package's platform installed.  What
the two give must be equal:
  * the condition sequences of Profiles and Notebooks (chip_smoke's
    ``ConditionLog``), the objects the controllers create, the KFAM
    bindings, the authorizer's decisions, the dashboard's data;
  * the web UI's served HTML, once ports, uids and times are masked.
The only differences allowed are the accelerator fields the port's module
docstrings list: a notebook asks for ``nvidia.com/gpu`` cards (``gpus``)
where the reference's asks for ``google.com/tpu`` chips (``tpu_chips``), and
the dashboard and web UI count cards (``gpus_requested``, "GPUs") where the
reference counts chips.  A scenario that requests the accelerator requests
each plane's own (``ACCEL``); ``to_reference`` maps the port's words onto the
reference's before the two are compared.

Then the port on its own: a notebook with one card runs on the GPU node and
sees its card as ``CUDA_VISIBLE_DEVICES``; a Notebook manifest that carries
``google.com/tpu`` stays Pending with the scheduler's event naming it.
"""

import difflib
import json
import re
import urllib.error
import urllib.parse
import urllib.request
from types import SimpleNamespace

import pytest

import chip_smoke
from kubeflow_tpu.core import authz as jauthz
from kubeflow_tpu.core.cluster import Cluster as JCluster
from kubeflow_tpu.core.conditions import has_condition as j_has_condition
from kubeflow_tpu.katib import api as jkapi
from kubeflow_tpu.katib.obslog import ObservationStore as JStore
from kubeflow_tpu.katib.service import KatibService as JKatib
from kubeflow_tpu.pipelines import client as jpclient
from kubeflow_tpu.pipelines import dsl as jdsl
from kubeflow_tpu.platform import api as jpapi
from kubeflow_tpu.platform import controllers as jpc
from kubeflow_tpu.platform import dashboard as jdash
from kubeflow_tpu.platform import kfadm as jkfadm
from kubeflow_tpu.platform import kfam as jkfam
from kubeflow_tpu.platform import spawner as jspawner
from kubeflow_tpu.platform import webui as jwebui
from kubeflow_tpu_torch.core import authz as tauthz
from kubeflow_tpu_torch.core.cluster import Cluster as TCluster
from kubeflow_tpu_torch.core.conditions import has_condition as t_has_condition
from kubeflow_tpu_torch.core.events import events_for
from kubeflow_tpu_torch.katib import api as tkapi
from kubeflow_tpu_torch.katib.obslog import ObservationStore as TStore
from kubeflow_tpu_torch.katib.service import KatibService as TKatib
from kubeflow_tpu_torch.pipelines import client as tpclient
from kubeflow_tpu_torch.pipelines import dsl as tdsl
from kubeflow_tpu_torch.platform import api as tpapi
from kubeflow_tpu_torch.platform import controllers as tpc
from kubeflow_tpu_torch.platform import dashboard as tdash
from kubeflow_tpu_torch.platform import kfadm as tkfadm
from kubeflow_tpu_torch.platform import kfam as tkfam
from kubeflow_tpu_torch.platform import spawner as tspawner
from kubeflow_tpu_torch.platform import webui as twebui
from test_torch_pipelines_service import library

GPU_NODE = ("h100", "h100", 2)
PLANES = {
    "jax": SimpleNamespace(
        authz=jauthz, has_condition=j_has_condition, kapi=jkapi,
        Store=JStore, Katib=JKatib, pclient=jpclient, dsl=jdsl, papi=jpapi, pc=jpc,
        dash=jdash, kfadm=jkfadm, kfam=jkfam, spawner=jspawner, webui=jwebui,
        ACCEL="google.com/tpu", CARDS="tpu_chips"),
    "port": SimpleNamespace(
        authz=tauthz, has_condition=t_has_condition, kapi=tkapi,
        Store=TStore, Katib=TKatib, pclient=tpclient, dsl=tdsl, papi=tpapi, pc=tpc,
        dash=tdash, kfadm=tkfadm, kfam=tkfam, spawner=tspawner, webui=twebui,
        ACCEL="nvidia.com/gpu", CARDS="gpus"),
}
# the port's accelerator words -> the reference's (the module docstrings' list)
_REFERENCE_WORDS = [
    ("nvidia.com/gpu", "google.com/tpu"),
    ("gpus_requested", "tpu_chips_requested"),
    (" GPUs requested", " TPU chips requested"),
    (" GPUs</p>", " TPU chips</p>"),
    ("<label>gpus <select name='gpus'>", "<label>tpu_chips <select name='tpu_chips'>"),
    ('"gpus"', '"tpuChips"'),
    ("gpus ", "tpu_chips "),
]


def to_reference(value):
    """The port's result in the reference's accelerator words."""
    text = json.dumps(value, sort_keys=True)
    for port, ref in _REFERENCE_WORDS:
        text = text.replace(port, ref)
    return json.loads(text)


def new_cluster(plane: str):
    if plane == "jax":
        return JCluster(cpu_nodes=1)
    return TCluster(cpu_nodes=1, gpu_nodes=(GPU_NODE,))


def on_both(flow, cull_idle_seconds=0.6, platform=True) -> dict:
    """``flow(m, cluster)`` on a fresh cluster of each plane with its
    package's platform installed (the reference fixture's 0.6 s culler);
    returns both results, the port's in the reference's words."""
    got = {}
    for plane, m in PLANES.items():
        cluster = new_cluster(plane)
        try:
            if platform:
                m.pc.install(cluster.api, cluster.manager, cull_idle_seconds=cull_idle_seconds)
            got[plane] = flow(m, cluster)
        finally:
            cluster.shutdown()
    got["jax"] = json.loads(json.dumps(got["jax"], sort_keys=True))
    got["port"] = to_reference(got["port"])
    return got


def same(got: dict):
    if got["port"] != got["jax"]:
        a, b = (json.dumps(got[k], indent=1, sort_keys=True).splitlines()
                for k in ("jax", "port"))
        diff = "\n".join(difflib.unified_diff(a, b, "jax", "port", lineterm="", n=2))
        pytest.fail(f"the planes differ:\n{diff}")
    return got["port"]


def strip_meta(obj: dict) -> dict:
    """An object without what each run draws anew (uid, times, versions)."""
    obj = json.loads(json.dumps(obj))
    meta = obj.get("metadata", {})
    for k in ("uid", "resourceVersion", "creationTimestamp", "generation"):
        meta.pop(k, None)
    for ref in meta.get("ownerReferences", []):
        ref.pop("uid", None)
    return obj


_TIMES = re.compile(r"(active|culls in) \d+s")


def mask_html(page: str, cluster) -> str:
    """A page without what each run draws anew: object uids, the notebook
    rows' idle seconds."""
    try:
        runs = cluster.api.list("Workflow")
    except KeyError:  # no Pipelines plane installed
        runs = []
    for obj in runs:
        page = page.replace(obj["metadata"]["uid"], f"<uid of {obj['metadata']['name']}>")
    return _TIMES.sub(lambda m: f"{m.group(1)} <n>s", page)


def http(ui, path: str, user: str, data: dict = None):
    """(status, body, final url) of a GET, or a POST of ``data``."""
    body = urllib.parse.urlencode(data).encode() if data is not None else None
    req = urllib.request.Request(ui.url + path, data=body, headers={"kubeflow-userid": user})
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, r.read().decode(), r.url[len(ui.url):]
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode(), path


def conditions(cluster, kind: str) -> "chip_smoke.ConditionLog":
    return chip_smoke.ConditionLog(cluster.api, kind)


# ---------------------------------------------------------------- scenarios


def test_profile_provisions_namespace_rbac_quota():
    def flow(m, c):
        log = conditions(c, "Profile")
        c.api.create(m.papi.profile("team-ml", "alice@example.com",
                                    {"cpu": "16", m.ACCEL: "8"}))
        assert c.wait_for(lambda: m.has_condition(
            c.api.try_get("Profile", "team-ml").get("status", {}) or {}, m.papi.READY),
            timeout=10)
        made = {kind: [strip_meta(o) for o in c.api.list(kind, namespace="team-ml")]
                for kind in ("Role", "RoleBinding", "ServiceAccount", "AuthorizationPolicy",
                             "ResourceQuota")}
        ns = strip_meta(c.api.get("Namespace", "team-ml"))
        c.api.delete("Profile", "team-ml")
        c.settle(quiet=0.3)
        return {"conditions": log.read(), "namespace": ns, "made": made,
                "cascaded": c.api.try_get("Namespace", "team-ml") is None}

    got = same(on_both(flow))
    assert got["conditions"] == {"team-ml": [[], [["Ready", "True", "ProfileReady"]]]}
    assert got["made"]["ResourceQuota"][0]["spec"]["hard"]["google.com/tpu"] == "8"
    assert got["cascaded"]


def test_kfam_bindings_and_namespace_listing():
    def flow(m, c):
        c.api.create(m.papi.profile("ns-a", "owner@x.com"))
        c.api.create(m.papi.profile("ns-b", "other@x.com"))
        c.settle(quiet=0.2)
        kfam = m.kfam.AccessManagement(c.api)
        kfam.create_binding("ns-b", "owner@x.com", "edit")
        out = {"bindings": kfam.list_bindings("ns-b"),
               "namespaces": kfam.namespaces_for("owner@x.com")}
        kfam.delete_binding("ns-b", "owner@x.com", "edit")
        out["after_delete"] = kfam.namespaces_for("owner@x.com")
        for args in (("missing-ns", "x@x.com"), ("ns-a", "x@x.com", "owner")):
            with pytest.raises(Exception) as e:
                kfam.create_binding(*args)
            out.setdefault("refused", []).append([type(e.value).__name__, str(e.value)])
        return out

    got = same(on_both(flow))
    assert got["namespaces"] == ["ns-a", "ns-b"] and got["after_delete"] == ["ns-a"]
    assert {"user": "owner@x.com", "role": "edit"} in got["bindings"]


def test_notebook_runs_and_culls():
    """Ready, culled to zero (its pod gone), touched back to Ready: the
    Notebook's condition sequence and the StatefulSet's replicas."""

    def flow(m, c):
        log = conditions(c, "Notebook")
        spawner = m.spawner.Spawner(c.api)
        nb = spawner.spawn("nb1", "default", cpu="1", memory="2Gi")

        def has(cond):
            return lambda: m.has_condition(c.api.get("Notebook", "nb1").get("status", {}), cond)

        out = {"annotated": sorted(nb["metadata"]["annotations"])}
        assert c.wait_for(has(m.papi.READY), timeout=20)
        out["ready"] = {"sts": c.api.get("StatefulSet", "nb1")["status"],
                        "service": strip_meta(c.api.get("Service", "nb1"))}
        assert c.wait_for(has(m.papi.CULLED), timeout=20)
        c.settle(quiet=0.3)
        out["culled_pod"] = c.api.try_get("Pod", "nb1-0")
        spawner.touch("nb1", "default")
        assert c.wait_for(has(m.papi.READY), timeout=20)
        out["touched_pod"] = c.api.try_get("Pod", "nb1-0") is not None
        out["culled_events"] = sorted({e["reason"] for e in events_for(
            c.api, c.api.get("Notebook", "nb1"))})
        out["conditions"] = log.read()
        return out

    got = same(on_both(flow))
    assert got["culled_pod"] is None and got["touched_pod"]
    assert got["conditions"]["nb1"][-1] == [["Ready", "True", "NotebookRunning"],
                                           ["Culled", "False", "Active"]]


def test_spawner_validates_form():
    def flow(m, c):
        spawner = m.spawner.Spawner(c.api)
        cm = strip_meta(c.api.get("ConfigMap", "spawner-ui-config", "kubeflow"))
        cm["data"] = {k: json.loads(v) for k, v in cm["data"].items()}
        out = {"options": spawner.options(), "configmap": cm}
        for kw in ({"image": "bogus:latest"}, {m.CARDS: 3}, {"cpu": "3"},
                   {"memory": "3Gi"}):
            with pytest.raises(ValueError) as e:
                spawner.spawn("nb2", "default", **kw)
            out.setdefault("refused", []).append(str(e.value))
        out["created"] = c.api.try_get("Notebook", "nb2")
        return out

    got = same(on_both(flow))
    assert 8 in got["options"]["tpuChips"] and got["created"] is None
    assert got["refused"][1] == "tpu_chips 3 not in [0, 1, 4, 8]"


def test_poddefaults_injects_env_and_volumes():
    def flow(m, c):
        c.api.create(m.papi.pod_default(
            "tpu-cache", "default", selector={"matchLabels": {"inject-tpu-cache": "true"}},
            env={"JAX_COMPILATION_CACHE_DIR": "/cache/jax"},
            volumes=[{"name": "cache", "emptyDir": {}}],
            volume_mounts=[{"name": "cache", "mountPath": "/cache"}]))
        pod = c.api.create({
            "apiVersion": "v1", "kind": "Pod",
            "metadata": {"name": "p1", "labels": {"inject-tpu-cache": "true"}},
            "spec": {"containers": [{"name": "main", "command": ["true"], "env": []}]}})
        pod2 = c.api.create({
            "apiVersion": "v1", "kind": "Pod", "metadata": {"name": "p2"},
            "spec": {"containers": [{"name": "main", "command": ["true"]}]}})
        return {"p1": pod["spec"], "p2": pod2["spec"]}

    got = same(on_both(flow))
    assert got["p1"]["volumes"] == [{"name": "cache", "emptyDir": {}}]
    assert not got["p2"]["containers"][0].get("env")


def test_dashboard_aggregates():
    def flow(m, c):
        c.api.create(m.papi.profile("dash-ns", "dash@x.com"))
        c.settle(quiet=0.2)
        m.spawner.Spawner(c.api).spawn("nb-dash", "dash-ns")
        c.settle(quiet=0.2)
        dash = m.dash.Dashboard(c.api)
        out = {"namespaces": dash.namespaces("dash@x.com")}
        summary = dash.summary("dash-ns")
        out["summary"] = {k: [v["count"], [i["name"] for i in v["items"]]]
                          for k, v in summary["resources"].items()}
        out["activity"] = isinstance(dash.activity("dash-ns"), list)
        assert c.wait_for(lambda: c.api.list("Pod", namespace="dash-ns") == [], timeout=30)
        c.api.create({
            "apiVersion": "v1", "kind": "Pod",
            "metadata": {"name": "quota-probe", "namespace": "dash-ns"},
            "spec": {"containers": [{
                "name": "c", "command": ["sleep", "9"],
                "resources": {"requests": {"cpu": "500m", "memory": "1Gi", m.ACCEL: 4},
                              "limits": {m.ACCEL: 4}}}]}})
        out["quota"] = dash.quota("dash-ns")
        ov = dash.overview("dash@x.com")
        for card in ov["namespaces"]:
            card.pop("running")  # the 0.6 s culler races the notebook's Ready
        ov["totals"].pop("running")
        out["overview"] = ov
        for i, n in enumerate(("8", "4")):
            c.api.create({"apiVersion": "v1", "kind": "ResourceQuota",
                          "metadata": {"name": f"rq-extra-{i}", "namespace": "dash-ns"},
                          "spec": {"hard": {m.ACCEL: n}}})
        out["hard"] = dash.quota("dash-ns")["hard"]
        return out

    got = same(on_both(flow))
    assert got["quota"]["used"]["cpu"] == 0.5 and got["quota"]["used"]["memory"] == 2**30
    assert got["overview"]["namespaces"][0]["tpu_chips_requested"] == 4.0
    assert got["hard"] == {"google.com/tpu": "4"}


def test_kfadm_full_platform_bringup():
    """One KfDef apply installs all five planes of each package; every
    pillar's CRDs are registered; a re-apply is idempotent; the platform
    reconciles a Profile."""

    def flow(m, c):
        adm = m.kfadm.KfAdm(c)
        obj = adm.apply(m.kfadm.kfdef(applications=("platform", "training", "katib",
                                                     "serving", "pipelines")))
        for kind in ("Profile", "Notebook", "PodDefault", "TPUJob", "Experiment",
                     "InferenceService", "Workflow", "ScheduledWorkflow"):
            c.api.crd_for(kind)
        again = adm.apply(m.kfadm.kfdef())
        c.api.create(m.papi.profile("kfadm-ns", "kfadm@x.com"))
        reconciled = c.wait_for(lambda: c.api.try_get("Namespace", "kfadm-ns") is not None,
                                timeout=10)
        with pytest.raises(Exception) as e:
            c.api.create(m.kfadm.kfdef("bad", applications=("platform", "mlflow")))
        return {"status": obj["status"], "again": again["status"], "reconciled": reconciled,
                "installed": sorted(adm.installed), "refused": str(e.value)}

    got = same(on_both(flow, platform=False))
    assert got["status"]["phase"] == "Ready" and got["reconciled"]
    assert got["installed"] == ["katib", "pipelines", "platform", "serving", "training"]
    assert all(a["status"] == "Ready" for a in got["again"]["applications"])


def test_kfadm_installs_the_ports_planes():
    """The port's KfAdm wires the port's controllers: a pipeline step pod
    runs the port's launcher, the serving catalog the port's runtime."""
    c = new_cluster("port")
    try:
        adm = tkfadm.KfAdm(c)
        adm.apply(tkfadm.kfdef())
        assert type(adm.installed["pipelines"]).__module__ == (
            "kubeflow_tpu_torch.pipelines.service")
        rt = c.api.get("ClusterServingRuntime", "kserve-jetstream")
        assert rt["spec"]["containers"][0]["command"][1:] == [
            "-m", "kubeflow_tpu_torch.serving.runtime_main"]
        mods = {type(ctl.reconciler).__module__ for ctl in c.manager.controllers}
        assert not any(mod.startswith("kubeflow_tpu.") for mod in mods), mods
        assert {mod.split(".")[1] for mod in mods} >= {
            "platform", "training", "katib", "serving", "pipelines"}, mods
    finally:
        c.shutdown()


def test_profile_rbac_authorizer_and_authenticated_api():
    def flow(m, c):
        c.apply({"apiVersion": "kubeflow.org/v1", "kind": "Profile",
                 "metadata": {"name": "team-a"},
                 "spec": {"owner": {"kind": "User", "name": "alice@corp.io"}}})
        c.settle()
        m.kfam.AccessManagement(c.api).create_binding("team-a", "bob@corp.io", "view")
        authz = m.authz.ProfileRBACAuthorizer(c.api, cluster_admins=["root@corp.io"])
        notebook = {"apiVersion": "kubeflow.org/v1", "kind": "Notebook",
                    "metadata": {"name": "nb", "namespace": "team-a"},
                    "spec": {"template": {"spec": {"containers": [
                        {"name": "nb", "command": ["sleep", "1"]}]}}}}
        users = {u: m.authz.AuthenticatedAPI(c.api, u, authz)
                 for u in ("alice@corp.io", "bob@corp.io", "eve@corp.io", "root@corp.io")}
        out = {"decisions": {}}

        def attempt(key, fn):
            try:
                r = fn()
                out[key] = (r["metadata"]["name"] if isinstance(r, dict) else
                            [o["metadata"]["name"] for o in r] if isinstance(r, list) else r)
            except m.authz.Forbidden as e:
                out[key] = ["Forbidden", str(e)]

        attempt("alice_create", lambda: users["alice@corp.io"].create(notebook))
        attempt("alice_get", lambda: users["alice@corp.io"].get("Notebook", "nb", "team-a"))
        attempt("bob_list", lambda: users["bob@corp.io"].list("Notebook", "team-a"))
        attempt("bob_delete", lambda: users["bob@corp.io"].delete("Notebook", "nb", "team-a"))
        attempt("eve_list", lambda: users["eve@corp.io"].list("Notebook", "team-a"))
        attempt("eve_profiles", lambda: users["eve@corp.io"].list("Profile"))
        attempt("eve_create_profile", lambda: users["eve@corp.io"].create({
            "apiVersion": "kubeflow.org/v1", "kind": "Profile",
            "metadata": {"name": "eve-land"},
            "spec": {"owner": {"kind": "User", "name": "eve@corp.io"}}}))
        attempt("bob_all", lambda: users["bob@corp.io"].list("Notebook", namespace=None))
        attempt("eve_all", lambda: users["eve@corp.io"].list("Notebook", namespace=None))
        attempt("root_delete", lambda: users["root@corp.io"].delete("Notebook", "nb", "team-a"))
        for u in users:
            for verb in ("get", "list", "create", "delete"):
                for ns in ("team-a", "default", None):
                    out["decisions"][f"{u} {verb} {ns}"] = authz.authorize(
                        u, verb, "Notebook" if ns else "Profile", ns)
            out["decisions"][f"{u} roles"] = sorted(authz.roles_for(u, "team-a"))
        return out

    got = same(on_both(flow))
    assert got["alice_create"] == "nb" and got["bob_list"] == ["nb"]
    assert got["bob_delete"][0] == "Forbidden" and got["eve_all"] == []


def test_dashboard_composes_with_authenticated_api():
    def flow(m, c):
        c.apply(m.papi.profile("own-ns", "owner@x.io", {"cpu": "8", m.ACCEL: "8"}))
        c.settle()
        authz = m.authz.ProfileRBACAuthorizer(c.api)
        dash = m.dash.Dashboard(m.authz.AuthenticatedAPI(c.api, "owner@x.io", authz))
        stranger = m.dash.Dashboard(m.authz.AuthenticatedAPI(c.api, "eve@x.io", authz))
        return {"summary": dash.summary("own-ns"), "quota": dash.quota("own-ns"),
                "stranger": stranger.summary("own-ns"),
                "stranger_quota": stranger.quota("own-ns")}

    got = same(on_both(flow))
    assert got["quota"]["hard"] == {"cpu": "8", "google.com/tpu": "8"}
    assert got["stranger_quota"] == {"namespace": "own-ns", "hard": {}, "used": {}}


# ---------------------------------------------------------------- web shell


def test_webui_serves_overview_namespace_and_403():
    def flow(m, c):
        c.apply(m.papi.profile("web-ns", "web@x.io", {"cpu": "8", m.ACCEL: "8"}))
        c.settle(quiet=0.3)
        m.spawner.Spawner(c.api).spawn("nb-web", "web-ns")
        c.settle(quiet=0.3)
        ui = m.webui.DashboardWebUI(c.api)
        try:
            pages = {p: http(ui, p, u) for p, u in (
                ("/", "web@x.io"), ("/ns/web-ns", "eve@x.io"),
                ("/ns/nonexistent/bogus/x", "web@x.io"), ("/healthz", "web@x.io"))}
            ns = http(ui, "/ns/web-ns", "web@x.io")
        finally:
            ui.shutdown()
        # the namespace page's notebook row and activity race the 0.6 s
        # culler: compared by what must be on it
        return {"pages": {p: [s, mask_html(b, c)] for p, (s, b, _) in pages.items()},
                "ns": [ns[0], all(w in ns[1] for w in ("nb-web", "Notebook", m.ACCEL))]}

    got = same(on_both(flow, cull_idle_seconds=3600.0))
    assert got["pages"]["/"][0] == 200 and "Signed in as" in got["pages"]["/"][1]
    assert "0 TPU chips requested" in got["pages"]["/"][1]
    assert got["pages"]["/ns/web-ns"][0] == 403
    assert got["pages"]["/ns/nonexistent/bogus/x"][0] == 404
    assert got["ns"] == [200, True]


def test_webui_namespace_page_and_cull_status():
    """The namespace page, notebook row and quota table, then the culled
    row, with a culler that never fires on its own."""

    def flow(m, c):
        c.apply(m.papi.profile("cull-ns", "cull@x.io", {"cpu": "8", m.ACCEL: "8"}))
        c.settle(quiet=0.3)
        m.spawner.Spawner(c.api).spawn("nb-live", "cull-ns")
        assert c.wait_for(lambda: m.has_condition(
            c.api.get("Notebook", "nb-live", "cull-ns").get("status", {}), m.papi.READY),
            timeout=20)
        c.settle(quiet=0.3)
        ui = m.webui.DashboardWebUI(c.api, cull_idle_seconds=3600.0)
        try:
            live = http(ui, "/ns/cull-ns", "cull@x.io")
            c.api.patch("Notebook", "nb-live",
                        {"metadata": {"annotations": {m.papi.CULLED_ANNOTATION: "true"}}},
                        "cull-ns")
            culled = http(ui, "/ns/cull-ns", "cull@x.io")
        finally:
            ui.shutdown()
        return {"live": [live[0], mask_html(live[1], c)],
                "culled": [culled[0], "culled (idle)" in culled[1]]}

    got = same(on_both(flow, cull_idle_seconds=3600.0))
    assert got["live"][0] == 200 and "culls in <n>s" in got["live"][1]
    assert "google.com/tpu" in got["live"][1] and "nb-live" in got["live"][1]
    assert got["culled"] == [200, True]


def test_webui_experiment_page_renders_trials():
    def flow(m, c):
        m.kapi.register(c.api)
        c.apply(m.papi.profile("kat-ns", "kat@x.io"))
        c.settle(quiet=0.3)
        c.api.create({
            "apiVersion": "kubeflow.org/v1beta1", "kind": "Experiment",
            "metadata": {"name": "sweep", "namespace": "kat-ns"},
            "spec": {"algorithm": {"algorithmName": "grid"},
                     "parameters": [{"name": "lr", "parameterType": "double",
                                     "feasibleSpace": {"min": "0.01", "max": "1.0"}}],
                     "objective": {"type": "maximize", "objectiveMetricName": "accuracy"},
                     "trialTemplate": {"trialSpec": {
                         "apiVersion": "v1", "kind": "Pod",
                         "spec": {"containers": [{"name": "main"}]}}}}})
        c.api.create({
            "apiVersion": "kubeflow.org/v1beta1", "kind": "Trial",
            "metadata": {"name": "sweep-t0", "namespace": "kat-ns",
                         "labels": {m.kapi.LABEL_EXPERIMENT: "sweep"}},
            "spec": {"parameterAssignments": [{"name": "lr", "value": "0.1"}]},
            "status": {"observation": {"metrics": [{"name": "accuracy", "latest": 0.9}]}}})
        store = m.Store()
        for step, v in enumerate([0.2, 0.5, 0.8, 0.9]):
            store.report("sweep-t0", "accuracy", step, v)
        ui = m.webui.DashboardWebUI(c.api, katib_service=m.Katib(c.api, store))
        try:
            return [http(ui, "/ns/kat-ns/experiments/sweep", "kat@x.io")[:2],
                    http(ui, "/ns/kat-ns/experiments/ghost", "kat@x.io")[0]]
        finally:
            ui.shutdown()
            store.close()

    (status, page), ghost = same(on_both(flow))
    assert status == 200 and ghost == 404
    assert "sweep-t0" in page and "lr=0.1" in page and "<svg" in page


def test_webui_spawner_form_launches_notebook():
    def flow(m, c):
        c.apply(m.papi.profile("spawn-ns", "spawn@x.io", {"cpu": "8", m.ACCEL: "8"}))
        c.settle(quiet=0.3)
        ui = m.webui.DashboardWebUI(c.api, spawner=m.spawner.Spawner(c.api))
        data = {"name": "nb-form", "image": "jupyter-tpu:v5e", "cpu": "1",
                "memory": "2Gi", m.CARDS: "4"}
        try:
            form = http(ui, "/ns/spawn-ns/spawn", "spawn@x.io")
            posted = http(ui, "/ns/spawn-ns/spawn", "spawn@x.io", data)
            nb = c.api.get("Notebook", "nb-form", "spawn-ns")
            stranger = http(ui, "/ns/spawn-ns/spawn", "eve@x.io", {**data, "name": "nb-eve"})
            bad = http(ui, "/ns/spawn-ns/spawn", "spawn@x.io", {**data, m.CARDS: "3"})
        finally:
            ui.shutdown()
        return {"form": list(form[:2]), "posted": [posted[0], posted[2], "nb-form" in posted[1]],
                "limits": nb["spec"]["template"]["spec"]["containers"][0]["resources"],
                "stranger": stranger[:2], "bad": bad[:2],
                "eve_nb": c.api.try_get("Notebook", "nb-eve", "spawn-ns")}

    got = same(on_both(flow))
    assert got["form"][0] == 200 and "tpu_chips" in got["form"][1]
    assert got["posted"] == [200, "/ns/spawn-ns", True]
    assert got["limits"]["limits"]["google.com/tpu"] == 4
    assert got["stranger"][0] == 403 and got["eve_nb"] is None
    assert got["bad"][0] == 400


def test_webui_experiment_create_form():
    def flow(m, c):
        m.kapi.register(c.api)
        c.apply(m.papi.profile("form-ns", "form@x.io"))
        c.settle(quiet=0.3)
        store = m.Store(":memory:")
        ui = m.webui.DashboardWebUI(c.api, katib_service=m.Katib(c.api, store))
        data = {"name": "web-sweep", "metric": "accuracy", "type": "maximize", "goal": "0.95",
                "algorithm": "random", "max_trials": "4", "parallel_trials": "2",
                "parameters": json.dumps([{"name": "lr", "parameterType": "double",
                                           "feasibleSpace": {"min": 0.1, "max": 0.9}}]),
                "trial_spec": json.dumps({"apiVersion": "v1", "kind": "Pod", "spec": {
                    "containers": [{"name": "main",
                                    "command": ["echo", "${trialParameters.lr}"]}]}})}
        try:
            out = {"form": http(ui, "/ns/form-ns/experiments/new", "form@x.io")[:2],
                   "posted": http(ui, "/ns/form-ns/experiments/new", "form@x.io", data)}
            exp = strip_meta(c.api.get("Experiment", "web-sweep", "form-ns"))
            out["spec"] = exp["spec"]
            for key, form in (("bad", {"name": "bad", "metric": "m", "parameters": "not json",
                                       "trial_spec": "{}"}),
                              ("shape", {"name": "shape", "metric": "m", "parameters": "[1]",
                                         "trial_spec": "{}"}),
                              ("reserved", {"name": "new", "metric": "m",
                                            "parameters": m.webui.DashboardWebUI._DEFAULT_PARAMS,
                                            "trial_spec": m.webui.DashboardWebUI._DEFAULT_TRIAL})):
                out[key] = http(ui, "/ns/form-ns/experiments/new", "form@x.io", form)[:2]
            out["stranger"] = [http(ui, "/ns/form-ns/experiments/new", "eve@x.io", d)[0]
                               for d in (None, data)]
            out["created"] = sorted(e["metadata"]["name"] for e in
                                    c.api.list("Experiment", namespace="form-ns"))
        finally:
            ui.shutdown()
            store.close()
        return out

    got = same(on_both(flow))
    assert got["posted"][2] == "/ns/form-ns/experiments/web-sweep"
    assert got["spec"]["objective"]["goal"] == 0.95 and got["spec"]["maxTrialCount"] == 4
    assert [got[k][0] for k in ("bad", "shape", "reserved")] == [400, 400, 400]
    assert got["stranger"] == [403, 403] and got["created"] == ["web-sweep"]


# --------------------------------------------------- Pipelines web UI (KFP)


def _pipelines_ui(m, c, lrs: tuple):
    """``train_and_deploy`` run at each of ``lrs`` (rows 25), then the web UI
    with the Pipelines service."""
    lib = library(m.dsl)
    client = m.pclient.Client(c)
    runs = []
    for i, lr in enumerate(lrs):
        rec = client.create_run_from_pipeline_func(
            lib.train_and_deploy, arguments={"rows": 25, "lr": lr},
            run_name=f"run-{i}").wait(timeout=90)
        assert rec["phase"] == "Succeeded"
        runs.append(f"run-{i}")
    return runs, m.webui.DashboardWebUI(c.api, pipeline_service=client.service,
                                        cluster_admins=("admin@x.io",))


def test_webui_pipelines_and_run_graph():
    """/pipelines lists the run, /runs/<id> renders the DAG with the phases,
    and namespace RBAC filters what each user sees."""

    def flow(m, c):
        runs, ui = _pipelines_ui(m, c, (0.5,))
        try:
            pages = {f"{u} {p}": http(ui, p, u)[:2] for u, p in (
                ("admin@x.io", "/pipelines"), ("admin@x.io", f"/runs/{runs[0]}"),
                ("nobody@x.io", "/pipelines"), ("nobody@x.io", f"/runs/{runs[0]}"),
                ("admin@x.io", "/runs/ghost-run"), ("admin@x.io", "/"))}
        finally:
            ui.shutdown()
        return {k: [s, mask_html(b, c)] for k, (s, b) in pages.items()}

    got = same(on_both(flow, platform=False))
    listing, graph = got["admin@x.io /pipelines"], got["admin@x.io /runs/run-0"]
    assert listing[0] == 200 and "run-0" in listing[1] and "train-and-deploy" in listing[1]
    assert "<svg" in graph[1] and "phase-Succeeded" in graph[1] and graph[1].count("<line") >= 2
    assert "run-0" not in got["nobody@x.io /pipelines"][1]
    assert got["nobody@x.io /runs/run-0"][0] == 403
    assert got["admin@x.io /runs/ghost-run"][0] == 404


def test_webui_run_artifacts_and_compare():
    """A run page's artifacts and metrics; /compare of two runs side by side;
    the same RBAC."""

    def flow(m, c):
        runs, ui = _pipelines_ui(m, c, (0.5, 0.9))
        both = "&".join(f"runs={r}" for r in runs)
        try:
            pages = {f"{u} {p}": http(ui, p, u)[:2] for u, p in (
                ("admin@x.io", f"/runs/{runs[0]}"), ("admin@x.io", "/pipelines"),
                ("admin@x.io", f"/compare?{both}"), ("admin@x.io", f"/compare?runs={runs[0]}"),
                ("nobody@x.io", f"/compare?{both}"),
                ("admin@x.io", "/compare?runs=ghost&runs=ghost2"))}
        finally:
            ui.shutdown()
        return {k: [s, mask_html(b, c)] for k, (s, b) in pages.items()}

    got = same(on_both(flow, platform=False))
    page = got["admin@x.io /runs/run-0"][1]
    assert "system.Metrics" in page and "weights lr=0.5" in page and "mstore://" in page
    cmp_page = got["admin@x.io /compare?runs=run-0&runs=run-1"][1]
    assert "arg lr" in cmp_page and "train/accuracy" in cmp_page
    assert cmp_page.count("class='phase-Succeeded'") == 2
    assert "at least two" in got["admin@x.io /compare?runs=run-0"][1]
    assert got["nobody@x.io /compare?runs=run-0&runs=run-1"][0] == 403
    assert got["admin@x.io /compare?runs=ghost&runs=ghost2"][0] == 404


# ------------------------------------------------------------ the port alone


def test_notebook_gets_a_card_and_a_tpu_notebook_stays_pending(monkeypatch):
    """A spawner notebook with one card runs on the GPU node and sees card
    0; a Notebook manifest carrying ``google.com/tpu`` (the reference
    helper's) is Pending with the scheduler's event naming it, and its
    Notebook never Ready."""
    c = new_cluster("port")
    try:
        tpc.install(c.api, c.manager)
        spawner = tspawner.Spawner(c.api)
        spawner.spawn("nb-card", "default", gpus=1, command=[
            "python", "-c", "import os, time; print('CARDS', os.environ['CUDA_VISIBLE_DEVICES'],"
            " flush=True); time.sleep(60)"])
        tpu_nb = jpapi.notebook("nb-tpu", "default", ["sleep", "60"], tpu_chips=4)
        c.api.create(tpu_nb)
        assert c.wait_for(lambda: t_has_condition(
            c.api.get("Notebook", "nb-card").get("status", {}), tpapi.READY), timeout=30)
        assert c.wait_for(lambda: "CARDS" in c.logs("nb-card-0"), timeout=30)

        def refused():
            p = c.api.try_get("Pod", "nb-tpu-0")
            return p is not None and any(e["reason"] == "FailedScheduling"
                                         for e in events_for(c.api, p))

        assert c.wait_for(refused, timeout=30)
        pod = c.api.get("Pod", "nb-card-0")
        assert pod["spec"]["nodeName"] == GPU_NODE[0]
        assert "CARDS 0" in c.logs("nb-card-0")
        tpod = c.api.get("Pod", "nb-tpu-0")
        assert not tpod["spec"].get("nodeName")
        msgs = [e["message"] for e in events_for(c.api, tpod) if e["reason"] == "FailedScheduling"]
        assert any("google.com/tpu" in msg for msg in msgs), msgs
        assert not t_has_condition(c.api.get("Notebook", "nb-tpu").get("status", {}),
                                   tpapi.READY)
        ov = tdash.Dashboard(c.api).overview("nobody@x.io")
        assert ov["totals"]["gpus_requested"] == 0.0  # no namespace of this user
        assert tdash.Dashboard(c.api)._used("default")["nvidia.com/gpu"] == 1.0
    finally:
        c.shutdown()
