"""Port parity: the port's training operator against the JAX package's.

Each scenario of tests/test_training_jobs.py runs its manifest on both
control planes: the JAX package's ``Cluster(cpu_nodes=1)`` and the port's
``Cluster`` with one CPU node and one GPU node of two cards (each its own
in-process cluster whose pods are real processes).  What the two give must
be equal:
  * the pods' names, labels, nodes and rendezvous env (the ports the
    operator allocated masked, since each run draws its own);
  * the job's condition states in order, its restart count and the
    controller's events;
  * TTL and clean-pod behaviour, elastic shrink and scale-up.
Where a scenario runs a workload (the BERT worker, ``distributed_check``),
each plane runs its own package's worker, or both run the port's.

Then the port's plane on its own: ``spec.tpu`` refused (the pods Pending
with the scheduler's event naming ``google.com/tpu``, the job never
Running), a worker's card from its ``nvidia.com/gpu`` request as
``CUDA_VISIBLE_DEVICES``, MPIJob through the port's ``mpirun``, and the
gang restart's condition states that chip_smoke.py's phase 22(a) holds the
card's run to.  Scenarios marked ``slow`` in the reference stay ``slow``.
"""

import json
import os
import re
import sys

import pytest

import chip_smoke
from kubeflow_tpu.core.api import Invalid as JInvalid
from kubeflow_tpu.core.cluster import Cluster as JCluster
from kubeflow_tpu.core.conditions import get_condition as jget_condition
from kubeflow_tpu.training import api as japi
from kubeflow_tpu.training import frameworks as jfw
from kubeflow_tpu.training.client import TrainingClient as JClient
from kubeflow_tpu_torch.core.api import Invalid as TInvalid
from kubeflow_tpu_torch.core.cluster import Cluster as TCluster
from kubeflow_tpu_torch.core.events import events_for
from kubeflow_tpu_torch.training import api as tapi
from kubeflow_tpu_torch.training import common as tcommon
from kubeflow_tpu_torch.training import frameworks as tfw
from kubeflow_tpu_torch.training.api import ReplicaSpec, TPUSpec, job
from kubeflow_tpu_torch.training.client import TrainingClient as TClient
from kubeflow_tpu_torch.tools.mpi import ensure_mpirun

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PY = sys.executable
GPU_NODE = ("h100", "h100", 2)
# what the worker processes print of their environment (JSON)
PRINT_ENV = ("import os, json, time; print(json.dumps({k: v for k, v in os.environ.items() "
             "if k.startswith(('JAX_', 'TPU_', 'MEGASCALE_', 'MASTER_', 'RANK', 'WORLD_', "
             "'LOCAL_RANK', 'TRANSPORT_', 'TF_CONFIG', 'CHECKPOINT_', 'PET_', 'MPI_', "
             "'OMPI_', 'DMLC_', 'PADDLE_', 'TRAINING_ROLE'))}), flush=True); time.sleep(1.0)")


def _cluster(plane: str, **kw) -> tuple:
    if plane == "jax":
        c = JCluster(cpu_nodes=1, **kw)
        jfw.install(c.api, c.manager)
        return c, JClient(c)
    c = TCluster(cpu_nodes=1, gpu_nodes=(GPU_NODE,), **kw)
    tfw.install(c.api, c.manager)
    return c, TClient(c)


def _mask(text: str, ports: list) -> str:
    for p in ports:
        text = re.sub(rf"\b{p}\b", "<port>", text)
    return text


def _ports(c, kind: str, name: str) -> list:
    obj = c.api.try_get(kind, name)
    raw = (obj or {}).get("metadata", {}).get("annotations", {}).get(tcommon.PORTS_ANNOTATION)
    return [str(p) for p in json.loads(raw)] if raw else []


def _pods(c, name: str, ports: list) -> dict:
    """The job's pods: labels, node, restart policy and env (ports masked)."""
    out = {}
    for p in c.api.list("Pod", label_selector={tapi.LABEL_JOB_NAME: name}):
        containers = p["spec"]["containers"]
        out[p["metadata"]["name"]] = {
            "labels": p["metadata"].get("labels", {}),
            "node": p["spec"].get("nodeName"),
            "restartPolicy": p["spec"].get("restartPolicy"),
            "env": [[_mask(json.dumps(e), ports) for e in ct.get("env", [])]
                    for ct in containers],
            "volumes": p["spec"].get("volumes"),
        }
    return out


def _events(c, kind: str, name: str) -> list:
    """The controller's events on the job: (reason, message), sorted."""
    obj = c.api.try_get(kind, name)
    if obj is None:
        return []
    comp = f"{kind.lower()}-controller"
    return sorted((e["reason"], e["message"]) for e in events_for(c.api, obj)
                  if e.get("source", {}).get("component") == comp)


def _env_lines(c, pod: str, ports: list) -> list:
    """The JSON env lines a pod printed, ports masked."""
    return [json.loads(_mask(x, ports)) for x in c.logs(pod).splitlines()
            if x.startswith("{")]


def _job_view(c, client, kind: str, name: str, conds: chip_smoke.ConditionLog) -> dict:
    ports = _ports(c, kind, name)
    j = client.get_job(kind, name) or {}
    st = j.get("status", {})
    return {"conditions": conds.read().get(name), "restartCount": st.get("restartCount"),
            "elasticReplicas": st.get("elasticReplicas"), "events": _events(c, kind, name),
            "pods": _pods(c, name, ports)}


def _both(flow, **cluster_kw) -> dict:
    """``flow(plane, cluster, client)`` on each plane; returns both views."""
    got = {}
    for plane in ("jax", "port"):
        c, client = _cluster(plane, **cluster_kw)
        try:
            got[plane] = flow(plane, c, client)
        finally:
            c.shutdown()
    return got


def _assert_same(got: dict) -> dict:
    assert got["port"] == got["jax"]
    return got["port"]


def _run_job(spec: dict, timeout: float = 60, expect: str = tapi.SUCCEEDED):
    """A flow that applies ``spec``, waits for it to end and reads it."""
    kind, name = spec["kind"], spec["metadata"]["name"]

    def flow(plane, c, client):
        conds = chip_smoke.ConditionLog(c.api, kind)
        client.create_job(json.loads(json.dumps(spec)))
        assert client.wait_for_job(kind, name, timeout=timeout) == expect
        c.settle(quiet=0.2, timeout=10)
        view = _job_view(c, client, kind, name, conds)
        view["logs"] = {p: _env_lines(c, p, _ports(c, kind, name)) for p in view["pods"]}
        return view
    return flow


# ------------------------------------------------------------ API and builders


def test_builders_and_api_constants_match_the_jax_package():
    rs = {"Worker": ReplicaSpec(replicas=2, restart_policy="ExitCode", command=["x"],
                                env={"A": "1"}, resources={"limits": {"cpu": 1}})}
    jrs = {"Worker": japi.ReplicaSpec(replicas=2, restart_policy="ExitCode", command=["x"],
                                      env={"A": "1"}, resources={"limits": {"cpu": 1}})}
    got = job("TPUJob", "b", rs, tpu=TPUSpec("v5e", "2x4", 2), run_policy={"backoffLimit": 1})
    want = japi.job("TPUJob", "b", jrs, tpu=japi.TPUSpec("v5e", "2x4", 2),
                    run_policy={"backoffLimit": 1})
    assert got == want
    assert tapi.JOB_KINDS == japi.JOB_KINDS
    for name in ("GROUP", "VERSION", "API_VERSION", "CREATED", "RUNNING", "RESTARTING",
                 "SUCCEEDED", "FAILED", "LABEL_JOB_NAME", "LABEL_REPLICA_TYPE",
                 "LABEL_REPLICA_INDEX", "RESTART_POLICIES", "CLEAN_POD_POLICIES"):
        assert getattr(tapi, name) == getattr(japi, name), name
    assert [c.kind for c in tfw.ALL_CONTROLLERS] == [c.kind for c in jfw.ALL_CONTROLLERS]
    assert ([c.gang_restart for c in tfw.ALL_CONTROLLERS]
            == [c.gang_restart for c in jfw.ALL_CONTROLLERS])


@pytest.mark.parametrize("case", ["bogus_type", "two_masters", "bad_policy", "no_template",
                                  "bad_clean"])
def test_job_validation_rejects_bad_spec(case):
    """The same manifests refused with the same messages."""
    from kubeflow_tpu.core.api import APIServer as JAPI
    from kubeflow_tpu_torch.core.api import APIServer as TAPI

    spec = job("PyTorchJob", "bad", {"Master": ReplicaSpec(command=["true"]),
                                     "Worker": ReplicaSpec(command=["true"])})
    rspecs = spec["spec"]["replicaSpecs"]
    if case == "bogus_type":
        rspecs["Bogus"] = rspecs.pop("Worker")
    elif case == "two_masters":
        rspecs["Master"]["replicas"] = 2
    elif case == "bad_policy":
        rspecs["Worker"]["restartPolicy"] = "Sometimes"
    elif case == "no_template":
        del rspecs["Worker"]["template"]
    else:
        spec["spec"]["runPolicy"] = {"cleanPodPolicy": "Some"}
    msgs = []
    for API, reg, Invalid in ((JAPI, japi.register, JInvalid), (TAPI, tapi.register, TInvalid)):
        api = API()
        reg(api)
        with pytest.raises(Invalid) as e:
            api.create(json.loads(json.dumps(spec)))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_dns_host_mode_renders_headless_service_names():
    """spec.network.hostMode=dns: the same rendezvous env on both planes
    for every kind's controller."""
    from kubeflow_tpu.core.api import APIServer as JAPI
    from kubeflow_tpu_torch.core.api import APIServer as TAPI

    specs = {
        "TFJob": {"PS": 1, "Worker": 2}, "TPUJob": {"Worker": 2},
        "PyTorchJob": {"Master": 1, "Worker": 2}, "MPIJob": {"Launcher": 1, "Worker": 2},
        "MXJob": {"Scheduler": 1, "Server": 1, "Worker": 2},
        "PaddleJob": {"Master": 1, "Worker": 2}, "XGBoostJob": {"Master": 1, "Worker": 2}}
    for kind, counts in specs.items():
        spec = job(kind, "dnsj", {r: ReplicaSpec(replicas=n, command=["x"])
                                  for r, n in counts.items()})
        spec["spec"]["network"] = {"hostMode": "dns", "clusterDomain": "corp.local"}
        n = sum(counts.values())
        spec["metadata"]["annotations"] = {
            tcommon.PORTS_ANNOTATION: json.dumps(list(range(5001, 5001 + n)))}
        replicas = spec["spec"]["replicaSpecs"]
        jctrl = {c.kind: c for c in jfw.ALL_CONTROLLERS}[kind](JAPI())
        tctrl = {c.kind: c for c in tfw.ALL_CONTROLLERS}[kind](TAPI())
        for rtype, count in counts.items():
            for i in range(count):
                assert (tctrl.set_cluster_spec(spec, rtype, i, replicas)
                        == jctrl.set_cluster_spec(spec, rtype, i, replicas)), (kind, rtype, i)
    env = tctrl.set_cluster_spec(spec, "Worker", 1, replicas)
    assert env["DMLC_TRACKER_URI"] == "dnsj-master-0.default.svc.corp.local"


def test_checkpoint_profile_and_parallelism_env_match():
    """spec.checkpoint, spec.profile and spec.parallelism render the JAX
    operator's env (the port's workers read CHECKPOINT_*)."""
    from kubeflow_tpu.core.api import APIServer as JAPI
    from kubeflow_tpu_torch.core.api import APIServer as TAPI

    spec = job("TPUJob", "ck", {"Worker": ReplicaSpec(replicas=2, command=["x"])})
    spec["spec"].update(checkpoint={"dir": "/ckpt", "everySteps": 7},
                        profile={"enabled": True, "dir": "/prof", "steps": 3},
                        parallelism={"preset": "tp", "tensor": 2})
    spec["metadata"]["annotations"] = {tcommon.PORTS_ANNOTATION: "[7001, 7002]"}
    replicas = spec["spec"]["replicaSpecs"]
    for i in range(2):
        got = tfw.TPUJobController(TAPI()).set_cluster_spec(spec, "Worker", i, replicas)
        assert got == jfw.TPUJobController(JAPI()).set_cluster_spec(spec, "Worker", i, replicas)
    assert got["CHECKPOINT_EVERY"] == "7" and got["TPU_PARALLELISM_PRESET"] == "tp"


# ------------------------------------------------------------- parity runs


def test_tpujob_env_injection_and_gang():
    """A two-worker TPUJob: the same pods, labels, PodGroup, rendezvous env
    (in the pod spec and as the processes see it) and conditions."""
    spec = job("TPUJob", "envjob", {"Worker": ReplicaSpec(
        replicas=2, command=[PY, "-u", "-c", PRINT_ENV])})

    def flow(plane, c, client):
        view = _run_job(spec)(plane, c, client)
        view["podgroup"] = c.api.get("PodGroup", "envjob")["status"]["phase"]
        view["services"] = sorted(s["metadata"]["name"] for s in c.api.list("Service"))
        return view
    view = _assert_same(_both(flow))
    assert view["podgroup"] == "Running"
    assert view["services"] == ["envjob-worker-0", "envjob-worker-1"]
    for i in range(2):
        env = view["logs"][f"envjob-worker-{i}"][-1]
        assert env["JAX_NUM_PROCESSES"] == "2" and env["JAX_PROCESS_ID"] == str(i)
        assert env["JAX_COORDINATOR_ADDRESS"] == "127.0.0.1:<port>"
        assert env["TPU_WORKER_ID"] == str(i)
    assert [c[0] for c in view["conditions"][-1]] == ["Created", "Running", "Succeeded"]


def test_tfjob_tf_config():
    cmd = [PY, "-u", "-c", PRINT_ENV]
    spec = job("TFJob", "tfj", {"PS": ReplicaSpec(command=cmd),
                                "Worker": ReplicaSpec(replicas=2, command=cmd)})
    view = _assert_same(_both(_run_job(spec)))
    cfg = json.loads(view["logs"]["tfj-worker-1"][-1]["TF_CONFIG"])
    assert cfg["task"] == {"type": "worker", "index": 1}
    assert len(cfg["cluster"]["worker"]) == 2 and len(cfg["cluster"]["ps"]) == 1


def test_exitcode_permanent_failure():
    spec = job("TPUJob", "perm", {"Worker": ReplicaSpec(
        command=[PY, "-c", "import sys, time; time.sleep(1.0); sys.exit(2)"],
        restart_policy="ExitCode")})

    def flow(plane, c, client):
        view = _run_job(spec, expect=tapi.FAILED)(plane, c, client)
        st = client.get_job("TPUJob", "perm")["status"]
        view["message"] = jget_condition(st, tapi.FAILED)["message"]
        return view
    view = _assert_same(_both(flow))
    assert "exit code 2" in view["message"]


def test_pytorchjob_elastic_shrinks_on_worker_failure(tmp_path):
    """ElasticPolicy: a permanently failed Worker shrinks the world."""
    worker = ("import os, time, sys\n"
              "marker = os.path.join(os.environ['MARKER_DIR'], 'died')\n"
              "assert os.environ['PET_MIN_REPLICAS'] == '1'\n"
              "if os.environ['RANK'] == '2' and not os.path.exists(marker):\n"
              "    open(marker, 'w').write('x'); sys.exit(1)\n"
              "time.sleep(3)\n")
    got = {}
    for plane in ("jax", "port"):
        d = tmp_path / plane
        d.mkdir()
        spec = job("PyTorchJob", "elastic", {
            "Master": ReplicaSpec(command=[PY, "-u", "-c",
                                           "import time; time.sleep(1.5); print('MASTER-DONE')"]),
            "Worker": ReplicaSpec(replicas=2, command=[PY, "-u", "-c", worker],
                                  env={"MARKER_DIR": "<dir>"})})
        spec["spec"]["elasticPolicy"] = {"minReplicas": 1, "maxReplicas": 4}

        def flow(p, c, client, d=d, spec=spec):
            spec = json.loads(json.dumps(spec).replace("<dir>", str(d)))
            view = _run_job(spec, timeout=120)(p, c, client)
            for pod in view["pods"].values():  # the marker dir differs by plane
                pod["env"] = [[e.replace(str(d), "<dir>") for e in ct] for ct in pod["env"]]
            return view
        c, client = _cluster(plane)
        try:
            got[plane] = flow(plane, c, client)
        finally:
            c.shutdown()
    view = _assert_same(got)
    assert view["elasticReplicas"] == {"Worker": 1}
    assert "JobScaledDown" in [r for r, _ in view["events"]]


def test_pytorchjob_scale_job_clamps():
    spec = job("PyTorchJob", "scaleme", {"Worker": ReplicaSpec(
        replicas=2, command=[PY, "-u", "-c", "import time; time.sleep(8)"])})
    spec["spec"]["elasticPolicy"] = {"minReplicas": 1, "maxReplicas": 3}

    def count(c):
        return len(c.api.list("Pod", label_selector={tapi.LABEL_JOB_NAME: "scaleme"}))

    def flow(plane, c, client):
        client.create_job(json.loads(json.dumps(spec)))
        assert c.wait_for(lambda: count(c) == 2, timeout=30)
        scaled = client.scale_job("PyTorchJob", "scaleme", 10)  # clamped to max 3
        assert c.wait_for(lambda: count(c) == 3, timeout=30)
        names = sorted(p["metadata"]["name"] for p in
                       c.api.list("Pod", label_selector={tapi.LABEL_JOB_NAME: "scaleme"}))
        client.delete_job("PyTorchJob", "scaleme")
        return {"replicas": scaled["spec"]["replicaSpecs"]["Worker"]["replicas"],
                "pods": names}
    view = _assert_same(_both(flow))
    assert view["replicas"] == 3 and len(view["pods"]) == 3


def test_mpijob_launcher_hostfile_configmap():
    launcher = ("import os\n"
                "path = os.environ['MPI_HOSTFILE']\n"
                "assert path == os.environ['OMPI_MCA_orte_default_hostfile']\n"
                "print('HOSTFILE:', open(path).read().replace('\\n', '|'))\n")
    spec = job("MPIJob", "mpi", {
        "Launcher": ReplicaSpec(command=[PY, "-u", "-c", launcher]),
        "Worker": ReplicaSpec(replicas=2, command=[PY, "-u", "-c", "import time; time.sleep(5)"])})
    spec["spec"]["runPolicy"] = {"cleanPodPolicy": "Running"}

    def flow(plane, c, client):
        view = _run_job(spec)(plane, c, client)
        view["hostfile"] = c.api.get("ConfigMap", "mpi-hostfile")["data"]["hostfile"]
        view["launcher_log"] = [x for x in c.logs("mpi-launcher-0").splitlines()
                                if x.startswith("HOSTFILE:")]
        return view
    view = _assert_same(_both(flow))
    assert view["hostfile"] == "mpi-worker-0 slots=1\nmpi-worker-1 slots=1"
    assert view["launcher_log"] == ["HOSTFILE: mpi-worker-0 slots=1|mpi-worker-1 slots=1"]
    assert sorted(view["pods"]) == ["mpi-launcher-0"]  # the running workers cleaned


def _rendered(kind: str, name: str, counts: dict) -> dict:
    """A flow rendering ``kind``'s pods (not run to the end: the env is the
    point) and reading their env."""
    spec = job(kind, name, {r: ReplicaSpec(replicas=n, command=[PY, "-u", "-c", "pass"])
                            for r, n in counts.items()})
    want = [f"{name}-{r.lower()}-{i}" for r, n in counts.items() for i in range(n)]

    def flow(plane, c, client):
        client.create_job(json.loads(json.dumps(spec)))
        assert c.wait_for(lambda: all(c.api.try_get("Pod", p) for p in want), timeout=30)
        return _pods(c, name, _ports(c, kind, name))
    return flow


def test_mxjob_dmlc_env():
    pods = _assert_same(_both(_rendered("MXJob", "mx", {"Scheduler": 1, "Server": 1,
                                                      "Worker": 2})))
    env = {k: v for k, v in (json.loads(e).values() for e in pods["mx-worker-1"]["env"][0])}
    assert env["DMLC_ROLE"] == "worker" and env["DMLC_WORKER_ID"] == "1"


def test_paddlejob_trainer_endpoints():
    pods = _assert_same(_both(_rendered("PaddleJob", "pd", {"Worker": 2})))
    env = {k: v for k, v in (json.loads(e).values() for e in pods["pd-worker-1"]["env"][0])}
    assert env["PADDLE_TRAINER_ID"] == "1" and env["TRAINING_ROLE"] == "TRAINER"


def test_xgboostjob_tracker_env():
    pods = _assert_same(_both(_rendered("XGBoostJob", "xg", {"Master": 1, "Worker": 2})))
    env = {k: v for k, v in (json.loads(e).values() for e in pods["xg-worker-1"]["env"][0])}
    assert env["DMLC_TASK_ID"] == "2" and env["DMLC_NUM_WORKER"] == "3"


def test_gang_restart_conditions_are_phase_22s(tmp_path):
    """A two-worker TPUJob whose worker 1 is preempted once (exit 137): the
    operator restarts the whole gang, on both planes alike, through the
    condition states chip_smoke.py holds phase 22(a) to."""
    code = ("import os, sys, time\n"
            "m = os.environ['MARKER']\n"
            "time.sleep(0.5)\n"
            "if os.environ['JAX_PROCESS_ID'] == '1' and not os.path.exists(m):\n"
            "    open(m, 'w').close(); sys.exit(137)\n"
            "time.sleep(0.5 if os.path.exists(m) else 30)\n")
    got = {}
    for plane in ("jax", "port"):
        spec = job("TPUJob", "gang", {"Worker": ReplicaSpec(
            replicas=2, restart_policy="ExitCode", command=[PY, "-u", "-c", code],
            env={"MARKER": str(tmp_path / f"{plane}-died")})})
        c, client = _cluster(plane)
        try:
            view = _run_job(spec, timeout=60)(plane, c, client)
            for pod in view["pods"].values():
                pod["env"] = [[e.replace(f"{plane}-died", "died") for e in ct]
                              for ct in pod["env"]]
            got[plane] = view
        finally:
            c.shutdown()
    view = _assert_same(got)
    assert view["restartCount"] == 1
    assert view["conditions"] == chip_smoke.GANG_CONDITIONS
    assert "SliceRestarting" in [r for r, _ in view["events"]]


# ----------------------------------------------------- the port's plane alone


@pytest.mark.parametrize("tpu", [TPUSpec("v5e", "2x4"), TPUSpec("v5e", "2x2", 2)],
                         ids=["slice", "multislice"])
def test_spec_tpu_is_refused_never_dropped(tpu):
    """A job asking for a TPU slice: its pod requests ``google.com/tpu``
    (the slice's chips), stays Pending with the scheduler's event naming
    it, the job never Running; deleting the job removes the pod."""
    c, client = _cluster("port")
    try:
        client.create_job(job("TPUJob", "tpuj", {"Worker": ReplicaSpec(command=[PY, "-c", "pass"])},
                              tpu=tpu))
        assert c.wait_for(lambda: c.api.try_get("Pod", "tpuj-worker-0") is not None, timeout=10)
        c.wait_for(lambda: False, timeout=0.5)
        pod = c.api.get("Pod", "tpuj-worker-0")
        assert not pod["spec"].get("nodeName")
        assert pod.get("status", {}).get("phase", "Pending") == "Pending"
        req = pod["spec"]["containers"][0]["resources"]["requests"]
        assert req == {"google.com/tpu": 8}  # 2x4, or 2x2 twice
        assert tcommon.tpu_request(tpu.to_obj()) == 8
        assert not (pod["spec"].get("nodeSelector") or {})
        msgs = {e["message"] for e in events_for(c.api, pod) if e["reason"] == "FailedScheduling"}
        assert msgs and all("google.com/tpu" in m for m in msgs)
        # one pod: the spec's count, no expansion from the slice topology
        assert len(c.api.list("Pod")) == 1
        assert client.job_condition("TPUJob", "tpuj") == tapi.CREATED
        env = {e["name"]: e["value"] for e in pod["spec"]["containers"][0]["env"]}
        assert not any(k.startswith(("TPU_ACCELERATOR", "TPU_TOPOLOGY", "MEGASCALE_"))
                       for k in env)
        client.delete_job("TPUJob", "tpuj")
        assert c.wait_for(lambda: not c.api.list("Pod"), timeout=10)
    finally:
        c.shutdown()


def test_gpu_request_becomes_cuda_visible_devices():
    """A worker's card comes from its ``nvidia.com/gpu`` request: two
    workers on the two-card node hold cards 0 and 1; under a kubelet whose
    own CUDA_VISIBLE_DEVICES is "0,0" (phase 22's) both see card 0; a
    replica asking for none sees no card."""
    show = [PY, "-u", "-c", "import os; print('CVD=' + os.environ['CUDA_VISIBLE_DEVICES'])"]
    spec = job("TFJob", "cards", {
        "PS": ReplicaSpec(command=show),
        "Worker": ReplicaSpec(replicas=2, command=show,
                              resources={"requests": {"nvidia.com/gpu": 1}})})
    for base, want in (({}, ["0", "1"]), ({"CUDA_VISIBLE_DEVICES": "0,0"}, ["0", "0"])):
        c, client = _cluster("port", base_env=base)
        try:
            client.create_job(json.loads(json.dumps(spec)))
            assert client.wait_for_job("TFJob", "cards", timeout=60) == tapi.SUCCEEDED
            got = [c.logs(f"cards-worker-{i}").strip() for i in range(2)]
            assert sorted(got) == [f"CVD={w}" for w in sorted(want)]
            assert c.logs("cards-ps-0").strip() == "CVD="
            assert c.api.get("Pod", "cards-worker-0")["spec"]["nodeName"] == "h100"
            assert c.api.get("Pod", "cards-ps-0")["spec"]["nodeName"] == "cpu-0"
        finally:
            c.shutdown()


def test_gang_of_card_workers_waits_for_both_cards():
    """A gang asking for more cards than are free binds all-or-nothing:
    three one-card workers on the two-card node stay Pending together."""
    c, client = _cluster("port")
    try:
        client.create_job(job("TPUJob", "big", {"Worker": ReplicaSpec(
            replicas=3, command=[PY, "-c", "pass"],
            resources={"requests": {"nvidia.com/gpu": 1}})}))
        assert c.wait_for(lambda: len(c.api.list("Pod")) == 3, timeout=10)
        c.wait_for(lambda: False, timeout=0.5)
        assert all(not p["spec"].get("nodeName") for p in c.api.list("Pod"))
        pg = c.api.get("PodGroup", "big")
        assert pg["status"]["phase"] == "Pending"
    finally:
        c.shutdown()


# ------------------------------------------------------------- slow parity


@pytest.mark.slow
def test_exitcode_restart_policy(tmp_path):
    """exit 137 is retryable: the pod is recreated, on both planes alike."""
    got = {}
    for plane in ("jax", "port"):
        marker = str(tmp_path / f"{plane}-marker")
        code = ("import os, sys\n"
                f"m = {marker!r}\n"
                "if not os.path.exists(m):\n"
                "    open(m, 'w').close(); sys.exit(137)\n"
                "print('RECOVERED')\n")
        spec = job("TPUJob", "pre", {"Worker": ReplicaSpec(
            command=[PY, "-u", "-c", code], restart_policy="ExitCode")})
        c, client = _cluster(plane)
        try:
            view = _run_job(spec)(plane, c, client)
            view["recovered"] = "RECOVERED" in c.logs("pre-worker-0")
            view["pods"] = sorted(view["pods"])
            del view["conditions"]  # a 0.05 s process: Running may or may not be seen
            got[plane] = view
        finally:
            c.shutdown()
    view = _assert_same(got)
    assert view["restartCount"] == 1 and view["recovered"]


@pytest.mark.slow
def test_backoff_limit():
    spec = job("TPUJob", "loop", {"Worker": ReplicaSpec(
        command=[PY, "-c", "import sys, time; time.sleep(0.3); sys.exit(137)"],
        restart_policy="ExitCode")}, run_policy={"backoffLimit": 1})
    view = _assert_same(_both(_run_job(spec, expect=tapi.FAILED)))
    assert view["restartCount"] == 1


@pytest.mark.slow
def test_clean_pod_policy_and_ttl():
    spec = job("TPUJob", "clean", {"Worker": ReplicaSpec(
        command=[PY, "-c", "import time; time.sleep(0.3); print('ok')"])},
        run_policy={"cleanPodPolicy": "All", "ttlSecondsAfterFinished": 1})

    def flow(plane, c, client):
        conds = chip_smoke.ConditionLog(c.api, "TPUJob")
        client.create_job(json.loads(json.dumps(spec)))
        assert client.wait_for_job("TPUJob", "clean", timeout=60) == tapi.SUCCEEDED
        cleaned = c.wait_for(lambda: not c.api.list(
            "Pod", label_selector={tapi.LABEL_JOB_NAME: "clean"}), timeout=30)
        deleted = c.wait_for(lambda: client.get_job("TPUJob", "clean") is None, timeout=30)
        return {"cleaned": cleaned, "deleted": deleted, "conditions": conds.read()}
    view = _assert_same(_both(flow))
    assert view["cleaned"] and view["deleted"]


@pytest.mark.slow
def test_pytorchjob_elastic_scale_up_after_shrink(tmp_path):
    worker = ("import os, time, sys\n"
              "marker = os.path.join(os.environ['MARKER_DIR'], 'died-' + os.environ['RANK'])\n"
              "if os.environ['RANK'] == '2' and not os.path.exists(marker):\n"
              "    open(marker, 'w').write('x'); sys.exit(1)\n"
              "time.sleep(6)\n")
    got = {}
    for plane in ("jax", "port"):
        d = tmp_path / plane
        d.mkdir()
        spec = job("PyTorchJob", "growback", {
            "Master": ReplicaSpec(command=[PY, "-u", "-c",
                                           "import time; time.sleep(5); print('MASTER-DONE')"]),
            "Worker": ReplicaSpec(replicas=2, command=[PY, "-u", "-c", worker],
                                  env={"MARKER_DIR": str(d)})})
        spec["spec"]["elasticPolicy"] = {"minReplicas": 1, "maxReplicas": 4, "scaleUp": True,
                                         "scaleUpCooldownSeconds": 0.5}
        c, client = _cluster(plane)
        try:
            client.create_job(spec)
            assert client.wait_for_job("PyTorchJob", "growback", timeout=120) == tapi.SUCCEEDED
            st = client.get_job("PyTorchJob", "growback")["status"]
            got[plane] = {"elastic": st.get("elasticReplicas"),
                          "events": sorted({r for r, _ in _events(c, "PyTorchJob", "growback")})}
        finally:
            c.shutdown()
    view = _assert_same(got)
    assert view["elastic"] is None
    assert {"JobScaledDown", "JobScaledUp"} <= set(view["events"])


@pytest.mark.slow
def test_pytorchjob_real_gloo_allreduce():
    code = ("import os, datetime, torch, torch.distributed as dist\n"
            "dist.init_process_group('gloo', timeout=datetime.timedelta(seconds=60))\n"
            "t = torch.tensor([float(dist.get_rank() + 1)])\n"
            "dist.all_reduce(t)\n"
            "print('ALLREDUCE', t.item(), 'world', dist.get_world_size())\n")
    spec = job("PyTorchJob", "ptj", {"Master": ReplicaSpec(command=[PY, "-u", "-c", code]),
                                     "Worker": ReplicaSpec(command=[PY, "-u", "-c", code])})

    def flow(plane, c, client):
        client.create_job(json.loads(json.dumps(spec)))
        assert client.wait_for_job("PyTorchJob", "ptj", timeout=120) == tapi.SUCCEEDED
        return "ALLREDUCE 3.0 world 2" in c.logs("ptj-master-0")
    assert _both(flow) == {"jax": True, "port": True}


@pytest.mark.slow
def test_tpujob_distributed_psum_and_train():
    """Each plane's ``distributed_check`` under a two-worker TPUJob."""
    def flow(plane, c, client):
        pkg = "kubeflow_tpu" if plane == "jax" else "kubeflow_tpu_torch"
        env = {"PYTHONPATH": REPO, "OMP_NUM_THREADS": "2",
               **({"JAX_PLATFORMS": "cpu"} if plane == "jax" else {"TORCH_DEVICE": "cpu"})}
        client.create_job(job("TPUJob", "distcheck", {"Worker": ReplicaSpec(
            replicas=2, command=[PY, "-u", "-m", f"{pkg}.examples.distributed_check"],
            env=env)}))
        assert client.wait_for_job("TPUJob", "distcheck", timeout=180) == tapi.SUCCEEDED
        joined = "\n".join(client.get_job_logs("TPUJob", "distcheck").values())
        return ["PSUM got=3.0 expected=3.0" in joined, "TRAIN-OK" in joined]
    assert _both(flow) == {"jax": [True, True], "port": [True, True]}


@pytest.mark.slow
def test_mpijob_launcher_runs_the_ports_mpirun():
    """The launcher execs the port's vendored ``mpirun`` (built into the
    port's build directory) and spawns two ranks."""
    bindir = ensure_mpirun()
    assert bindir.startswith(os.path.join(REPO, "kubeflow_tpu_torch", "_build"))
    launcher = ("import os, subprocess, sys\n"
                "out = subprocess.run(['mpirun', '--allow-run-as-root', '--oversubscribe',\n"
                "                      '-np', '2', '--host', 'localhost:2', sys.executable, '-c',\n"
                "                      'import os; print(\"MPIRANK\", "
                "os.environ.get(\"OMPI_COMM_WORLD_RANK\", \"?\"))'],\n"
                "                     capture_output=True, text=True, timeout=60)\n"
                "sys.stdout.write(out.stdout + out.stderr)\n"
                "sys.exit(out.returncode)\n")
    spec = job("MPIJob", "mpireal", {
        "Launcher": ReplicaSpec(command=[PY, "-u", "-c", launcher]),
        "Worker": ReplicaSpec(command=[PY, "-u", "-c", "import time; time.sleep(5)"])})
    spec["spec"]["runPolicy"] = {"cleanPodPolicy": "Running"}
    c, client = _cluster("port", base_env={"PATH": bindir + os.pathsep + os.environ["PATH"]})
    try:
        client.create_job(spec)
        assert client.wait_for_job("MPIJob", "mpireal", timeout=90) == tapi.SUCCEEDED
        log = c.logs("mpireal-launcher-0")
        assert sorted(re.findall(r"MPIRANK (\d)", log)) == ["0", "1"], log
    finally:
        c.shutdown()


def _resumes(log: str) -> list:
    return [int(m) for m in re.findall(r"resumed_from=(\d+)", log)]


@pytest.mark.slow
def test_tpujob_auto_resume_from_checkpoint(tmp_path):
    """Each plane runs its package's BERT worker, preempted at step 7 of
    12: one restart, resumed from a durable checkpoint, done at 12."""
    def flow(plane, c, client):
        pkg = "kubeflow_tpu" if plane == "jax" else "kubeflow_tpu_torch"
        env = {"PYTHONPATH": REPO, "TRAIN_STEPS": "12", "FAIL_AT_STEP": "7",
               "FAIL_MARKER": str(tmp_path / f"{plane}-died"), "OMP_NUM_THREADS": "2",
               **({"JAX_PLATFORMS": "cpu"} if plane == "jax" else {"TORCH_DEVICE": "cpu"})}
        spec = job("TPUJob", "resume", {"Worker": ReplicaSpec(
            restart_policy="ExitCode", command=[PY, "-u", "-m", f"{pkg}.examples.bert_worker"],
            env=env)})
        spec["spec"]["checkpoint"] = {"dir": str(tmp_path / f"{plane}-ckpt"), "everySteps": 3}
        client.create_job(spec)
        assert client.wait_for_job("TPUJob", "resume", timeout=240) == tapi.SUCCEEDED
        log = c.logs("resume-worker-0")
        r = _resumes(log)
        return {"restarts": client.get_job("TPUJob", "resume")["status"]["restartCount"],
                "fresh_then_resumed": len(r) == 2 and r[0] == 0 and r[1] in (3, 6),
                "done": "TRAIN-DONE step=12" in log}
    assert _both(flow) == {p: {"restarts": 1, "fresh_then_resumed": True, "done": True}
                           for p in ("jax", "port")}


@pytest.mark.slow
def test_bert_worker_gang_restart_on_both_planes(tmp_path):
    """phase 22(a)'s manifest at tiny widths on the CPU: the port's BERT
    worker under chip_smoke.py's wrapper as a two-member TPUJob, rank 1
    preempted at step 5.  On both planes the operator restarts the gang
    through phase 22(a)'s condition states, both members resume from the
    same checkpoint, and both planes print the same ``step=`` lines."""
    got = {}
    for plane in ("jax", "port"):
        spec = chip_smoke.jobs_manifests(str(tmp_path / plane))[0][0][2]
        container = spec["spec"]["replicaSpecs"]["Worker"]["template"]["spec"]["containers"][0]
        env = {e["name"]: e["value"] for e in container["env"]}
        env.update(VOCAB_SIZE="512", HIDDEN_SIZE="64", NUM_LAYERS="2", NUM_HEADS="1",
                   INTERMEDIATE_SIZE="128", TORCH_DEVICE="cpu", PYTHONPATH=REPO,
                   OMP_NUM_THREADS="2")
        container["env"] = [{"name": k, "value": v} for k, v in env.items()]
        if plane == "jax":  # no GPU node there
            container["resources"] = {}
        c, client = _cluster(plane)
        try:
            conds = chip_smoke.ConditionLog(c.api, "TPUJob")
            client.create_job(spec)
            end = client.wait_for_job("TPUJob", "bert-gang", timeout=240)
            assert end == tapi.SUCCEEDED, (
                plane, client.get_job("TPUJob", "bert-gang")["status"],
                [c.logs(f"bert-gang-worker-{r}")[-1500:] for r in range(2)])
            members = [chip_smoke.job_runs(c.logs(f"bert-gang-worker-{r}")) for r in range(2)]
            got[plane] = {
                "conditions": conds.read()["bert-gang"],
                "restarts": client.get_job("TPUJob", "bert-gang")["status"]["restartCount"],
                "resumed": [[chip_smoke.resumed_from(r["lines"]) for r in m] for m in members],
                "steps": [chip_smoke.step_lines(m[-1]["lines"]) for m in members],
                "done": ["TRAIN-DONE step=10" in m[-1]["lines"] for m in members]}
        finally:
            c.shutdown()
    # the same steps on both planes, both members alike; the losses agree to
    # the printed 4 decimals but for a rounding flip (two runs of a gloo gang
    # on the CPU sum in their own order), so within 2e-4 across planes
    lines = {p: got[p].pop("steps") for p in got}
    view = _assert_same(got)
    for p in lines:
        assert lines[p][0] == lines[p][1] and lines[p][0], p
    parsed = {p: [(ln.split()[0], float(ln.split("loss=")[1])) for ln in lines[p][0]]
              for p in lines}
    assert [s for s, _ in parsed["port"]] == [s for s, _ in parsed["jax"]]
    assert all(abs(a - b) <= 2e-4 for (_, a), (_, b) in zip(parsed["port"], parsed["jax"]))
    assert view["conditions"] == chip_smoke.GANG_CONDITIONS
    assert view["restarts"] == 1 and view["done"] == [True, True]
    (a0, k0), (a1, k1) = view["resumed"]
    assert a0 == a1 == 0 and k0 == k1 and k0 > 0
