"""Port parity: the port's Katib against the JAX package's.

* Every suggestion algorithm gives, bit for bit, the JAX suggester's
  assignments for the same experiment, ``random_state`` and trial history
  (values and their Python types), and the same registry.
* ``parse_metrics``, ``observation``, the TFEvent writer and parser, and
  the C++ observation-log WAL: what one package writes, the other reads
  back identically.
* The API's validation and defaults (``nasConfig`` expansion), and
  ``render_trial_spec``.
* End to end on the port's cluster (one CPU node, one GPU node of two
  cards), the reference's experiments: a random LR sweep, early stop on
  the goal, grid exhaustion, the Push, TFEvent and bare-Pod trials, the
  observation series and UI data endpoints; an experiment's trials and
  conditions equal the JAX plane's.  The DARTS trial runs the port's
  worker at seed 37.
* chip_smoke.py's phase 22(f): its LR sweep's rates are the JAX random
  suggester's draws for the same experiment.
Scenarios marked ``slow`` in the reference stay ``slow``.
"""

import json
import os
import sys

import numpy as np
import pytest

import chip_smoke
from kubeflow_tpu.core.api import APIServer as JAPI
from kubeflow_tpu.core.api import Invalid as JInvalid
from kubeflow_tpu.core.cluster import Cluster as JCluster
from kubeflow_tpu.katib import api as jkapi
from kubeflow_tpu.katib.controllers import install as jkatib_install
from kubeflow_tpu.katib.controllers import render_trial_spec as jrender
from kubeflow_tpu.katib.metrics import TFEventWriter as JWriter
from kubeflow_tpu.katib.metrics import observation as jobservation
from kubeflow_tpu.katib.metrics import parse_metrics as jparse
from kubeflow_tpu.katib.metrics import parse_tfevent_dir as jparse_dir
from kubeflow_tpu.katib.obslog import ObservationStore as JStore
from kubeflow_tpu.katib.suggest import algorithm_names as jalgorithms
from kubeflow_tpu.katib.suggest import get_suggester as jget
from kubeflow_tpu.training.frameworks import install as jtraining_install
from kubeflow_tpu_torch.core.api import APIServer as TAPI
from kubeflow_tpu_torch.core.api import Invalid as TInvalid
from kubeflow_tpu_torch.core.cluster import Cluster as TCluster
from kubeflow_tpu_torch.core.conditions import has_condition
from kubeflow_tpu_torch.katib import api as kapi
from kubeflow_tpu_torch.katib.api import Parameter, experiment
from kubeflow_tpu_torch.katib.client import KatibClient
from kubeflow_tpu_torch.katib.controllers import install as katib_install
from kubeflow_tpu_torch.katib.controllers import render_trial_spec
from kubeflow_tpu_torch.katib.metrics import (TFEventWriter, observation, parse_metrics,
                                              parse_tfevent_dir)
from kubeflow_tpu_torch.katib.obslog import ObservationStore
from kubeflow_tpu_torch.katib.service import KatibService
from kubeflow_tpu_torch.katib.suggest import algorithm_names, get_suggester
from kubeflow_tpu_torch.training import api as tapi
from kubeflow_tpu_torch.training.frameworks import install as training_install

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PY = sys.executable


def make_exp_obj(algorithm="random", max_trials=6, goal=None, settings=None):
    return experiment(
        "e",
        parameters=[
            Parameter("lr", "double", min=0.01, max=1.0),
            Parameter("units", "int", min=8, max=64),
            Parameter("opt", "categorical", list=["sgd", "adam"]),
            Parameter("bs", "discrete", list=[16, 32, 64]),
        ],
        trial_spec={"apiVersion": "kubeflow.org/v1", "kind": "TPUJob", "spec": {}},
        objective_metric="accuracy",
        goal=goal,
        algorithm=algorithm,
        algorithm_settings=settings,
        max_trials=max_trials,
    )


def fake_trial(assignments, value, metric="accuracy", state="Succeeded"):
    t = {"spec": {"parameterAssignments": [{"name": k, "value": v}
                                           for k, v in assignments.items()]},
         "status": {"conditions": [{"type": state, "status": "True"}]}}
    if value is not None:
        t["status"]["observation"] = {"metrics": [{"name": metric, "latest": value}]}
    return t


def _history(n: int, seed: int) -> list:
    """``n`` finished trials over make_exp_obj's space and one running."""
    rng = np.random.default_rng(seed)
    out = [fake_trial({"lr": float(rng.uniform(0.01, 1.0)), "units": int(rng.integers(8, 65)),
                       "opt": ["sgd", "adam"][i % 2], "bs": [16, 32, 64][i % 3]},
                      float(1 - (rng.uniform() - 0.3) ** 2)) for i in range(n)]
    out.append(fake_trial({"lr": 0.5, "units": 16, "opt": "sgd", "bs": 32}, None,
                          state="Running"))
    return out


def _typed(assignments: list) -> list:
    """Assignments with each value's type: equality alone lets 1 == 1.0."""
    return [{k: (type(v).__name__, v) for k, v in a.items()} for a in assignments]


# ------------------------------------------------------------------ suggesters


def test_same_algorithms_registered():
    assert algorithm_names() == jalgorithms()
    assert set(algorithm_names()) >= {"random", "grid", "tpe", "bayesianoptimization",
                                      "hyperband", "cmaes", "sobol", "pbt", "enas", "darts"}


SPACE_ALGOS = ["random", "grid", "sobol", "bayesianoptimization", "tpe", "cmaes", "pbt"]


@pytest.mark.parametrize("history", [0, 3, 12])
@pytest.mark.parametrize("algo", SPACE_ALGOS)
def test_suggestions_equal_the_jax_suggesters(algo, history):
    """The same experiment (random_state 11), the same trials: the same
    assignments, value for value and type for type."""
    exp = make_exp_obj(algo, settings={"random_state": 11, "default_steps": 3})
    trials = _history(history, seed=history) if history else []
    got = get_suggester(algo).suggest(exp, trials, 5)
    want = jget(algo).suggest(exp, trials, 5)
    assert _typed(got) == _typed(want)
    assert len(got) == (5 if algo != "grid" else min(5, max(0, 54 - len(trials))))


def test_hyperband_equals_the_jax_suggester():
    exp = experiment(
        "e2", [Parameter("lr", "double", min=0.1, max=1.0),
               Parameter("epochs", "double", min=1, max=9)],
        {"kind": "TPUJob", "spec": {}}, "acc", algorithm="hyperband",
        algorithm_settings={"resource_name": "epochs", "eta": 3, "min_resource": 1,
                            "max_resource": 9, "random_state": 4})
    histories = [[], [fake_trial({"lr": lr, "epochs": 1.0}, acc, "acc")
                      for lr, acc in [(0.1, 0.5), (0.4, 0.9), (0.8, 0.3)]]]
    histories.append(histories[1] + [fake_trial({"lr": 0.4, "epochs": 3.0}, None, "acc",
                                                state="Running")])
    for trials in histories:
        for count in (1, 2, 4):
            assert (_typed(get_suggester("hyperband").suggest(exp, trials, count))
                    == _typed(jget("hyperband").suggest(exp, trials, count)))
    out = get_suggester("hyperband").suggest(exp, histories[1], 1)
    assert float(out[0]["lr"]) == 0.4 and float(out[0]["epochs"]) == 3.0


def test_enas_rounds_equal_the_jax_suggester():
    """Twelve REINFORCE rounds fed the same rewards: every round's
    architectures equal."""
    exp = experiment(
        "nas", [Parameter(f"layer_{i}_op", "categorical", list=["conv3", "conv5", "skip", "pool"])
                for i in range(4)],
        {"kind": "TPUJob", "spec": {}}, "acc", algorithm="enas",
        algorithm_settings={"random_state": 0})
    trials = []
    for _ in range(12):
        got = get_suggester("enas").suggest(exp, trials, 3)
        assert _typed(got) == _typed(jget("enas").suggest(exp, trials, 3))
        trials += [fake_trial(a, sum(v == "conv3" for v in a.values()) / 4, "acc") for a in got]
    final = get_suggester("enas").suggest(exp, trials, 10)
    assert np.mean([sum(v == "conv3" for v in a.values()) / 4 for a in final]) >= 0.6


def test_darts_equals_the_jax_suggester():
    exp = experiment(
        "nasd", [Parameter("seed", "int", min=0, max=9999), Parameter("lr", "double", min=0.1,
                                                                        max=0.2)],
        {"kind": "TPUJob", "spec": {}}, "val_acc", algorithm="darts",
        algorithm_settings=chip_smoke.DARTS_SETTINGS)
    for trials in ([], [fake_trial({"seed": "37"}, 0.9, "val_acc")]):
        got = get_suggester("darts").suggest(exp, trials, 2)
        assert _typed(got) == _typed(jget("darts").suggest(exp, trials, 2))
    first = get_suggester("darts").suggest(exp, [], 1)[0]
    assert first["seed"] == str(chip_smoke.DARTS_SEED) and first["num_layers"] == "4"


def test_phase_22_lr_rates_are_the_jax_suggesters():
    """chip_smoke.py's 22(f): two trials drawn together, then a third once
    one has finished (from random_state + 2); the JAX suggester draws the
    rates the phase holds its trials to."""
    exp = chip_smoke.mnist_lr_experiment()
    jax = jget("random")
    draws = jax.suggest(exp, [], 2) + jax.suggest(exp, [{}, {}], 1)
    assert [a["learning_rate"] for a in draws] == chip_smoke.MNIST_LR_RATES
    port = get_suggester("random")
    assert port.suggest(exp, [], 2) + port.suggest(exp, [{}, {}], 1) == draws
    lo, hi = chip_smoke.MNIST_LR_RANGE
    assert all(lo <= r <= hi for r in chip_smoke.MNIST_LR_RATES)


# ------------------------------------------------------------------- metrics


LOG = """
epoch 1: accuracy=0.81 loss=0.9
epoch 2: accuracy=0.92 loss=0.4
{"accuracy": 0.95, "loss": 0.2}
noise accuracy-ish=7 other=3 val_acc=1e-3
{"accuracy": "bad", "val_acc": 2}
{broken json accuracy=0.5
final accuracy=0.93 loss=-1.5E+2
"""


def test_parse_metrics_and_observation_match():
    for names in (["accuracy", "loss"], ["val_acc"], ["accuracy", "other", "missing"]):
        assert parse_metrics(LOG, names) == jparse(LOG, names)
        assert observation(LOG, names) == jobservation(LOG, names)
    out = parse_metrics(LOG, ["accuracy", "loss"])
    assert out["accuracy"] == [0.81, 0.92, 0.95, 0.5, 0.93]


def test_tfevent_writers_write_the_same_bytes_and_parse_alike(tmp_path):
    rows = [(step, acc, loss) for step, (acc, loss) in
            enumerate([(0.6, 0.9), (0.8, 0.5), (0.9, 0.2), (0.95, 1e-7)])]
    for Writer, d in ((TFEventWriter, tmp_path / "port"), (JWriter, tmp_path / "jax")):
        w = Writer(str(d))
        for step, acc, loss in rows:
            w.scalar("accuracy", acc, step)
            w.scalar("loss", loss, step)
        w.close()
    port_file = (tmp_path / "port" / "events.out.tfevents.0").read_bytes()
    assert port_file == (tmp_path / "jax" / "events.out.tfevents.0").read_bytes()
    for d in ("port", "jax"):
        names = ["accuracy", "loss", "missing"]
        got = parse_tfevent_dir(str(tmp_path / d), names)
        assert got == jparse_dir(str(tmp_path / d), names)
        assert [s for s, _ in got["accuracy"]] == [0, 1, 2, 3]
    assert parse_tfevent_dir(str(tmp_path / "none"), ["accuracy"]) == {"accuracy": []}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_observation_log_reads_back_in_the_other_package(tmp_path, writer):
    """A WAL one package's store wrote reads back identically in the other
    (series, latest, trials, metrics, observation), a truncated tail too."""
    path = str(tmp_path / "obs.wal")
    W, R = (JStore, ObservationStore) if writer == "jax" else (ObservationStore, JStore)
    st = W(path)
    for i, v in enumerate([0.5, 0.7, 0.9]):
        st.report("t1", "accuracy", v, step=i)
    st.report("t1", "loss", 0.3)
    st.report("t2", "accuracy", 0.4)
    st.report("t2", "accuracy", -2.5e-9, step=17)
    st.close()
    readers = [R(path), W(path)]
    views = [{"log": r.get_log("t1", "accuracy"), "from2": r.get_log("t1", "accuracy", start=2),
              "t2": r.get_log("t2", "accuracy"), "latest": r.latest("t1", "accuracy"),
              "none": r.latest("t1", "nope"), "trials": r.trials(), "metrics": r.metrics("t1"),
              "obs": r.observation("t1", ["accuracy", "loss"])} for r in readers]
    for r in readers:
        r.close()
    assert views[0] == views[1]
    assert views[0]["log"] == [(0, 0.5), (1, 0.7), (2, 0.9)]
    assert views[0]["t2"] == [(0, 0.4), (17, -2.5e-9)]
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) - 7)
    counts = []
    for Store in (R, W):
        s = Store(path)
        counts.append((s.count("t1", "accuracy"), s.count("t2", "accuracy")))
        s.close()
    assert counts[0] == counts[1]


# ------------------------------------------------------------- API, rendering


def test_render_trial_spec_matches():
    template = {
        "trialParameters": [{"name": "learningRate", "reference": "lr"},
                            {"name": "units", "reference": "units"}],
        "trialSpec": {"kind": "TPUJob",
                      "spec": {"env": [{"name": "LR", "value": "${trialParameters.learningRate}"}],
                               "cmd": ["--lr=${trialParameters.learningRate}",
                                       "--u=${trialParameters.units}", 3]}},
    }
    for a in ({"lr": 0.25, "units": 8}, {"lr": 1e-5, "units": 64}):
        assert render_trial_spec(template, a) == jrender(template, a)
    with pytest.raises(KeyError) as e:
        render_trial_spec(template, {"other": 1})
    with pytest.raises(KeyError) as je:
        jrender(template, {"other": 1})
    assert str(e.value) == str(je.value)


def test_experiment_defaults_and_nas_config_match():
    obj = {"apiVersion": kapi.API_VERSION, "kind": "Experiment", "metadata": {"name": "nascfg"},
           "spec": {"objective": {"type": "maximize", "objectiveMetricName": "acc"},
                    "algorithm": {"algorithmName": "enas"},
                    "nasConfig": {"graphConfig": {"numLayers": 3},
                                  "operations": [{"operationType": "conv3"},
                                                 {"operationType": "skip"}]},
                    "trialTemplate": {"trialSpec": {"kind": "TPUJob", "spec": {}}}}}
    made = []
    for API, reg in ((JAPI, jkapi.register), (TAPI, kapi.register)):
        api = API()
        reg(api)
        made.append(api.create(json.loads(json.dumps(obj)))["spec"])
    assert made[0] == made[1]
    assert [p["name"] for p in made[1]["parameters"]] == ["layer_0_op", "layer_1_op", "layer_2_op"]


@pytest.mark.parametrize("case", ["no_params", "bad_type", "no_bounds", "no_list",
                                  "bad_objective", "no_metric", "no_trial", "bad_algo"])
def test_experiment_validation_matches(case):
    exp = make_exp_obj()
    spec = exp["spec"]
    if case == "no_params":
        spec["parameters"] = []
    elif case == "bad_type":
        spec["parameters"][0]["parameterType"] = "float"
    elif case == "no_bounds":
        del spec["parameters"][0]["feasibleSpace"]["max"]
    elif case == "no_list":
        spec["parameters"][2]["feasibleSpace"]["list"] = []
    elif case == "bad_objective":
        spec["objective"]["type"] = "best"
    elif case == "no_metric":
        spec["objective"]["objectiveMetricName"] = ""
    elif case == "no_trial":
        spec["trialTemplate"]["trialSpec"] = {}
    else:
        spec["algorithm"]["algorithmName"] = "annealing"
    msgs = []
    for API, reg, Invalid in ((JAPI, jkapi.register, JInvalid), (TAPI, kapi.register, TInvalid)):
        api = API()
        reg(api)
        with pytest.raises(Invalid) as e:
            api.create(json.loads(json.dumps(exp)))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


# ----------------------------------------------------------------------- e2e


TRIAL_CODE = ("import os, math\n"
              "lr = float(os.environ['LR'])\n"
              "acc = 1.0 - (lr - 0.1) ** 2\n"
              "print(f'accuracy={acc:.6f}')\n")
SERIES_TRIAL_CODE = ("import os\n"
                     "lr = float(os.environ['LR'])\n"
                     "for i, a in enumerate([0.5, 0.7, 0.9]):\n"
                     "    print(f'accuracy={a}', flush=True)\n")


def _sweep_spec(name, algorithm, max_trials, goal=None, code=TRIAL_CODE, settings=None,
                gpu=True):
    container = {"name": "main", "command": [PY, "-u", "-c", code],
                 "env": [{"name": "LR", "value": "${trialParameters.lr}"}]}
    if gpu:  # the port's trial pods ask for a card of the GPU node
        container["resources"] = {"requests": {"nvidia.com/gpu": 1}}
    trial_spec = {"apiVersion": "kubeflow.org/v1", "kind": "TPUJob", "spec": {
        "replicaSpecs": {"Worker": {"replicas": 1, "restartPolicy": "Never",
                                    "template": {"spec": {"containers": [container]}}}},
        "runPolicy": {"cleanPodPolicy": "None"}}}
    return experiment(name, parameters=[Parameter("lr", "double", min=0.01, max=1.0)],
                      trial_spec=trial_spec, objective_metric="accuracy",
                      objective_type="maximize", goal=goal, algorithm=algorithm,
                      algorithm_settings=settings, max_trials=max_trials, parallel_trials=3)


def _kcluster(plane: str = "port"):
    if plane == "jax":
        c = JCluster(cpu_nodes=1)
        jtraining_install(c.api, c.manager)
        c.katib = jkatib_install(c.api, c.manager, c.logs)
        return c
    c = TCluster(cpu_nodes=1, gpu_nodes=(("h100", "h100", 2),))
    training_install(c.api, c.manager)
    c.katib = katib_install(c.api, c.manager, c.logs)
    return c


@pytest.fixture()
def kcluster():
    c = _kcluster()
    yield c
    c.shutdown()


def _reason(exp: dict) -> str:
    return [c for c in exp["status"]["conditions"] if c["type"] == kapi.SUCCEEDED][0]["reason"]


def test_series_experiment_matches_the_jax_plane():
    """Two trials printing an accuracy series (random_state 5): the same
    trials, assignments, observations, optimal trial and condition states
    on both planes (the port's trials on its GPU node)."""
    got = {}
    for plane in ("jax", "port"):
        c = _kcluster(plane)
        try:
            watch = c.api.watch("Experiment")
            spec = _sweep_spec("series", "random", max_trials=2, code=SERIES_TRIAL_CODE,
                               settings={"random_state": 5}, gpu=plane == "port")
            c.api.create(spec)
            assert c.wait_for(lambda: has_condition(
                (c.api.try_get("Experiment", "series") or {}).get("status", {}), "Succeeded"),
                timeout=120)
            states = []
            while (ev := watch.poll()) is not None:
                st = [[x["type"], x["status"], x.get("reason", "")]
                      for x in ev.object.get("status", {}).get("conditions", [])]
                if not states or states[-1] != st:
                    states.append(st)
            exp = c.api.get("Experiment", "series")
            trials = sorted(c.api.list("Trial"), key=lambda t: t["metadata"]["name"])
            got[plane] = {
                "states": states,
                "counts": {k: exp["status"][k] for k in ("trials", "trialsSucceeded",
                                                         "trialsFailed", "trialsRunning")},
                "optimal": exp["status"]["currentOptimalTrial"],
                "trials": [(t["metadata"]["name"], t["spec"]["parameterAssignments"],
                            t["status"]["observation"]) for t in trials],
                "nodes": sorted({p["spec"]["nodeName"] for p in c.api.list("Pod")})}
        finally:
            c.shutdown()
    assert got["jax"]["nodes"] == ["cpu-0"] and got["port"]["nodes"] == ["h100"]
    for k in ("states", "counts", "optimal", "trials"):
        assert got["port"][k] == got["jax"][k], k
    assert got["port"]["counts"]["trialsSucceeded"] == 2


def test_observation_series_survive_pod_gc_and_service(kcluster):
    client = KatibClient(kcluster)
    spec = _sweep_spec("series", "random", max_trials=2, code=SERIES_TRIAL_CODE)
    client.create_experiment(spec)
    assert client.wait_for_experiment("series", timeout=300) == kapi.SUCCEEDED
    store = kcluster.katib[2].store
    trials = client.list_trials("series")
    assert len(trials) == 2
    tname = trials[0]["metadata"]["name"]
    series = store.get_log(tname, "accuracy")
    assert [v for _, v in series] == [0.5, 0.7, 0.9]
    for pod in kcluster.api.list("Pod"):
        kcluster.api.try_delete("Pod", pod["metadata"]["name"],
                                pod["metadata"].get("namespace", "default"))
    kcluster.settle()
    assert store.get_log(tname, "accuracy") == series
    svc = KatibService(kcluster.api, store)
    exps = svc.list_experiments()
    assert [e["name"] for e in exps] == ["series"]
    assert exps[0]["status"] == "Succeeded" and exps[0]["trialsSucceeded"] == 2
    detail = svc.get_experiment("series")
    assert detail["currentOptimalTrial"] is not None and len(detail["trials"]) == 2
    tdetail = svc.get_trial(tname)
    assert tdetail["status"] == "Succeeded"
    assert tdetail["observationLog"]["accuracy"] == [{"step": s, "value": v} for s, v in series]
    assert svc.get_trial("missing") is None


def test_tfevent_collector_trial_e2e(kcluster, tmp_path):
    logdir = str(tmp_path / "tb")
    code = ("import os, sys\n"
            "from kubeflow_tpu_torch.katib.metrics import TFEventWriter\n"
            "w = TFEventWriter(os.environ['LOGDIR'])\n"
            "for i, a in enumerate([0.55, 0.75]):\n"
            "    w.scalar('accuracy', a, i)\n"
            "w.close()\n")
    client = KatibClient(kcluster)
    spec = _sweep_spec("tfev", "random", max_trials=1, code=code)
    container = spec["spec"]["trialTemplate"]["trialSpec"]["spec"]["replicaSpecs"]["Worker"][
        "template"]["spec"]["containers"][0]
    container["env"] += [{"name": "LOGDIR", "value": logdir}, {"name": "PYTHONPATH", "value": REPO}]
    spec["spec"]["metricsCollectorSpec"] = {"collector": {"kind": "TFEvent"},
                                            "source": {"fileSystemPath": {"path": logdir}}}
    client.create_experiment(spec)
    assert client.wait_for_experiment("tfev", timeout=300) == kapi.SUCCEEDED
    store = kcluster.katib[2].store
    tname = client.list_trials("tfev")[0]["metadata"]["name"]
    assert [round(v, 4) for _, v in store.get_log(tname, "accuracy")] == [0.55, 0.75]


def test_trial_metrics_unavailable_fails(kcluster):
    client = KatibClient(kcluster)
    spec = _sweep_spec("nometrics", "random", max_trials=2, code="print('no metrics here')")
    spec["spec"]["maxFailedTrialCount"] = 1
    client.create_experiment(spec)
    assert client.wait_for_experiment("nometrics", timeout=300) == kapi.FAILED


@pytest.mark.slow
def test_experiment_random_lr_sweep_e2e(kcluster):
    client = KatibClient(kcluster)
    client.create_experiment(_sweep_spec("sweep", "random", max_trials=5))
    assert client.wait_for_experiment("sweep", timeout=300) == kapi.SUCCEEDED
    assert client.get_experiment("sweep")["status"]["trialsSucceeded"] == 5
    optimal = client.get_optimal_trial("sweep")
    best = max(m["latest"] for t in client.list_trials("sweep")
               for m in t.get("status", {}).get("observation", {}).get("metrics", [])
               if m["name"] == "accuracy")
    got = [m for m in optimal["observation"]["metrics"] if m["name"] == "accuracy"][0]["latest"]
    assert got == best


@pytest.mark.slow
def test_experiment_goal_early_stop(kcluster):
    client = KatibClient(kcluster)
    client.create_experiment(_sweep_spec("goal", "random", max_trials=50, goal=0.05))
    assert client.wait_for_experiment("goal", timeout=300) == kapi.SUCCEEDED
    exp = client.get_experiment("goal")
    assert exp["status"]["trialsSucceeded"] < 50 and _reason(exp) == "GoalReached"


@pytest.mark.slow
def test_grid_exhaustion_ends_experiment(kcluster):
    client = KatibClient(kcluster)
    client.create_experiment(_sweep_spec("smallgrid", "grid", max_trials=10,
                                         settings={"default_steps": 3}))
    assert client.wait_for_experiment("smallgrid", timeout=300) == kapi.SUCCEEDED
    exp = client.get_experiment("smallgrid")
    assert exp["status"]["trialsSucceeded"] == 3 and _reason(exp) == "SuggestionEndReached"


@pytest.mark.slow
def test_push_collector_sidecar_e2e(kcluster):
    """collector.kind Push: the webhook injects the port's collector
    (``kubeflow_tpu_torch.katib.collector_main``) as a sidecar, which
    pushes to the db-manager; the trial controller never pulls."""
    client = KatibClient(kcluster)
    spec = _sweep_spec("pushsweep", "random", max_trials=3)
    spec["spec"]["metricsCollectorSpec"] = {"collector": {"kind": "Push"}}
    container = spec["spec"]["trialTemplate"]["trialSpec"]["spec"]["replicaSpecs"]["Worker"][
        "template"]["spec"]["containers"][0]
    container["env"].append({"name": "PYTHONPATH", "value": REPO})
    client.create_experiment(spec)
    assert client.wait_for_experiment("pushsweep", timeout=300) == kapi.SUCCEEDED
    assert client.get_experiment("pushsweep")["status"]["trialsSucceeded"] == 3
    store = kcluster.katib[2].store
    for t in client.list_trials("pushsweep"):
        assert store.count(t["metadata"]["name"], "accuracy") > 0
        assert any(m["name"] == "accuracy" for m in t["status"]["observation"]["metrics"])
    pods = [p for p in kcluster.api.list("Pod") if p["metadata"].get("labels", {}).get(
        tapi.LABEL_JOB_NAME, "").startswith("pushsweep")]
    assert pods
    for p in pods:
        collector = [ct for ct in p["spec"]["containers"] if ct.get("name") == "metrics-collector"]
        assert collector
        assert collector[0]["command"][-1] == "kubeflow_tpu_torch.katib.collector_main"


@pytest.mark.slow
def test_bare_pod_trial_experiment_succeeds(kcluster):
    c = kcluster
    exp = experiment(
        "podtrial", [Parameter("lr", "double", min=0.1, max=0.9)],
        {"apiVersion": "v1", "kind": "Pod",
         "spec": {"restartPolicy": "Never", "containers": [{
             "name": "main", "command": [PY, "-u", "-c", "print('accuracy=${trialParameters.lr}')"],
             "resources": {"requests": {"nvidia.com/gpu": 1}}}]}},
        objective_metric="accuracy", algorithm="random", max_trials=3, parallel_trials=2)
    c.api.create(exp)
    assert c.wait_for(lambda: has_condition(
        (c.api.try_get("Experiment", "podtrial") or {}).get("status", {}), kapi.SUCCEEDED),
        timeout=90)
    opt = c.api.get("Experiment", "podtrial")["status"]["currentOptimalTrial"]
    lr = float(opt["parameterAssignments"][0]["value"])
    assert abs(float(opt["observation"]["metrics"][0]["latest"]) - lr) < 1e-9


@pytest.mark.slow
def test_darts_trial_e2e_recovers_genotype(kcluster):
    """chip_smoke.py's 22(e) experiment on the CPU: one TPUJob trial running
    the port's DARTS worker at seed 37 recovers the all-relu_linear
    genotype."""
    spec = chip_smoke.darts_experiment()
    container = spec["spec"]["trialTemplate"]["trialSpec"]["spec"]["replicaSpecs"]["Worker"][
        "template"]["spec"]["containers"][0]
    container["env"] += [{"name": "TORCH_DEVICE", "value": "cpu"},
                         {"name": "PYTHONPATH", "value": REPO}]
    client = KatibClient(kcluster)
    client.create_experiment(spec)
    assert client.wait_for_experiment("darts", timeout=600) == kapi.SUCCEEDED
    optimal = client.get_optimal_trial("darts")
    acc = [m for m in optimal["observation"]["metrics"] if m["name"] == "val_acc"][0]["latest"]
    assert acc > 0.5, acc
    runs = chip_smoke.job_runs(kcluster.logs(f"{optimal['bestTrialName']}-worker-0"))
    geno = json.loads(chip_smoke.line_value(runs[-1]["lines"], "genotype"))
    assert geno == ["relu_linear"] * 4
    assert {a["name"]: a["value"] for a in optimal["parameterAssignments"]}["seed"] == "37"


@pytest.mark.slow
def test_phase_22_lr_sweep_runs_its_rates_on_the_cpu(kcluster):
    """chip_smoke.py's 22(f) experiment on the CPU: three trials, two at a
    time, at the rates the phase holds the card's run to, and an optimal
    trial whose accuracy is above both others'."""
    spec = chip_smoke.mnist_lr_experiment()
    container = spec["spec"]["trialTemplate"]["trialSpec"]["spec"]["replicaSpecs"]["Worker"][
        "template"]["spec"]["containers"][0]
    env = {e["name"]: e["value"] for e in container["env"]}
    env.update(TORCH_DEVICE="cpu", PYTHONPATH=REPO)
    container["env"] = [{"name": k, "value": v} for k, v in env.items()]
    client = KatibClient(kcluster)
    client.create_experiment(spec)
    assert client.wait_for_experiment("mnist-lr", timeout=300) == kapi.SUCCEEDED
    trials = sorted(client.list_trials("mnist-lr"), key=lambda t: t["metadata"]["name"])
    rates = [a["value"] for t in trials for a in t["spec"]["parameterAssignments"]]
    assert rates == chip_smoke.MNIST_LR_RATES
    status = client.get_experiment("mnist-lr")["status"]
    assert status["trialsSucceeded"] == 3
    acc = {t["metadata"]["name"]: m["latest"] for t in trials
           for m in t["status"]["observation"]["metrics"] if m["name"] == "accuracy"}
    best = status["currentOptimalTrial"]["bestTrialName"]
    assert all(float(a) < float(acc[best]) for t, a in acc.items() if t != best), acc
