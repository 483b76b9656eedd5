"""Port parity: BASELINE config 4 (fine-tune -> evaluate -> gated deploy) on
the port's pipeline SDK, at the pipeline's tiny defaults on the CPU.

- The port's compiled IR dict runs on the reference control plane
  (``Client(Cluster(...)).create_run_from_pipeline_func(ir)``): its step
  pods exec the port's component sources under the reference launcher,
  with ``TORCH_DEVICE=cpu``.  The assertions are those of the reference
  e2e (tests/test_model_families.py:163-171); ``max_perplexity=1.0``
  skips ``deploy``.
- The port's launcher and the reference's run the same ``task.json`` of
  each step and write the same ``outputs.json``.
- The artifacts cross both ways: the port's deployed dir served by the
  port's and the JAX package's ``JetStreamModel``, and the JAX pipeline's
  dir served by the port's, every greedy token within the tie-aware bound
  of the JAX ``forward_full`` on the dir's weights; the port's
  ``evaluate`` loss equals the JAX ``lm_loss`` on the same weights and
  tokens."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kubeflow_tpu.core.cluster import Cluster
from kubeflow_tpu.examples import gemma_pipeline as JG
from kubeflow_tpu.models import decoder as jdec
from kubeflow_tpu.pipelines import api as papi
from kubeflow_tpu.pipelines import dsl as jdsl
from kubeflow_tpu.pipelines import launcher_main as j_launcher
from kubeflow_tpu.pipelines.client import Client
from kubeflow_tpu.serving.engine import model as JM
from kubeflow_tpu.serving.engine.serve import JetStreamModel as JJetStreamModel
from kubeflow_tpu_torch.examples.gemma_pipeline import gemma_pipeline
from kubeflow_tpu_torch.models import decoder as tdec
from kubeflow_tpu_torch.pipelines import launcher_main as t_launcher
from kubeflow_tpu_torch.pipelines.artifacts import ObjectStore
from kubeflow_tpu_torch.pipelines.compiler import Compiler
from kubeflow_tpu_torch.serving.engine.serve import JetStreamModel

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IR = Compiler().compile(gemma_pipeline)
DEFAULTS = {p: d["defaultValue"] for p, d in IR["root"]["inputDefinitions"]["parameters"].items()}
CFG_FIELDS = ("vocab_size", "d_model", "n_layers", "n_heads", "n_kv_heads", "d_ff")
STEPS = 8
# the reference's bf16 logit bound (tests/test_engine.py:211), the loss
# bound of tests/test_torch_decoder.py
BF16_TOL = 5e-2
TIE_EPS = 5e-2
PROMPTS = ["the quick brown fox", "pipelines deploy what they train: "]
MAX_TOKENS = 8
# a small engine geometry, read by both packages' JetStreamModel.load
ENGINE_JSON = {"max_slots": 2, "page_size": 8, "num_pages": 64, "max_pages_per_slot": 16}


@pytest.fixture(scope="module")
def cluster():
    c = Cluster(cpu_nodes=1, base_env={"PYTHONPATH": REPO, "TORCH_DEVICE": "cpu"})
    yield c
    c.shutdown()


def test_port_ir_runs_on_the_reference_control_plane(cluster):
    run = Client(cluster).create_run_from_pipeline_func(IR, arguments={"steps": 20})
    rec = run.wait(timeout=240)
    assert rec["phase"] == papi.SUCCEEDED, rec
    nodes = rec["nodes"]
    ft = nodes["finetune"]["outputArtifacts"]["metrics"]["metadata"]
    assert ft["final_loss"] < ft["first_loss"]
    assert nodes["evaluate"]["outputParameters"]["Output"] < 1000.0
    assert nodes["deploy"]["phase"] == papi.SUCCEEDED
    assert nodes["deploy"]["outputParameters"]["Output"].startswith("mstore://")
    assert nodes["finetune"]["outputArtifacts"]["model"]["metadata"] == {"family": "gemma"}


def test_max_perplexity_one_skips_deploy(cluster):
    run = Client(cluster).create_run_from_pipeline_func(
        IR, arguments={"steps": 5, "max_perplexity": 1.0})
    rec = run.wait(timeout=240)
    nodes = rec["nodes"]
    assert nodes["finetune"]["phase"] == nodes["evaluate"]["phase"] == papi.SUCCEEDED
    assert nodes["evaluate"]["outputParameters"]["Output"] >= 1.0
    assert nodes["deploy"]["phase"] == papi.SKIPPED


# ------------------------------------------------------------- the launchers


def _task_doc(name: str, params: dict, in_arts: dict, store, run_id: str) -> dict:
    """The ``task.json`` the reference workflow controller writes for step
    ``name`` of the port's IR (kubeflow_tpu/pipelines/workflow.py:431-447)."""
    comp = IR["components"][IR["root"]["dag"]["tasks"][name]["componentRef"]]
    executor = IR["deploymentSpec"]["executors"][comp["executorLabel"]]
    return {"functionName": executor["python"]["functionName"],
            "source": executor["python"]["source"],
            "defaults": executor["python"].get("defaults", {}),
            "parameters": params, "inputArtifacts": in_arts,
            "outputArtifacts": {a: {"uri": store.uri("mlpipeline", f"{run_id}/{name}/{a}"),
                                    "type": d["schemaTitle"]}
                                for a, d in comp["outputDefinitions"]["artifacts"].items()},
            "outputParameters": sorted(comp["outputDefinitions"]["parameters"]),
            "storeRoot": store.root}


def _run_step(launcher, root: str, name: str, doc: dict) -> dict:
    ws = os.path.join(root, "ws", name)
    os.makedirs(ws)
    with open(os.path.join(ws, "task.json"), "w") as f:
        json.dump(doc, f)
    assert launcher.run(ws) == 0
    with open(os.path.join(ws, "outputs.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """The three steps of the port's IR at the tiny defaults (``STEPS``
    steps), each run by the port's launcher and by the reference's on the
    same task doc, each launcher with its own store.  Returns, per
    launcher, the store and each step's ``outputs.json``."""
    mp = pytest.MonkeyPatch()
    mp.setenv("TORCH_DEVICE", "cpu")
    args = dict(DEFAULTS, steps=STEPS)
    out = {}
    try:
        for pkg, launcher in (("port", t_launcher), ("jax", j_launcher)):
            root = str(tmp_path_factory.mktemp(pkg))
            store = ObjectStore(os.path.join(root, "objects"))
            ft_params = {k: args[k] for k in CFG_FIELDS + ("steps", "batch_size", "seq_len")}
            ft = _run_step(launcher, root, "finetune",
                           _task_doc("finetune", ft_params, {}, store, "r"))
            model = {"uri": store.uri("mlpipeline", "r/finetune/model"), "type": "system.Model",
                     "metadata": ft["artifactMetadata"]["model"]}
            ev = _run_step(launcher, root, "evaluate", _task_doc(
                "evaluate", {"batch_size": args["batch_size"], "seq_len": args["seq_len"]},
                {"model": model}, store, "r"))
            dp = _run_step(launcher, root, "deploy", _task_doc(
                "deploy", {}, {"model": model}, store, "r"))
            out[pkg] = {"store": store, "finetune": ft, "evaluate": ev, "deploy": dp}
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("step", ["finetune", "evaluate", "deploy"])
def test_both_launchers_write_the_same_outputs(launched, step):
    assert launched["port"][step] == launched["jax"][step]
    if step == "deploy":
        uri = launched["port"]["deploy"]["outputParameters"]["Output"]
        assert uri == launched["port"]["store"].uri("mlpipeline", "r/finetune/model")


def test_both_launchers_store_the_same_weights(launched):
    dirs = [launched[p]["store"]._path(launched[p]["deploy"]["outputParameters"]["Output"])
            for p in ("port", "jax")]
    a, b = (np.load(os.path.join(d, "params.npz")) for d in dirs)
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        assert a[k].dtype == np.float32
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for d in dirs:
        with open(os.path.join(d, "config.json")) as f:
            assert json.load(f) == {k: DEFAULTS[k] for k in CFG_FIELDS}


# ------------------------------------------------- the artifacts, both ways


def _jax_params(model_dir: str):
    """What the JAX package's loader makes of a model dir: config and bf16
    params (kubeflow_tpu/serving/engine/model.py ``load_params``)."""
    cfg = JM.DecoderConfig.from_dir(model_dir)
    return cfg, JM.load_params(model_dir, cfg)


def _serve(model, prompts=PROMPTS) -> list:
    model.load()
    try:
        return [model.generate({"text_input": p, "parameters": {"max_tokens": MAX_TOKENS}})
                ["token_ids"] for p in prompts]
    finally:
        model.engine.stop()


def _assert_tie_aware(cfg, params, prompt: str, got: list):
    """Every served token within TIE_EPS of the JAX ``forward_full`` max
    logit along its own trajectory."""
    ids = list(prompt.encode())
    toks = np.asarray([ids + list(got)], np.int32)
    rows = np.asarray(jax.jit(lambda p, t: JM.forward_full(p, cfg, t))(params, toks))[0]
    rows = rows[len(ids) - 1:toks.shape[1] - 1]
    assert len(got) == MAX_TOKENS
    for i, g in enumerate(got):
        assert rows[i, g] >= rows[i].max() - TIE_EPS, (i, g, int(rows[i].argmax()))


def _with_engine_json(src: str, dst: str) -> str:
    import shutil

    shutil.copytree(src, dst)
    with open(os.path.join(dst, "engine.json"), "w") as f:
        json.dump(ENGINE_JSON, f)
    return dst


@pytest.fixture(scope="module")
def port_dir(launched, tmp_path_factory):
    store = launched["port"]["store"]
    src = store._path(launched["port"]["deploy"]["outputParameters"]["Output"])
    return _with_engine_json(src, str(tmp_path_factory.mktemp("served") / "m"))


@pytest.mark.parametrize("server", ["port", "jax"])
def test_port_deployed_dir_serves_in_both_packages(port_dir, server):
    model = (JetStreamModel("m", port_dir, device="cpu") if server == "port"
             else JJetStreamModel("m", port_dir))
    cfg, params = _jax_params(port_dir)
    assert cfg.head_dim == DEFAULTS["d_model"] // DEFAULTS["n_heads"]
    for prompt, got in zip(PROMPTS, _serve(model)):
        _assert_tie_aware(cfg, params, prompt, got)


def test_jax_pipeline_dir_serves_in_the_port(tmp_path):
    """The JAX pipeline's ``finetune``, called directly (a component called
    outside a pipeline is the plain function), writes a dir the port
    serves."""
    model = jdsl.Model(name="model", uri="")
    model.path = str(tmp_path / "jax" / "model")
    metrics = jdsl.Metrics(name="metrics", uri="")
    JG.finetune(**{k: DEFAULTS[k] for k in CFG_FIELDS}, steps=3,
                batch_size=DEFAULTS["batch_size"], seq_len=DEFAULTS["seq_len"],
                model=model, metrics=metrics)
    assert JG.deploy(model=model) == ""
    served = _with_engine_json(model.path, str(tmp_path / "served"))
    cfg, params = _jax_params(served)
    for prompt, got in zip(PROMPTS, _serve(JetStreamModel("m", served, device="cpu"))):
        _assert_tie_aware(cfg, params, prompt, got)


def test_port_evaluate_loss_equals_jax_lm_loss(launched, port_dir):
    """The port's ``evaluate`` draws its held-out batch with numpy (seed 99)
    and the JAX one with ``jax.random``: on the port's draw, the JAX
    ``lm_loss`` of the same bf16 weights gives the port's ``eval_loss``."""
    metrics = launched["port"]["evaluate"]["artifactMetadata"]["metrics"]
    cfg, params = _jax_params(port_dir)
    toks = next(tdec.synthetic_lm_batches(cfg.vocab_size, DEFAULTS["batch_size"],
                                          DEFAULTS["seq_len"], seed=99))["tokens"]
    want = float(jax.jit(lambda p, t: jdec.lm_loss(p, cfg, t))(params, toks))
    np.testing.assert_allclose(metrics["eval_loss"], want, rtol=BF16_TOL, atol=BF16_TOL)
    np.testing.assert_allclose(metrics["perplexity"],
                               float(jnp.exp(jnp.minimum(metrics["eval_loss"], 20.0))),
                               rtol=1e-6)
    assert launched["port"]["evaluate"]["outputParameters"]["Output"] == metrics["perplexity"]


@pytest.mark.parametrize("K", [1, 5])
def test_paged_attention_at_the_served_head_dim_matches_jax(K):
    """The deployed model's decode attention at Gemma-7B width: head_dim
    3072 / 16 = 192, 16 query and 16 kv heads, page 32 (the shape the card
    serves through the CUDA-core kernel).  The port's plain version (what
    its wrapper runs on CPU tensors) against the JAX Pallas kernel in
    interpret mode, bf16, within one bf16 ulp (tests/test_torch_paged_attention.py)."""
    import ml_dtypes
    import torch

    from kubeflow_tpu.serving.engine.paged_attention import paged_attention as jax_paged
    from kubeflow_tpu_torch.serving.engine import paged_attention as PA

    heads, hd, ps, pages = 16, 3072 // 16, 32, 7
    rng = np.random.default_rng(K)
    q = rng.standard_normal((2, K, heads, hd)).astype(ml_dtypes.bfloat16)
    kp, vp = (rng.standard_normal((pages, heads, ps, hd)).astype(ml_dtypes.bfloat16)
              for _ in range(2))
    table = np.array([[1, 4, 6], [2, 3, 0]], np.int32)
    lens = np.array([70, 33], np.int32)
    ref = jax_paged(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
                    jnp.asarray(lens), ps, interpret=True)

    def t(x):
        return torch.from_numpy(x.view(np.int16)).view(torch.bfloat16)

    out = PA.paged_attention(t(q), t(kp), t(vp), torch.from_numpy(table),
                             torch.from_numpy(lens), ps)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               rtol=1e-2, atol=1e-2)
