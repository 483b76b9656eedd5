"""Port parity: the Trainer on a mesh (train/trainer.py with ``mesh=``,
``rules=``), BERT's mesh path (models/bert.py) and the BERT worker over
``LOCAL_DEVICES`` shards.

The port's mesh trainer runs the tiny BERT of tests/test_models_training.py
against the JAX ``Trainer`` on the same numpy weights and batches (the JAX
side on tests/conftest.py's 8 virtual CPU devices, the port's on
``["cpu"] * 8``) at the meshes of ``__graft_entry__._mesh_factors(8)`` and
the reference's slow lane: per-step loss within 1e-2 absolute
(tests/test_models_training.py's sharded-vs-single bound), gradient norm
within 1.22e-2 relative (the flash-vs-dense bound of the card's BERT-base
run).  Then against the port's one-device trainer, and on its own:
convergence, checkpoints re-sharded on restore, the exact masked mean,
remat, flash and the worker."""

import dataclasses
import importlib
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import bert as jbert
from kubeflow_tpu.parallel import mesh as jmesh
from kubeflow_tpu.train import data as jdata
from kubeflow_tpu.train.trainer import Trainer as JTrainer
from kubeflow_tpu.train.trainer import TrainerConfig as JTrainerConfig
from kubeflow_tpu_torch.models import bert as tbert
from kubeflow_tpu_torch.parallel import mesh as tmesh
from kubeflow_tpu_torch.parallel import sharding as tsharding
from kubeflow_tpu_torch.parallel.sharding import ShardedTensor
from kubeflow_tpu_torch.train import data as tdata
from kubeflow_tpu_torch.train.trainer import Trainer, TrainerConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
            intermediate_size=128, max_position=64)
LOSS_ATOL, NORM_RTOL = 1e-2, 1.22e-2
STEPS = 3
# the masked positions each sequence keeps for the vocab projection: this
# file's own step shape, so no other test's compiled JAX step is shared
MAX_PRED = 4
MESHES = {"fsdp8": dict(data=1, fsdp=8, tensor=1),
          "d2f2t2": dict(data=2, fsdp=2, tensor=2),
          "f2t4": dict(data=1, fsdp=2, tensor=4)}
FA = importlib.import_module("kubeflow_tpu_torch.ops.flash_attention")


def _config(**kw):
    return TrainerConfig(learning_rate=1e-3, warmup_steps=1, total_steps=10, **kw)


def _batches(n, seed=3, batch=8, seq=16):
    gen = tdata.synthetic_mlm_batches(TINY["vocab_size"], batch, seq, seed=seed)
    return [next(gen) for _ in range(n)]


@pytest.fixture(scope="module")
def np_tree():
    return jax.tree.map(np.asarray, jbert.init(jax.random.PRNGKey(0), jbert.BertConfig(**TINY)))


def _port_loss(cfg):
    def loss_fn(m, b):
        return tbert.mlm_loss(m, cfg, b["input_ids"], b["labels"], b["attention_mask"],
                              max_predictions=MAX_PRED)
    return loss_fn


def _port_trainer(np_tree, sizes=None, cfg=None, config=None):
    cfg = cfg or tbert.BertConfig(**TINY)
    model = tbert.params_from_jax(np_tree, "cpu")
    if sizes is None:
        return Trainer(_port_loss(cfg), model, config or _config(), device="cpu")
    mesh = tmesh.build_mesh(tmesh.MeshConfig(**sizes), ["cpu"] * 8)
    return Trainer(_port_loss(cfg), model, config or _config(), mesh=mesh,
                   rules=tbert.SHARDING_RULES)


def _close(got, want):
    for g, w in zip(got, want):
        assert abs(g["loss"] - w["loss"]) <= LOSS_ATOL, (got, want)
        assert abs(g["grad_norm"] - w["grad_norm"]) <= NORM_RTOL * abs(w["grad_norm"]), (got, want)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_mesh_trainer_matches_jax(np_tree, mesh):
    sizes = MESHES[mesh]
    cfg = jbert.BertConfig(**TINY)

    def loss_fn(p, b):
        return jbert.mlm_loss(p, cfg, b["input_ids"], b["labels"], b["attention_mask"],
                              max_predictions=MAX_PRED)

    jm = jmesh.build_mesh(jmesh.MeshConfig(**sizes), jax.devices()[:8])
    jt = JTrainer(loss_fn, jax.tree.map(jax.numpy.asarray, np_tree), jm, jbert.SHARDING_RULES,
                  JTrainerConfig(learning_rate=1e-3, warmup_steps=1, total_steps=10))
    batches = _batches(STEPS)
    want = [jt.train_step(b) for b in batches]
    tt = _port_trainer(np_tree, sizes)
    got = [tt.train_step(b) for b in batches]
    _close(got, want)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_mesh_trainer_matches_one_device(np_tree, mesh):
    batches = _batches(STEPS)
    one = _port_trainer(np_tree)
    want = [one.train_step(b) for b in batches]
    tt = _port_trainer(np_tree, MESHES[mesh])
    got = [tt.train_step(b) for b in batches]
    _close(got, want)
    # the parameters after the steps: Adam's m/sqrt(v) turns a sign flip of
    # a near-zero gradient into a whole step of the learning rate, and two
    # of the three steps move by ~1e-3 (the first is warmup's lr 0)
    for name, st in tt.params.items():
        np.testing.assert_allclose(st.gather().detach().numpy(),
                                   one.params[name].detach().numpy(), atol=2.5e-3)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_params_and_moments_hold_their_rules_shard_shapes(np_tree, mesh):
    tt = _port_trainer(np_tree, MESHES[mesh])
    tt.train_step(_batches(1)[0])
    for name, st in tt.params.items():
        shape = st.sharding.shard_shape(tuple(st.shape))
        for side in ("mu", "nu"):
            moment = tt.opt_state[side][name]
            assert moment.spec == st.spec and moment.shape == st.shape
            assert [tuple(t.shape) for t in moment.shards] == [shape] * tt.mesh.size
        assert [tuple(t.shape) for t in st.shards] == [shape] * tt.mesh.size
        # one device: each distinct slice once
        assert len(st.locals) == len({st.block(p) for p in range(tt.mesh.size)})


def test_loss_decreases_over_eight_steps_at_fsdp8(np_tree):
    tt = _port_trainer(np_tree, MESHES["fsdp8"], config=TrainerConfig(
        learning_rate=1e-3, warmup_steps=2, total_steps=50))
    data = tdata.synthetic_mlm_batches(TINY["vocab_size"], batch_size=16, seq_len=32, seed=1)
    losses = [tt.train_step(next(data))["loss"] for _ in range(8)]
    assert losses[-1] < losses[0], losses


def test_checkpoint_save_restore_reshards(np_tree, tmp_path):
    cfg = _config(checkpoint_dir=str(tmp_path / "ckpt"), checkpoint_every=2)
    t1 = _port_trainer(np_tree, dict(fsdp=2, data=4), config=cfg)
    batches = _batches(6, seed=5)
    for b in batches[:4]:
        t1.train_step(b)
    t1.finalize()
    saved = t1._state()  # the global tensors; a replicated leaf's is t1's own
    saved = {"params": {n: t.detach().clone() for n, t in saved["params"].items()},
             "opt_state": {k: {n: t.clone() for n, t in saved["opt_state"][k].items()}
                           for k in ("mu", "nu")}}
    # the same mesh, another mesh and one device all read it back
    for sizes in (dict(fsdp=2, data=4), dict(fsdp=2, tensor=4), None):
        t2 = _port_trainer(np_tree, sizes, config=cfg)
        assert t2.restore_latest() and t2.step_num == 4
        assert t2.opt_state["count"] == 4
        for name, want in saved["params"].items():
            got = t2.params[name]
            got = got.gather() if isinstance(got, ShardedTensor) else got
            assert torch.equal(got.detach(), want), name
            for side in ("mu", "nu"):
                m = t2.opt_state[side][name]
                m = m.gather() if isinstance(m, ShardedTensor) else m
                assert torch.equal(m, saved["opt_state"][side][name]), (side, name)
        if sizes == dict(fsdp=2, data=4):
            # both continue identically from the restored state
            assert t1.train_step(batches[4])["loss"] == t2.train_step(batches[4])["loss"]


def test_mlm_loss_is_the_exact_mean_under_uneven_masked_counts(np_tree):
    """Shard 0's rows carry 1 masked position each, shard 1's 12: the
    global mean over the 26 positions, not the mean of the shards' means."""
    cfg = tbert.BertConfig(**TINY, dtype=torch.float32)
    model = tbert.params_from_jax(np_tree, "cpu")
    rng = np.random.default_rng(7)
    ids = torch.from_numpy(rng.integers(104, 512, (4, 16), dtype=np.int64))
    labels = torch.full((4, 16), -100, dtype=torch.int64)
    labels[:2, 3] = ids[:2, 3]
    labels[2:, 2:14] = ids[2:, 2:14]
    am = torch.ones((4, 16), dtype=torch.int64)
    want = tbert.mlm_loss(model, cfg, ids, labels, am)
    mesh = tmesh.build_mesh(tmesh.MeshConfig(fsdp=2), ["cpu"] * 2)
    with mesh:
        got = tbert.mlm_loss(model, cfg, ids, labels, am)
    halves = [tbert.mlm_loss(model, cfg, ids[i:i + 2], labels[i:i + 2], am[i:i + 2])
              for i in (0, 2)]
    got, want = float(got.detach()), float(want.detach())
    assert abs(got - want) <= 1e-6
    assert abs(got - float(sum(halves).detach()) / 2) > 1e-3


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_encode_and_forward_on_a_mesh_match_one_device(np_tree, mesh):
    """``encode`` and ``forward`` under ``with mesh:`` give ShardedTensors
    split over the batch; gathered, they are the one-device results (f32:
    summation order only)."""
    cfg = tbert.BertConfig(**TINY, dtype=torch.float32)
    model = tbert.params_from_jax(np_tree, "cpu")
    b = _batches(1)[0]
    ids, am = torch.from_numpy(b["input_ids"]), torch.from_numpy(b["attention_mask"])
    am[1, 9:] = 0
    m = tmesh.build_mesh(tmesh.MeshConfig(**MESHES[mesh]), ["cpu"] * 8)
    with torch.no_grad():
        want_h = tbert.encode(model, cfg, ids, am)
        want = tbert.forward(model, cfg, ids, am)
        with m:
            hidden = tbert.encode(model, cfg, ids, am)
            logits = tbert.forward(model, cfg, ids, am)
    assert isinstance(hidden, ShardedTensor) and tuple(hidden.shape) == tuple(want_h.shape)
    assert tuple(logits.spec) == (("data", "fsdp"),)
    torch.testing.assert_close(hidden.gather(), want_h, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(logits.gather(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_f32_loss_and_every_gradient_match_one_device(np_tree, mesh):
    """In f32 the mesh's loss and each parameter's gradient (gathered from
    the local slices: the fsdp gathers' reduce-scatter, the tensor split,
    replicas summed into their one tensor) are the one-device ones up to
    summation order."""
    cfg = tbert.BertConfig(**TINY, dtype=torch.float32)
    model = tbert.params_from_jax(np_tree, "cpu")
    b = {k: torch.from_numpy(v) for k, v in _batches(1)[0].items()}
    b["attention_mask"][2, 11:] = 0
    args = (b["input_ids"], b["labels"], b["attention_mask"])
    want = tbert.mlm_loss(model, cfg, *args, max_predictions=MAX_PRED)
    want.backward()
    m = tmesh.build_mesh(tmesh.MeshConfig(**MESHES[mesh]), ["cpu"] * 8)
    tree = tsharding.shard_params(model, m, tbert.SHARDING_RULES)
    for group in tree.values():
        for st in group.values():
            for t in st.locals:
                t.requires_grad_(True)
    with m:
        got = tbert.mlm_loss(tree, cfg, *args, max_predictions=MAX_PRED)
    got.backward()
    torch.testing.assert_close(got.detach(), want.detach(), rtol=1e-5, atol=1e-6)
    for group, leaves in tree.items():
        for name, st in leaves.items():
            grad = st.like([t.grad for t in st.shards]).gather()
            torch.testing.assert_close(grad, model[group][name].grad, rtol=1e-4, atol=1e-6,
                                       msg=lambda m_: f"{group}.{name}: {m_}")


@pytest.mark.parametrize("policy", ["nothing", "dots", "save_mlp"])
def test_remat_on_a_mesh_matches_no_remat(np_tree, policy):
    sizes = MESHES["d2f2t2"]
    plain = _port_trainer(np_tree, sizes)
    remat = _port_trainer(np_tree, sizes, cfg=tbert.BertConfig(
        **TINY, remat=True, remat_policy=policy))
    for b in _batches(2):
        assert plain.train_step(b) | {"step_time_s": 0} == remat.train_step(b) | {
            "step_time_s": 0}
    for name, st in plain.params.items():
        assert torch.equal(st.gather(), remat.params[name].gather()), name


def test_flash_on_a_mesh_runs_one_forward_per_batch_and_tensor_shard(np_tree):
    """On CPU tensors the flash wrapper runs its plain version: one call per
    (batch shard, tensor shard, layer), each on its shard's heads."""
    sizes = MESHES["d2f2t2"]
    flash = tbert.BertConfig(**TINY, attention="flash")
    dense = _port_trainer(np_tree, sizes)
    tt = _port_trainer(np_tree, sizes, cfg=flash)
    calls = []
    plain = FA.flash_attention_plain

    def counting(q, *a, **kw):
        calls.append(tuple(q.shape))
        return plain(q, *a, **kw)

    FA.flash_attention_plain = counting
    try:
        b = _batches(1)[0]
        got = tt.train_step(b)
    finally:
        FA.flash_attention_plain = plain
    batch_shards = sizes["data"] * sizes["fsdp"]
    heads = TINY["num_heads"] // sizes["tensor"]
    assert calls == [(8 // batch_shards * heads, 16, 16)] * (
        TINY["num_layers"] * batch_shards * sizes["tensor"])
    _close([got], [dense.train_step(b)])


def test_global_batch_and_the_mfu_label(np_tree):
    mesh = tmesh.build_mesh(tmesh.MeshConfig(data=2, fsdp=2, tensor=2), ["cpu"] * 8)
    b = _batches(1)[0]
    gb = tdata.global_batch(b, mesh)
    for k, v in b.items():
        st = gb[k]
        assert tuple(st.spec) == (("data", "fsdp"),) and torch.equal(st.gather(),
                                                                      torch.as_tensor(v))
        assert len(st.locals) == 4 and all(t.shape[0] == 2 for t in st.shards)
    tt = _port_trainer(np_tree, MESHES["d2f2t2"], config=_config())
    tt.flops_per_batch = 1e9
    tt.train_step(b)
    assert tt.mfu(1e12) == pytest.approx(1e9 / tt._history[0]["step_time_s"] / 8e12)
    assert tt.mfu_label == "8 mesh shards on 1 device (cpu)"
    assert dataclasses.asdict(tt.config)["learning_rate"] == 1e-3


def test_worker_on_two_local_devices_resumes_after_preemption(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO, TORCH_DEVICE="cpu", LOCAL_DEVICES="2",
               CHECKPOINT_DIR=str(tmp_path / "ckpt"), TRAIN_STEPS="4",
               CHECKPOINT_EVERY="2", FAIL_AT_STEP="3",
               FAIL_MARKER=str(tmp_path / "failed"))
    for k in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "MASTER_ADDR", "WORLD_SIZE"):
        env.pop(k, None)
    cmd = [sys.executable, "-m", "kubeflow_tpu_torch.examples.bert_worker"]
    first = subprocess.run(cmd, env=env, cwd=REPO, capture_output=True, text=True,
                           timeout=300)
    assert first.returncode == 137, first.stderr[-2000:]
    assert "resumed_from=0" in first.stdout and "TRAIN-DONE" not in first.stdout
    second = subprocess.run(cmd, env=env, cwd=REPO, capture_output=True, text=True,
                            timeout=300)
    assert second.returncode == 0, second.stderr[-2000:]
    assert "resumed_from=2" in second.stdout and "step=1 loss=" not in second.stdout
    assert "TRAIN-DONE step=4" in second.stdout
