"""Port parity: kubeflow_tpu_torch's training stack against the JAX package's.

The synthetic data stream, optax's schedule and clip, and whole optimizer
steps of the tiny f32 BERT (tests/test_models_training.py's config at
dtype=float32) go through both packages on the CPU from the same weights and
batches; then the port's checkpoints and the BERT worker's auto-resume cycle
run on their own."""

import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kubeflow_tpu.models import bert as jbert
from kubeflow_tpu.parallel.mesh import MeshConfig, build_mesh
from kubeflow_tpu.train import data as jdata
from kubeflow_tpu.train.trainer import Trainer as JTrainer
from kubeflow_tpu.train.trainer import TrainerConfig as JTrainerConfig
from kubeflow_tpu_torch.models import bert as tbert
from kubeflow_tpu_torch.train import data as tdata
from kubeflow_tpu_torch.train.checkpoint import CheckpointManager
from kubeflow_tpu_torch.train.trainer import (Trainer, TrainerConfig, default_optimizer,
                                              warmup_cosine_decay)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
            intermediate_size=128, max_position=64)
STEPS = 5
# loss and grad_norm per step: 1e-4 relative (both sides compute the same f32
# graph; the difference is summation order, compounded over the steps).
# Final params: atol 1e-4.  With lr 1e-3, Adam's m/sqrt(v) turns a sign flip
# of a near-zero gradient into a full lr step, so one element could differ
# by ~2e-3; none does at this seed.
STEP_RTOL, PARAM_ATOL = 1e-4, 1e-4


def test_synthetic_batches_are_byte_identical():
    jgen = jdata.synthetic_mlm_batches(512, 4, 16, seed=7)
    tgen = tdata.synthetic_mlm_batches(512, 4, 16, seed=7)
    for _ in range(3):
        jb, tb = next(jgen), next(tgen)
        assert jb.keys() == tb.keys()
        for k in jb:
            assert jb[k].dtype == tb[k].dtype and jb[k].tobytes() == tb[k].tobytes(), k


def test_host_shard_without_process_group():
    assert tdata.host_shard(8) == (8, 0)


@pytest.mark.parametrize("warmup,total", [(2, 16), (100, 10_000), (3, 3)])
def test_schedule_matches_optax_at_every_step(warmup, total):
    mine = warmup_cosine_decay(0.0, 1e-4, warmup, max(total, warmup + 1))
    ref = optax.warmup_cosine_decay_schedule(0.0, 1e-4, warmup, max(total, warmup + 1))
    counts = list(range(0, min(total, 200) + 5)) + [total // 2, total + 50]
    for c in counts:
        # optax evaluates in f32, the port in Python floats: f32 rounding
        np.testing.assert_allclose(mine(c), float(ref(c)), rtol=1e-5, atol=1e-12,
                                   err_msg=f"count {c}")
    assert mine(0) == 0.0  # the first update of a warmup from 0 moves nothing


@pytest.mark.parametrize("scale", [0.01, 1.0, 30.0])
def test_clip_and_adamw_step_match_optax(scale):
    """One chained update (clip + adamw) from a nonzero state, below, at and
    above max_grad_norm, held to optax's on the same leaves."""
    rng = np.random.default_rng(0)
    shapes = {"a": (3, 4), "b": (5,)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    gs = [{k: (rng.standard_normal(s) * scale).astype(np.float32) for k, s in shapes.items()}
          for _ in range(3)]
    cfg = TrainerConfig(learning_rate=1e-2, warmup_steps=1, total_steps=10)
    ref_opt = optax.chain(optax.clip_by_global_norm(cfg.max_grad_norm),
                          optax.adamw(optax.warmup_cosine_decay_schedule(
                              0.0, cfg.learning_rate, 1, 10), weight_decay=cfg.weight_decay))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jst = ref_opt.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    opt = default_optimizer(cfg)
    tst = opt.init(tp)
    for g in gs:
        upd, jst = ref_opt.update({k: jnp.asarray(v) for k, v in g.items()}, jst, jp)
        jp = optax.apply_updates(jp, upd)
        gn = opt.update({k: torch.from_numpy(v) for k, v in g.items()}, tst, tp)
        np.testing.assert_allclose(float(gn), float(optax.global_norm(g)), rtol=1e-6)
    for k in shapes:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7)
    assert tst["count"] == 3


def _loss_fns(cfg_kw):
    jcfg = jbert.BertConfig(**TINY, dtype=jnp.float32, **cfg_kw)
    tcfg = tbert.BertConfig(**TINY, dtype=torch.float32, **cfg_kw)

    def jloss(p, b):
        return jbert.mlm_loss(p, jcfg, b["input_ids"], b["labels"], b["attention_mask"],
                              max_predictions=8)

    def tloss(m, b):
        return tbert.mlm_loss(m, tcfg, b["input_ids"], b["labels"], b["attention_mask"],
                              max_predictions=8)
    return jloss, tloss


def _batches(n):
    gen = jdata.synthetic_mlm_batches(TINY["vocab_size"], 4, 32, seed=3)
    out = []
    for i in range(n):
        b = next(gen)
        b["attention_mask"][i % 4, 20 + i:] = 0  # ragged rows
        out.append(b)
    return out


@pytest.fixture(scope="module")
def jax_run():
    """5 steps of the JAX Trainer on a 1-device mesh, and its start weights."""
    params = jbert.init(jax.random.PRNGKey(0), jbert.BertConfig(**TINY))
    start = jax.tree.map(np.asarray, params)
    jloss, _ = _loss_fns({})
    mesh = build_mesh(MeshConfig(data=1, fsdp=1, tensor=1), jax.devices()[:1])
    tr = JTrainer(jloss, params, mesh, jbert.SHARDING_RULES,
                  JTrainerConfig(learning_rate=1e-3, warmup_steps=2, total_steps=10))
    metrics = [tr.train_step(b) for b in _batches(STEPS)]
    return start, metrics, jax.tree.map(np.asarray, tr.params)


def _torch_run(start, **cfg):
    _, tloss = _loss_fns({})
    tr = Trainer(tloss, tbert.params_from_jax(start, "cpu"),
                 TrainerConfig(learning_rate=1e-3, warmup_steps=2, total_steps=10, **cfg),
                 device="cpu")
    return tr, [tr.train_step(b) for b in _batches(STEPS)]


def test_train_steps_match_jax_trainer(jax_run):
    start, jm, jfinal = jax_run
    tr, tm = _torch_run(start)
    for i, (a, b) in enumerate(zip(tm, jm)):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=STEP_RTOL, err_msg=f"step {i}")
        np.testing.assert_allclose(a["grad_norm"], b["grad_norm"], rtol=STEP_RTOL,
                                   err_msg=f"step {i}")
        assert a["step_time_s"] > 0
    assert tm[-1]["loss"] < tm[0]["loss"]
    sd = tr.model.state_dict()
    for g, leaves in jfinal.items():
        for n, want in leaves.items():
            np.testing.assert_allclose(sd[f"{g}.{n}"].numpy(), want, rtol=0,
                                       atol=PARAM_ATOL, err_msg=f"{g}.{n}")
    assert tr.step_num == STEPS and tr.opt_state["count"] == STEPS


def test_bf16_moments_are_stored_in_bf16_and_track_f32(jax_run):
    start, jm, _ = jax_run
    tr, tm = _torch_run(start, optimizer_dtype="bfloat16")
    for side in ("mu", "nu"):
        assert all(t.dtype == torch.bfloat16 for t in tr.opt_state[side].values())
    assert all(p.dtype == torch.float32 for p in tr.model.parameters())
    # bf16 moments keep 8 mantissa bits: m/sqrt(v) moves by ~2**-8 of a step
    for a, b in zip(tm, jm):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-3)


def test_sync_false_keeps_metrics_on_device_and_mfu():
    _, tloss = _loss_fns({})
    tr = Trainer(tloss, tbert.init(tbert.BertConfig(**TINY, dtype=torch.float32), "cpu"),
                 TrainerConfig(warmup_steps=1, total_steps=4), flops_per_batch=1e9,
                 device="cpu")
    b = _batches(2)
    m = tr.train_step(b[0], sync=False)
    assert isinstance(m["loss"], torch.Tensor) and "step_time_s" not in m
    assert tr.mfu(1e12) is None  # no synced step yet
    m = tr.train_step(b[1])
    assert m["tflops_per_s"] > 0
    assert tr.mfu(1e12) == pytest.approx(1e9 / m["step_time_s"] / 1e12)


def test_checkpoint_round_trip_and_max_to_keep(tmp_path):
    _, tloss = _loss_fns({})
    cfg = TrainerConfig(learning_rate=1e-3, warmup_steps=1, total_steps=10,
                        checkpoint_dir=str(tmp_path / "ckpt"), checkpoint_every=1)
    model = tbert.init(tbert.BertConfig(**TINY, dtype=torch.float32), "cpu", seed=0)
    t1 = Trainer(tloss, model, cfg, device="cpu")
    for b in _batches(5):
        t1.train_step(b)
    t1.finalize()
    assert CheckpointManager(cfg.checkpoint_dir).all_steps() == [3, 4, 5]
    assert not [n for n in os.listdir(cfg.checkpoint_dir) if n.startswith(".tmp")]

    t2 = Trainer(tloss, tbert.init(tbert.BertConfig(**TINY, dtype=torch.float32), "cpu", seed=9),
                 cfg, device="cpu")
    assert t2.restore_latest()
    assert t2.step_num == 5 and t2.opt_state["count"] == 5
    for (n, a), b in zip(t1.model.state_dict().items(), t2.model.state_dict().values()):
        assert torch.equal(a, b), n
    for side in ("mu", "nu"):
        for n, a in t1.opt_state[side].items():
            assert torch.equal(a, t2.opt_state[side][n]), n
    # both continue identically from the restored state
    nxt = _batches(6)[5]
    assert t1.train_step(nxt)["loss"] == t2.train_step(nxt)["loss"]


def test_checkpoint_manager_skips_saved_steps_and_restores_none(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    assert mgr.restore_latest({}) is None
    state = {"w": torch.arange(4.0), "count": 1}
    assert mgr.save(1, state)
    assert not mgr.save(1, {"w": torch.zeros(4), "count": 2})
    got = mgr.restore_latest({"w": torch.empty(4)})
    assert got["step"] == 1 and got["state"]["count"] == 1
    assert torch.equal(got["state"]["w"], torch.arange(4.0))


def test_worker_resumes_after_simulated_preemption(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO, TORCH_DEVICE="cpu",
               CHECKPOINT_DIR=str(tmp_path / "ckpt"), TRAIN_STEPS="4",
               CHECKPOINT_EVERY="2", FAIL_AT_STEP="3",
               FAIL_MARKER=str(tmp_path / "failed"))
    cmd = [sys.executable, "-m", "kubeflow_tpu_torch.examples.bert_worker"]
    first = subprocess.run(cmd, env=env, cwd=REPO, capture_output=True, text=True,
                           timeout=300)
    assert first.returncode == 137, first.stderr[-2000:]
    assert "resumed_from=0" in first.stdout and "step=3 loss=" in first.stdout
    assert "TRAIN-DONE" not in first.stdout
    second = subprocess.run(cmd, env=env, cwd=REPO, capture_output=True, text=True,
                            timeout=300)
    assert second.returncode == 0, second.stderr[-2000:]
    assert "resumed_from=2" in second.stdout
    assert "step=3 loss=" in second.stdout and "step=1 loss=" not in second.stdout
    assert "TRAIN-DONE step=4" in second.stdout


def test_checkpoint_async_write_error_surfaces_at_wait(tmp_path):
    """A background write that fails leaves no step behind and raises at
    the next wait(), once."""
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.save(1, {"w": torch.zeros(2), "f": lambda: 0})  # cannot pickle
    with pytest.raises((pickle.PicklingError, AttributeError)):
        mgr.wait()
    mgr.wait()
    assert os.listdir(tmp_path) == [] and mgr.latest_step() is None
