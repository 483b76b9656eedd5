"""Port parity: pipeline parallelism (parallel/pipeline.py) and BERT under
``pipeline_stages > 1`` (models/bert.py, train/trainer.py).

The port's ``gpipe`` runs the toy layer of tests/test_pipeline.py against
the JAX ``gpipe`` (its own ``jax.jit`` on tests/conftest.py's 8 virtual CPU
devices; the port on ``["cpu"] * 8``): outputs within 1e-5, gradients within
1e-4 relative.  BERT under GPipe on stages 2 × fsdp 2 × data 2 at the JAX
slow test's sizes in f32: the loss within 1e-4 of the JAX pp loss, every
leaf's gradient within 1e-4 relative (norm of the difference over the norm
of the JAX gradient).  Each JAX reference is computed once per module."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from kubeflow_tpu.models import bert as jbert
from kubeflow_tpu.parallel import mesh as jmesh
from kubeflow_tpu.parallel import pipeline as jpipe
from kubeflow_tpu.parallel.sharding import shard_params as jshard_params
from kubeflow_tpu_torch.models import bert as tbert
from kubeflow_tpu_torch.ops.shard_map_compat import each
from kubeflow_tpu_torch.parallel import pipeline as tpipe
from kubeflow_tpu_torch.parallel.mesh import MeshConfig, build_mesh, current_mesh
from kubeflow_tpu_torch.parallel.sharding import P, ShardedTensor, Views, shard_params
from kubeflow_tpu_torch.train.trainer import Trainer, TrainerConfig

SCHEDULES = [(2, 4), (4, 2), (2, 8)]
OUT_TOL, GRAD_RTOL = 1e-5, 1e-4
PP_BASE = dict(vocab_size=256, hidden_size=32, num_layers=4, num_heads=4,
               intermediate_size=64, max_position=32)
PP_MESH = dict(stages=2, fsdp=2, data=2)


def _rel(got, want) -> float:
    return float(np.linalg.norm(np.asarray(got) - np.asarray(want))
                 / max(np.linalg.norm(np.asarray(want)), 1e-30))


# ------------------------------------------------------------------ toy layer


def _toy_np(n_layers=4, d=16):
    rng = np.random.default_rng(0)
    return ({"w": (rng.standard_normal((n_layers, d, d)) * 0.3).astype(np.float32),
             "b": (rng.standard_normal((n_layers, d)) * 0.1).astype(np.float32)},
            rng.standard_normal((8, d)).astype(np.float32))


@pytest.fixture(scope="module")
def jax_toy():
    """JAX gpipe's output and gradients (of sum(out**2)) per schedule."""
    params, x = _toy_np()
    out = {}
    for stages, m in SCHEDULES:
        mesh = jmesh.build_mesh(jmesh.MeshConfig(stages=stages, fsdp=8 // stages),
                                jax.devices()[:8])

        def stage_fn(lp, xmb):
            y, _ = jax.lax.scan(lambda c, l: (jnp.tanh(c @ l["w"] + l["b"]), None), xmb, lp)
            return y

        def loss(sp, xx, m=m):
            y = jpipe.gpipe(stage_fn, sp, xx, m, mb_spec=JP(("data", "fsdp")))
            return jnp.sum(y ** 2), y

        with jax.set_mesh(mesh):
            (_, y), (g, gx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
                jpipe.stack_stages(jax.tree.map(jnp.asarray, params), stages), jnp.asarray(x))
        out[(stages, m)] = (np.asarray(y), jax.tree.map(np.asarray, jpipe.unstack_stages(g)),
                            np.asarray(gx))
    return out


def _toy_stage(lp, xmb):
    mesh = current_mesh()
    if mesh is None:
        for i in range(lp["w"].shape[0]):
            xmb = torch.tanh(xmb @ lp["w"][i] + lp["b"][i])
        return xmb
    views = Views(mesh)
    xs = xmb.shards
    for i in range(lp["w"].shape[0]):
        xs = each(lambda x, w, b: torch.tanh(x @ w + b), xs, views(lp["w"], (), i),
                  views(lp["b"], (), i))
    return xmb.like(xs)


@pytest.mark.parametrize("on_mesh", [True, False], ids=["mesh", "one_device"])
@pytest.mark.parametrize("stages,m", SCHEDULES)
def test_gpipe_matches_jax(jax_toy, stages, m, on_mesh):
    params, x = _toy_np()
    want_y, want_g, want_gx = jax_toy[(stages, m)]
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in params.items()}
    tx = torch.from_numpy(x).requires_grad_()
    if on_mesh:
        mesh = build_mesh(MeshConfig(stages=stages, fsdp=8 // stages), ["cpu"] * 8)
        placed = shard_params(tp, mesh, [(r"^w$", P("stages", None, None)),
                                         (r"^b$", P("stages", None))])
        leaves = [t for st in placed.values() for t in st.locals]
        for t in leaves:
            t.requires_grad_(True)
        with mesh:
            y = tpipe.gpipe(_toy_stage, tpipe.stack_stages(placed, stages), tx, m,
                            mb_spec=P(("data", "fsdp")))
        assert isinstance(y, ShardedTensor) and y.mesh is mesh
        y = y.gather()
        (y ** 2).sum().backward()
        grads = {k: st.like([t.grad for t in st.shards]).gather() for k, st in placed.items()}
        # each stage's layers live on its positions only
        for st in placed.values():
            assert {tuple(t.shape)[0] for t in st.locals} == {4 // stages}
    else:
        y = tpipe.gpipe(_toy_stage, tpipe.stack_stages(tp, stages), tx, m)
        (y ** 2).sum().backward()
        grads = {k: t.grad for k, t in tp.items()}
    np.testing.assert_allclose(y.detach().numpy(), want_y, rtol=OUT_TOL, atol=OUT_TOL)
    for k in ("w", "b"):
        assert _rel(grads[k].numpy(), want_g[k]) <= GRAD_RTOL, k
    assert _rel(tx.grad.numpy(), want_gx) <= GRAD_RTOL


@pytest.mark.parametrize("remat", [True, False])
def test_gpipe_remat_gives_the_same_numbers(remat):
    params, x = _toy_np()
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in params.items()}
    y = tpipe.gpipe(_toy_stage, tpipe.stack_stages(tp, 2), torch.from_numpy(x), 4, remat=remat)
    g = torch.autograd.grad((y ** 2).sum(), [tp["w"], tp["b"]])
    ref = torch.from_numpy(x)
    for i in range(4):
        ref = torch.tanh(ref @ tp["w"][i] + tp["b"][i])
    g_ref = torch.autograd.grad((ref ** 2).sum(), [tp["w"], tp["b"]])
    torch.testing.assert_close(y, ref, rtol=OUT_TOL, atol=OUT_TOL)
    for a, b in zip(g, g_ref):
        torch.testing.assert_close(a, b, rtol=GRAD_RTOL, atol=GRAD_RTOL)


def test_stack_unstack_roundtrip():
    params, _ = _toy_np(n_layers=6)
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    staged = tpipe.stack_stages(tp, 3)
    assert staged["w"].shape == (3, 2, 16, 16)
    assert torch.equal(tpipe.unstack_stages(staged)["w"], tp["w"])
    assert tpipe.num_stages(staged) == 3
    # the sharded leaf: slices kept, the stage dim on `stages`
    mesh = build_mesh(MeshConfig(stages=3, fsdp=2), ["cpu"] * 6)
    placed = shard_params(tp, mesh, [(r"^w$", P("stages", None, "fsdp")), (r".*", P())])
    st = tpipe.stack_stages(placed, 3)["w"]
    assert tuple(st.spec) == ("stages", None, None, "fsdp") and st.shape == (3, 2, 16, 16)
    assert all(a.data_ptr() == b.data_ptr() for a, b in zip(st.shards, placed["w"].shards))
    assert torch.equal(st.gather(), tp["w"].reshape(3, 2, 16, 16))
    back = tpipe.unstack_stages(tpipe.stack_stages(placed, 3))
    for k in ("w", "b"):
        assert torch.equal(back[k].gather(), tp[k])
        assert tuple(back[k].spec) == tuple(placed[k].spec) + (None,) * (
            back[k].ndim - len(placed[k].spec))


def test_errors_match_jax():
    params, x = _toy_np(n_layers=6)
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    for stages in (4, 5):
        with pytest.raises(ValueError) as want:
            jpipe.stack_stages(jax.tree.map(jnp.asarray, params), stages)
        with pytest.raises(ValueError, match="layers not divisible") as got:
            tpipe.stack_stages(tp, stages)
        assert str(got.value) == str(want.value)
    staged = tpipe.stack_stages(tp, 2)
    with pytest.raises(ValueError) as want:
        jpipe.gpipe(lambda lp, xm: xm, jpipe.stack_stages(jax.tree.map(jnp.asarray, params), 2),
                    jnp.asarray(x), 3)
    with pytest.raises(ValueError, match="microbatches") as got:
        tpipe.gpipe(_toy_stage, staged, torch.from_numpy(x), 3)
    assert str(got.value) == str(want.value)


def test_gpipe_refuses_a_mesh_of_other_stages():
    params, x = _toy_np()
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    mesh = build_mesh(MeshConfig(stages=2, fsdp=2), ["cpu"] * 4)
    with mesh, pytest.raises(ValueError, match="4 pipeline stages on a mesh of stages=2"):
        tpipe.gpipe(_toy_stage, tpipe.stack_stages(tp, 4), torch.from_numpy(x), 2)


def test_gpipe_skips_bubble_ticks():
    """Each stage runs each microbatch once: M·S stage calls, no bubble
    tick computed."""
    params, x = _toy_np()
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    calls = []

    def stage(lp, xm):
        calls.append(xm.shape[0])
        return _toy_stage(lp, xm)

    tpipe.gpipe(stage, tpipe.stack_stages(tp, 4), torch.from_numpy(x), 2, remat=False)
    assert calls == [4] * 8


# ------------------------------------------------------------------ BERT pp


def _pp_batch():
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 256, (8, 16)).astype(np.int32)
    return ids, np.where(ids % 3 == 0, ids, -100).astype(np.int32)


@pytest.fixture(scope="module")
def jax_bert_pp():
    """The JAX pp loss and gradients on stages 2 × fsdp 2 × data 2, f32."""
    cfg_ref = jbert.BertConfig(**PP_BASE, dtype=jnp.float32)
    cfg_pp = jbert.BertConfig(**PP_BASE, dtype=jnp.float32, pipeline_stages=2,
                              pipeline_microbatches=4)
    params = jbert.init(jax.random.PRNGKey(0), cfg_ref)
    ids, labels = _pp_batch()
    mesh = jmesh.build_mesh(jmesh.MeshConfig(**PP_MESH), jax.devices()[:8])
    sharded = jshard_params(params, mesh, jbert.pp_sharding_rules())
    with jax.set_mesh(mesh):
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p, i, lab: jbert.mlm_loss(p, cfg_pp, i, lab)))(
            sharded, jnp.asarray(ids), jnp.asarray(labels))
    return (jax.tree.map(np.asarray, params), float(loss),
            jax.tree.map(np.asarray, grads))


def _pp_cfg(**kw):
    return tbert.BertConfig(**PP_BASE, dtype=torch.float32, pipeline_stages=2,
                            pipeline_microbatches=4, **kw)


def _mesh_loss_and_grads(model, cfg, sizes=PP_MESH, rules=None):
    """The loss on a mesh of ``sizes`` over ``["cpu"] * n`` and each leaf's
    global gradient (replicas on one device share one tensor, so their
    gradients are summed there)."""
    n = int(np.prod(list(sizes.values())))
    mesh = build_mesh(MeshConfig(**sizes), ["cpu"] * n)
    tree = shard_params(model, mesh, rules or tbert.pp_sharding_rules())
    for grp in tree.values():
        for st in grp.values():
            for t in st.locals:
                t.requires_grad_(True)
    ids, labels = _pp_batch()
    with mesh:
        loss = tbert.mlm_loss(tree, cfg, torch.from_numpy(ids), torch.from_numpy(labels))
    loss.backward()
    grads = {g: {k: st.like([t.grad for t in st.shards]).gather() for k, st in grp.items()}
             for g, grp in tree.items()}
    return float(loss.detach()), grads


def test_bert_pp_matches_jax_pp(jax_bert_pp):
    np_tree, want_loss, want_grads = jax_bert_pp
    model = tbert.params_from_jax(np_tree, "cpu")
    loss, grads = _mesh_loss_and_grads(model, _pp_cfg())
    assert abs(loss - want_loss) <= 1e-4, (loss, want_loss)
    for g, grp in want_grads.items():
        for k, w in grp.items():
            assert _rel(grads[g][k].numpy(), w) <= GRAD_RTOL, (g, k)


def test_bert_pp_on_one_device_matches_jax_pp(jax_bert_pp):
    """No mesh in context: the same schedule on one device."""
    np_tree, want_loss, want_grads = jax_bert_pp
    model = tbert.params_from_jax(np_tree, "cpu")
    ids, labels = _pp_batch()
    loss = tbert.mlm_loss(model, _pp_cfg(), torch.from_numpy(ids), torch.from_numpy(labels))
    loss.backward()
    assert abs(float(loss) - want_loss) <= 1e-4
    for name, p in model.named_parameters():
        g, k = name.split(".")
        assert _rel(p.grad.numpy(), want_grads[g][k]) <= GRAD_RTOL, name


@pytest.mark.parametrize("on_mesh", [True, False], ids=["mesh", "one_device"])
def test_bert_pp_refuses_an_attention_mask_with_the_jax_text(jax_bert_pp, on_mesh):
    np_tree = jax_bert_pp[0]
    ids, labels = _pp_batch()
    mask = np.ones_like(ids)
    jcfg = jbert.BertConfig(**PP_BASE, dtype=jnp.float32, pipeline_stages=2)
    with pytest.raises(ValueError) as want:
        jbert.mlm_loss(jax.tree.map(jnp.asarray, np_tree), jcfg, ids, labels, mask)
    model = tbert.params_from_jax(np_tree, "cpu")
    args = (torch.from_numpy(ids), torch.from_numpy(labels), torch.from_numpy(mask))
    with pytest.raises(ValueError, match="requires attention_mask=None") as got:
        if on_mesh:
            with build_mesh(MeshConfig(**PP_MESH), ["cpu"] * 8):
                tbert.mlm_loss(model, _pp_cfg(), *args)
        else:
            tbert.mlm_loss(model, _pp_cfg(), *args)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("remat", [False, True], ids=["no_remat", "remat"])
def test_bert_pp_with_flash_matches_unsharded_flash(jax_bert_pp, remat):
    """pp on the mesh with the flash op (its plain version on the CPU)
    against the port's unsharded flash BERT, loss and every gradient."""
    model = tbert.params_from_jax(jax_bert_pp[0], "cpu")
    ids, labels = _pp_batch()
    ref_cfg = tbert.BertConfig(**PP_BASE, dtype=torch.float32, attention="flash")
    ref = tbert.mlm_loss(model, ref_cfg, torch.from_numpy(ids), torch.from_numpy(labels))
    ref_grads = dict(zip([n for n, _ in model.named_parameters()],
                         torch.autograd.grad(ref, list(model.parameters()))))
    loss, grads = _mesh_loss_and_grads(model, _pp_cfg(attention="flash", remat=remat))
    assert abs(loss - float(ref)) <= 1e-5
    for name, w in ref_grads.items():
        g, k = name.split(".")
        assert _rel(grads[g][k].numpy(), w.numpy()) <= GRAD_RTOL, name


def test_bert_pp_stage_layers_run_on_their_stage():
    """A pp BERT's layer leaves: each stage's positions hold its L/S layers,
    and the loss under the pipeline rules is the unsharded loss."""
    cfg = _pp_cfg()
    model = tbert.init(tbert.BertConfig(**PP_BASE, dtype=torch.float32), "cpu", seed=0)
    mesh = build_mesh(MeshConfig(**PP_MESH), ["cpu"] * 8)
    tree = shard_params(model, mesh, tbert.pp_sharding_rules())
    for name, st in tree["layers"].items():
        if "stages" in tuple(st.spec):
            assert {t.shape[0] for t in st.locals} == {PP_BASE["num_layers"] // 2}, name
    ids, labels = _pp_batch()
    with mesh:
        got = tbert.mlm_loss(tree, cfg, torch.from_numpy(ids), torch.from_numpy(labels))
    want = tbert.mlm_loss(model, tbert.BertConfig(**PP_BASE, dtype=torch.float32),
                          torch.from_numpy(ids), torch.from_numpy(labels))
    assert abs(float(got) - float(want)) <= 1e-5


# ------------------------------------------------------------------ Trainer


def _trainers(steps=3):
    base = tbert.BertConfig(**PP_BASE, dtype=torch.float32)
    pp = _pp_cfg()

    def loss_fn(cfg):
        return lambda m, b: tbert.mlm_loss(m, cfg, b["input_ids"], b["labels"])

    config = TrainerConfig(learning_rate=1e-3, warmup_steps=1, total_steps=10)
    mesh = build_mesh(MeshConfig(**PP_MESH), ["cpu"] * 8)
    t_pp = Trainer(loss_fn(pp), tbert.init(base, "cpu", seed=0), config, mesh=mesh,
                   rules=tbert.pp_sharding_rules())
    t_one = Trainer(loss_fn(base), tbert.init(base, "cpu", seed=0), config, device="cpu")
    rng = np.random.default_rng(2)
    batches = []
    for _ in range(steps):
        ids = rng.integers(104, 256, (8, 16)).astype(np.int32)
        batches.append({"input_ids": ids,
                        "labels": np.where(rng.random((8, 16)) < 0.3, ids, -100).astype(np.int32)})
    return t_pp, t_one, batches


def test_trainer_pp_matches_one_device_and_holds_stage_slices():
    t_pp, t_one, batches = _trainers()
    got = [t_pp.train_step(b) for b in batches]
    want = [t_one.train_step(b) for b in batches]
    for g, w in zip(got, want):
        assert abs(g["loss"] - w["loss"]) <= 1e-5, (got, want)
        assert abs(g["grad_norm"] - w["grad_norm"]) <= 1e-5 * w["grad_norm"], (got, want)
    for name, st in t_pp.params.items():
        np.testing.assert_allclose(st.gather().detach().numpy(),
                                   t_one.params[name].detach().numpy(), atol=1e-5)
        shape = st.sharding.shard_shape(tuple(st.shape))
        for leaf in (st, t_pp.opt_state["mu"][name], t_pp.opt_state["nu"][name]):
            assert leaf.spec == st.spec
            assert [tuple(t.shape) for t in leaf.shards] == [shape] * t_pp.mesh.size
        if "stages" in tuple(st.spec):
            assert shape[0] == PP_BASE["num_layers"] // 2, name


def test_trainer_pp_checkpoint_restores_on_one_device(tmp_path):
    t_pp, _, batches = _trainers(steps=2)
    t_pp._ckpt = None
    from kubeflow_tpu_torch.train.checkpoint import CheckpointManager

    t_pp._ckpt = CheckpointManager(str(tmp_path))
    for b in batches:
        t_pp.train_step(b)
    t_pp.save()
    t_pp.finalize()
    base = tbert.BertConfig(**PP_BASE, dtype=torch.float32)
    one = Trainer(lambda m, b: tbert.mlm_loss(m, base, b["input_ids"], b["labels"]),
                  tbert.init(base, "cpu", seed=1),
                  TrainerConfig(checkpoint_dir=str(tmp_path)), device="cpu")
    assert one.restore_latest() and one.step_num == 2
    for name, st in t_pp.params.items():
        assert torch.equal(one.params[name].detach(), st.gather().detach()), name
