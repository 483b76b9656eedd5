"""Port parity: GPipe on a mesh across processes (parallel/pipeline.py over
the one-sided ``ppermute`` of ops/shard_map_compat.py) and BERT's pp Trainer
as a gang (models/bert.py, train/trainer.py, train/checkpoint.py), on the
CPU over ``gloo``.

- The toy layer of tests/test_torch_gpipe.py under ``gpipe`` (4
  microbatches) on stages 2 x fsdp 2 over 2 processes of 2 positions (each
  process one stage: every hand-off crosses, the first and the last one
  way) and over 4 processes of one, and on data 2 x stages 2 over 2 x 2
  (the hand-offs inside a process, the data axis across), with and without
  remat: against the JAX ``gpipe`` under this file's own ``jax.jit``
  (outputs within 1e-5, gradients within 1e-4 relative) and against the
  port's one-process ``gpipe`` in f32 (within 1e-6).
- BERT at tests/test_torch_gpipe.py's ``PP_BASE`` widths under GPipe on
  stages 2 x fsdp 2, 2 processes x 2, 3 steps: against the JAX ``Trainer``
  with ``pipeline_stages=2`` on a one-process JAX mesh of the same shape
  (per-step loss within 1e-2 absolute, gradient norm within 1.22e-2
  relative, tests/test_torch_trainer_processes.py's bounds); in f32 against
  the port's one-process pp mesh (losses, norms and parameters within
  1e-5), each process holding only its stage's slices; an attention mask
  refused with the JAX text; a checkpoint the gang writes restored on both
  members, on the one-process pp mesh and on one device.

The members run in tests/test_torch_mesh_processes.py, which imports no
JAX; every gang has a timeout of its own (``GANG_TIMEOUT_S``) and shares
its result through a module-scoped fixture."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

import test_torch_mesh_processes as G
from kubeflow_tpu.models import bert as jbert
from kubeflow_tpu.parallel import mesh as jmesh
from kubeflow_tpu.parallel import pipeline as jpipe
from kubeflow_tpu.train.trainer import Trainer as JTrainer
from kubeflow_tpu.train.trainer import TrainerConfig as JTrainerConfig
from kubeflow_tpu_torch.models import bert as tbert
from kubeflow_tpu_torch.parallel.mesh import MeshConfig, build_mesh
from kubeflow_tpu_torch.train.trainer import Trainer, TrainerConfig

OUT_TOL, GRAD_RTOL, F32_TOL = 1e-5, 1e-4, 1e-6
LOSS_ATOL, NORM_RTOL, PP_F32_TOL = 1e-2, 1.22e-2, 1e-5
STEPS, MICROBATCHES = 3, 4
GANG_TIMEOUT_S = 180
# name: (mesh sizes, positions a process, processes)
LAYOUTS = {"stages2_fsdp2_2x2": (dict(stages=2, fsdp=2), 2, 2),
           "stages2_fsdp2_4x1": (dict(stages=2, fsdp=2), 1, 4),
           "data2_stages2_2x2": (dict(data=2, stages=2, fsdp=1), 2, 2)}
PP_LOCAL, PP_WORLD = 2, 2


def _rel(got, want) -> float:
    return float(np.linalg.norm(np.asarray(got) - np.asarray(want))
                 / max(np.linalg.norm(np.asarray(want)), 1e-30))


# ------------------------------------------------------------------ toy layer


@pytest.fixture(scope="module")
def jax_toy():
    """Per layout: JAX gpipe's output and gradients of sum(out**2) at the
    weights (unstacked) and the input, on a JAX mesh of that shape."""
    params, x = G.toy_np()
    out = {}
    for name, (sizes, _, _) in LAYOUTS.items():
        mesh = jmesh.build_mesh(jmesh.MeshConfig(**sizes), jax.devices()[:4])

        def stage_fn(lp, xmb):
            y, _ = jax.lax.scan(lambda c, l: (jnp.tanh(c @ l["w"] + l["b"]), None), xmb, lp)
            return y

        def loss(sp, xx):
            y = jpipe.gpipe(stage_fn, sp, xx, MICROBATCHES, mb_spec=JP(("data", "fsdp")))
            return jnp.sum(y ** 2), y

        with jax.set_mesh(mesh):
            (_, y), (g, gx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
                jpipe.stack_stages(jax.tree.map(jnp.asarray, params), 2), jnp.asarray(x))
        out[name] = (np.asarray(y), jax.tree.map(np.asarray, jpipe.unstack_stages(g)),
                     np.asarray(gx))
    return out


@pytest.fixture(scope="module")
def toy_gangs():
    return {(name, remat): G.run_gang(G.toy_gpipe_member, sizes, MICROBATCHES, remat,
                                      world=world, local=local, timeout=GANG_TIMEOUT_S)
            for name, (sizes, local, world) in LAYOUTS.items() for remat in (False, True)}


def _global_grads(grads: dict) -> dict:
    """Each weight's global gradient from ``{(name, block): grad}`` (the
    replicas' shares summed): its stage blocks in order."""
    out = {}
    for k in ("w", "b"):
        blocks = sorted(b for (n, b) in grads if n == k)
        out[k] = np.concatenate([grads[(k, b)] for b in blocks])
    return out


@pytest.mark.parametrize("remat", [False, True], ids=["no_remat", "remat"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_gpipe_across_processes_matches_jax_and_one_process(jax_toy, toy_gangs, layout, remat):
    sizes, local, world = LAYOUTS[layout]
    gang = toy_gangs[(layout, remat)]
    want_y, want_g, want_gx = jax_toy[layout]
    one = G.toy_gpipe(build_mesh(MeshConfig(**sizes), ["cpu"] * 4), 2, MICROBATCHES, remat)
    grads = _global_grads(G._summed_shares([g["grads"] for g in gang.values()]))
    one_grads = _global_grads(one["grads"])
    gx = sum(g["x_grad"] for g in gang.values())  # each process's share
    for rank, got in gang.items():
        np.testing.assert_allclose(got["y"], want_y, rtol=OUT_TOL, atol=OUT_TOL)
        np.testing.assert_allclose(got["y"], one["y"], rtol=F32_TOL, atol=F32_TOL)
        # each position holds its stage's 2 of the 4 layers
        assert got["layers_held"] == [2], got["layers_held"]
        assert got["stats"]["calls"] > 0, got["stats"]  # something crossed processes
    for k in ("w", "b"):
        assert _rel(grads[k], want_g[k]) <= GRAD_RTOL, k
        np.testing.assert_allclose(grads[k], one_grads[k], rtol=F32_TOL, atol=F32_TOL, err_msg=k)
    assert _rel(gx, want_gx) <= GRAD_RTOL
    np.testing.assert_allclose(gx, one["x_grad"], rtol=F32_TOL, atol=F32_TOL)


# ------------------------------------------------------------------ BERT pp


@pytest.fixture(scope="module")
def np_tree():
    return jax.tree.map(np.asarray, jbert.init(jax.random.PRNGKey(0),
                                               jbert.BertConfig(**G.PP_BASE)))


@pytest.fixture(scope="module")
def jax_pp(np_tree):
    cfg = jbert.BertConfig(**G.PP_BASE, pipeline_stages=2, pipeline_microbatches=MICROBATCHES)

    def loss_fn(p, b):
        return jbert.mlm_loss(p, cfg, b["input_ids"], b["labels"], max_predictions=G.MAX_PRED)

    jm = jmesh.build_mesh(jmesh.MeshConfig(**G.PP_SIZES), jax.devices()[:4])
    jt = JTrainer(loss_fn, jax.tree.map(jnp.asarray, np_tree), jm, jbert.pp_sharding_rules(),
                  JTrainerConfig(learning_rate=1e-3, warmup_steps=1, total_steps=10))
    with jax.set_mesh(jm):  # the pp schedule's sharding constraints name the mesh
        return [jt.train_step(b) for b in G.pp_batches(STEPS)]


@pytest.fixture(scope="module")
def pp_gangs(np_tree):
    return {dtype: G.run_gang(G.pp_trainer_member, np_tree, dtype, STEPS, world=PP_WORLD,
                              local=PP_LOCAL, timeout=GANG_TIMEOUT_S)
            for dtype in ("bfloat16", "float32")}


def test_pp_gang_matches_the_jax_pp_trainer(jax_pp, pp_gangs):
    gang = pp_gangs["bfloat16"]
    for rank, got in gang.items():
        for i, w in enumerate(jax_pp):
            assert abs(got["loss"][i] - w["loss"]) <= LOSS_ATOL, (rank, got["loss"], w)
            assert abs(got["grad_norm"][i] - w["grad_norm"]) <= NORM_RTOL * abs(
                w["grad_norm"]), (rank, got["grad_norm"], w)
    # every process reports the same global loss and norm
    assert all(g["loss"] == gang[0]["loss"] and g["grad_norm"] == gang[0]["grad_norm"]
               for g in gang.values())


def test_pp_gang_matches_the_one_process_mesh_in_f32(np_tree, pp_gangs):
    one = G.pp_steps(G.pp_trainer(np_tree, "float32", ["cpu"] * PP_WORLD * PP_LOCAL), STEPS)
    for rank, got in pp_gangs["float32"].items():
        np.testing.assert_allclose(got["loss"], one["loss"], rtol=PP_F32_TOL, atol=PP_F32_TOL)
        np.testing.assert_allclose(got["grad_norm"], one["grad_norm"], rtol=PP_F32_TOL)
        for name, want in one["params"].items():
            np.testing.assert_allclose(got["params"][name], want, rtol=PP_F32_TOL,
                                       atol=PP_F32_TOL, err_msg=name)
        # each process holds its own positions' slices, of the rule's shape:
        # a leaf the rules split over ``stages`` its stage's 2 of the 4 layers
        for name, shapes in got["shapes"].items():
            mine = [s for p, s in enumerate(one["shapes"][name]) if p // PP_LOCAL == rank]
            assert [s for s in shapes if s is not None] == mine, name
            assert sum(s is None for s in shapes) == (PP_WORLD - 1) * PP_LOCAL, name
        assert got["staged"] and set(got["staged"].values()) == {G.PP_BASE["num_layers"] // 2}
        assert got["label"] == "4 mesh shards in 2 processes on 1 device (cpu)"


def test_pp_gang_refuses_an_attention_mask_with_the_jax_text(np_tree, pp_gangs):
    ids = np.zeros((8, 16), np.int32)
    jcfg = jbert.BertConfig(**G.PP_BASE, pipeline_stages=2)
    with pytest.raises(ValueError) as want:
        jbert.mlm_loss(jax.tree.map(jnp.asarray, np_tree), jcfg, ids, ids, np.ones_like(ids))
    for got in pp_gangs["float32"].values():
        assert got["mask"] == str(want.value)


def test_pp_gang_checkpoint_restores_on_both_members_and_one_process(np_tree, tmp_path):
    directory = str(tmp_path / "ckpt")
    gang = G.run_gang(G.pp_checkpoint_member, np_tree, directory, world=PP_WORLD,
                      local=PP_LOCAL, timeout=GANG_TIMEOUT_S)
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == ["2", "3"]
    for got in gang.values():
        assert got["restored"] and got["step"] == 3
        for name, want in got["trained"].items():
            np.testing.assert_array_equal(got["params"][name], want, err_msg=name)
    # the one-process pp mesh and a one-device trainer restore the same step
    mesh_one = G.pp_trainer(np_tree, "float32", ["cpu"] * PP_WORLD * PP_LOCAL,
                            checkpoint_dir=directory)
    assert mesh_one.restore_latest() and mesh_one.step_num == 3
    base = tbert.BertConfig(**G.PP_BASE, dtype=torch.float32)
    one = Trainer(lambda m, b: tbert.mlm_loss(m, base, b["input_ids"], b["labels"]),
                  tbert.init(base, "cpu", seed=1), TrainerConfig(checkpoint_dir=directory),
                  device="cpu")
    assert one.restore_latest() and one.step_num == 3
    for name, want in gang[0]["trained"].items():
        np.testing.assert_array_equal(mesh_one.params[name].gather().detach().numpy(), want)
        np.testing.assert_array_equal(one.params[name].detach().numpy(), want, err_msg=name)
