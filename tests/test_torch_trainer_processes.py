"""Port parity: the Trainer on a mesh across processes (train/trainer.py,
train/data.py, train/checkpoint.py over parallel/distributed.py), on the
CPU over ``gloo``.

A gang of 2 processes (and one of 4) trains the tiny BERT of tests/test_torch_trainer_mesh.py
on the JAX weights carried across (``params_from_jax``) and the same
batches:
- against the JAX ``Trainer`` on a one-process JAX mesh of 2 and of 4 CPU
  devices (fsdp 2; fsdp 2 x tensor 2; the gang has 1 and 2 positions a
  process, and 4 processes of one at fsdp 2 x tensor 2): per-step loss within 1e-2 absolute, gradient norm within
  1.22e-2 relative (tests/test_torch_trainer_mesh.py's bounds);
- in f32, against the port's one-process mesh of the same shape: within
  1e-5, parameters after the steps too.
Then the two batch rules (``global_batch``: the processes' rows in process
order; ``put_batch``: one global batch, equal on every process, or a
raise) and a checkpoint across the gang (process 0 alone writes; both
restore the same step).  The members run in
tests/test_torch_mesh_processes.py, which imports no JAX; each gang has a
timeout of its own."""

import jax
import numpy as np
import pytest

import test_torch_mesh_processes as G
from kubeflow_tpu.models import bert as jbert
from kubeflow_tpu.parallel import mesh as jmesh
from kubeflow_tpu.train.trainer import Trainer as JTrainer
from kubeflow_tpu.train.trainer import TrainerConfig as JTrainerConfig

LOSS_ATOL, NORM_RTOL = 1e-2, 1.22e-2
F32_TOL = 1e-5
STEPS = 3
# the gang's mesh, its positions per process and its processes (the last:
# a process per position, as a job with a card per process lays it)
MESHES = {"fsdp2": (dict(fsdp=2), 1, 2), "f2t2": (dict(fsdp=2, tensor=2), 2, 2),
          "f2t2_x4": (dict(fsdp=2, tensor=2), 1, 4)}


@pytest.fixture(scope="module")
def np_tree():
    return jax.tree.map(np.asarray, jbert.init(jax.random.PRNGKey(0),
                                               jbert.BertConfig(**G.TINY)))


def _jax_run(np_tree, sizes: dict) -> list:
    cfg = jbert.BertConfig(**G.TINY)

    def loss_fn(p, b):
        return jbert.mlm_loss(p, cfg, b["input_ids"], b["labels"], b["attention_mask"],
                              max_predictions=G.MAX_PRED)

    n = int(np.prod(list(sizes.values())))
    jm = jmesh.build_mesh(jmesh.MeshConfig(**sizes), jax.devices()[:n])
    jt = JTrainer(loss_fn, jax.tree.map(jax.numpy.asarray, np_tree), jm, jbert.SHARDING_RULES,
                  JTrainerConfig(learning_rate=1e-3, warmup_steps=1, total_steps=10))
    return [jt.train_step(b) for b in G.bert_batches(STEPS)]


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_gang_trainer_matches_jax(np_tree, mesh):
    sizes, local, world = MESHES[mesh]
    want = _jax_run(np_tree, sizes)
    gang = G.run_gang(G.trainer_member, np_tree, sizes, "bfloat16", STEPS, local=local,
                      world=world)
    for rank, got in gang.items():
        for i, w in enumerate(want):
            assert abs(got["loss"][i] - w["loss"]) <= LOSS_ATOL, (rank, got, want)
            assert abs(got["grad_norm"][i] - w["grad_norm"]) <= NORM_RTOL * abs(
                w["grad_norm"]), (rank, got, want)
    # every process reports the same global loss and norm
    assert all(g["loss"] == gang[0]["loss"] and g["grad_norm"] == gang[0]["grad_norm"]
               for g in gang.values())


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_gang_trainer_matches_the_one_process_mesh_in_f32(np_tree, mesh):
    sizes, local, world = MESHES[mesh]
    one = G.bert_steps(G.bert_trainer(np_tree, sizes, "float32", ["cpu"] * world * local),
                       STEPS)
    gang = G.run_gang(G.trainer_member, np_tree, sizes, "float32", STEPS, local=local,
                      world=world)
    for rank, got in gang.items():
        np.testing.assert_allclose(got["loss"], one["loss"], rtol=F32_TOL, atol=F32_TOL)
        np.testing.assert_allclose(got["grad_norm"], one["grad_norm"], rtol=F32_TOL)
        for name, want in one["params"].items():
            np.testing.assert_allclose(got["params"][name], want, rtol=F32_TOL, atol=F32_TOL,
                                       err_msg=name)
        # each process holds its own positions' slices, of the rule's shape
        for name, shapes in got["shapes"].items():
            mine = [s for p, s in enumerate(one["shapes"][name]) if p // local == rank]
            assert [s for s in shapes if s is not None] == mine, name
            assert sum(s is None for s in shapes) == (world - 1) * local, name
        assert got["label"] == (f"{world * local} mesh shards in {world} processes on 1 "
                                "device (cpu)")


def test_the_two_batch_rules(np_tree):
    gang = G.run_gang(G.batch_rules_member, np_tree, local=1)
    rows = np.arange(12, dtype=np.int32).reshape(4, 3)
    for rank, got in gang.items():
        # global_batch: the processes' local rows in process order
        assert got["shape"] == (8, 3)
        np.testing.assert_array_equal(got["global"], np.concatenate([rows, rows + 100]))
        np.testing.assert_array_equal(got["local"][rank], rows + 100 * rank)
        assert got["local"][1 - rank] is None
        # put_batch: one global batch, which must be equal on every process
        assert "not the same on each process" in got["unequal"], got["unequal"]
        # a step on the global batch and one on each process's rows of it
        assert got["global_step"] == got["local_step"]


def test_checkpoint_across_the_gang(np_tree, tmp_path):
    gang = G.run_gang(G.checkpoint_member, np_tree, str(tmp_path / "ckpt"))
    assert gang[0]["writes"] == [2, 3] and gang[1]["writes"] == []
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == ["2", "3"]
    for rank, got in gang.items():
        assert got["restored"] and got["step"] == 3 and got["count"] == 3
        for name, want in got["trained"].items():
            np.testing.assert_array_equal(got["params"][name], want, err_msg=name)
    for name in gang[0]["mu"]:
        np.testing.assert_array_equal(gang[0]["mu"][name], gang[1]["mu"][name])
