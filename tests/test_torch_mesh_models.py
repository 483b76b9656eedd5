"""Port parity: the mesh paths of the decoder, ResNet and MNIST
(models/{decoder,resnet,mnist}.py under ``with mesh:``, placed by each
model's ``SHARDING_RULES``) and the ``Trainer`` on a mesh over their dict
trees.

Each model starts from the JAX package's ``init`` on numpy, carried over by
its ``params_from_jax``, at a small size: the decoder's ``tiny()`` (4 query
and 2 KV heads, so ``f2t4`` splits ``wk`` / ``wv`` mid-head), ResNet at two
stages of width 8 (10 classes: ``tensor=4`` does not divide them) and the
MNIST CNN at narrow widths (30 hidden units: ``tensor=4`` does not divide
them).  Against the reference:

* every leaf's shard shape against the JAX ``NamedSharding.shard_shape`` at
  ``fsdp8``, ``d2f2t2`` and ``f2t4`` (and a vocabulary of 509, which no
  ``tensor`` divides), ResNet's conv kernels in the port's OIHW layout;
* the port's ``Trainer(mesh=, rules=)`` against the JAX ``Trainer`` on
  tests/conftest.py's 8 virtual CPU devices, at ``fsdp8`` and ``d2f2t2``:
  per-step loss within 1e-2 absolute and gradient norm within 1.22e-2
  relative (tests/test_torch_trainer_mesh.py's bounds);

and against the port on one device, in f32: the loss and every gradient at
all three meshes within 1e-4 relative, and the logits of ``forward``.
Last, the Trainer's dict trees: a checkpoint re-sharded on restore and
``global_params``.  tests/test_torch_decoder_mesh.py takes the decoder's
convert -> fine-tune -> serve loop."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import decoder as jdec
from kubeflow_tpu.models import mnist as jmnist
from kubeflow_tpu.models import resnet as jresnet
from kubeflow_tpu.parallel import mesh as jmesh
from kubeflow_tpu.parallel import sharding as jsharding
from kubeflow_tpu.train.trainer import Trainer as JTrainer
from kubeflow_tpu.train.trainer import TrainerConfig as JTrainerConfig
from kubeflow_tpu_torch.models import decoder as tdec
from kubeflow_tpu_torch.models import mnist as tmnist
from kubeflow_tpu_torch.models import resnet as tresnet
from kubeflow_tpu_torch.models._tree import named_leaves
from kubeflow_tpu_torch.parallel import mesh as tmesh
from kubeflow_tpu_torch.parallel.sharding import ShardedTensor, shard_params
from kubeflow_tpu_torch.train.trainer import Trainer, TrainerConfig

LOSS_ATOL, NORM_RTOL = 1e-2, 1.22e-2
# f32 on a mesh against one device: the same graph summed in another order
F32_RTOL, F32_ATOL = 1e-4, 1e-6
STEPS = 3
MESHES = {"fsdp8": dict(data=1, fsdp=8, tensor=1),
          "d2f2t2": dict(data=2, fsdp=2, tensor=2),
          "f2t4": dict(data=1, fsdp=2, tensor=4)}
SEQ = 12
RESNET = dict(stages=(1, 1), width=8, num_classes=10, groups=4)
MNIST = dict(conv1_features=8, conv2_features=8, dense_features=30)
DT = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@dataclasses.dataclass
class Case:
    """One model: its JAX and port modules, configs, loss and batches."""
    name: str
    jmod: object
    tmod: object
    vocab: int = 512

    def configs(self, dtype: str):
        jd, td = DT[dtype]
        if self.name == "decoder":
            return jdec.tiny(self.vocab), tdec.tiny(self.vocab)
        if self.name == "resnet":
            return (jresnet.ResNetConfig(**RESNET, dtype=jd),
                    tresnet.ResNetConfig(**RESNET, dtype=td))
        return jmnist.MnistConfig(**MNIST, dtype=jd), tmnist.MnistConfig(**MNIST, dtype=td)

    def jax_params(self, dtype: str):
        jc, _ = self.configs(dtype)
        key = jax.random.PRNGKey(0)
        if self.name == "decoder":
            return jdec.init(key, jc, dtype=DT[dtype][0])
        return self.jmod.init(key, jc)

    def port_params(self, jp):
        return self.tmod.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")

    def batches(self, n: int, batch: int = 8, seed: int = 3) -> list:
        rng = np.random.default_rng(seed)
        if self.name == "decoder":
            return [{"tokens": rng.integers(0, self.vocab, (batch, SEQ)).astype(np.int32)}
                    for _ in range(n)]
        size, classes = (16, RESNET["num_classes"]) if self.name == "resnet" else (28, 10)
        ch = 3 if self.name == "resnet" else 1
        return [{"images": rng.standard_normal((batch, size, size, ch), dtype=np.float32),
                 "labels": rng.integers(0, classes, batch).astype(np.int32)}
                for _ in range(n)]

    def loss(self, mod, config):
        if self.name == "decoder":
            return lambda p, b: mod.lm_loss(p, config, b["tokens"])
        return lambda p, b: mod.loss(p, config, b["images"], b["labels"])


CASES = {"decoder": Case("decoder", jdec, tdec), "resnet": Case("resnet", jresnet, tresnet),
         "mnist": Case("mnist", jmnist, tmnist)}
# a vocabulary that neither tensor=2 nor tensor=4 divides: replicated there
ODD_VOCAB = Case("decoder", jdec, tdec, vocab=509)


def _torch_batch(b: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _tmesh(sizes):
    return tmesh.build_mesh(tmesh.MeshConfig(**sizes), ["cpu"] * 8)


def _jax_layout(case: Case, shape: tuple) -> tuple:
    """A JAX leaf's shape in the port's layout (the HWIO conv kernels of
    ResNet and MNIST are OIHW in the port)."""
    if case.name != "decoder" and len(shape) == 4:
        return tuple(shape[i] for i in (3, 2, 0, 1))
    return tuple(shape)


@pytest.mark.parametrize("name", sorted(CASES))
def test_rules_are_the_jax_rules(name):
    """The patterns and specs of the JAX rules; ResNet's conv spec laid out
    as its kernels (the HWIO output-channel dim is OIHW's dim 0)."""
    jr, tr = CASES[name].jmod.SHARDING_RULES, CASES[name].tmod.SHARDING_RULES
    assert [p for p, _ in tr] == [p for p, _ in jr]
    for (pat, js), (_, ts) in zip(jr, tr):
        want = tuple(js)
        if name == "resnet" and "conv" in pat:
            want = tuple(want[i] for i in (3, 2, 0, 1))
        assert tuple(ts) == want, pat


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("name", sorted(CASES) + ["decoder_v509"])
def test_every_leaf_holds_the_jax_shard_shape(name, mesh):
    case = ODD_VOCAB if name == "decoder_v509" else CASES[name]
    sizes = MESHES[mesh]
    jp = case.jax_params("bfloat16")
    jm = jmesh.build_mesh(jmesh.MeshConfig(**sizes), jax.devices()[:8])
    jsh = jsharding.tree_shardings(jp, jm, case.jmod.SHARDING_RULES)
    want = {".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path):
            _jax_layout(case, s.shard_shape(leaf.shape))
            for (path, s), leaf in zip(jax.tree_util.tree_flatten_with_path(jsh)[0],
                                       jax.tree.leaves(jp))}
    _, tc = case.configs("bfloat16")
    tr = Trainer(case.loss(case.tmod, tc), case.port_params(jp),
                 TrainerConfig(learning_rate=1e-3, warmup_steps=1, total_steps=10),
                 mesh=_tmesh(sizes), rules=case.tmod.SHARDING_RULES)
    assert sorted(tr.params) == sorted(want)
    split = set()
    for n, st in tr.params.items():
        assert [tuple(t.shape) for t in st.shards] == [want[n]] * 8, n
        for side in ("mu", "nu"):
            assert [tuple(t.shape) for t in tr.opt_state[side][n].shards] == [want[n]] * 8
        # each distinct slice once on the one device
        assert len(st.locals) == len({st.block(p) for p in range(8)})
        if want[n] != tuple(st.shape):
            split.add(n)
    assert split  # every mesh here splits some leaf
    if name == "decoder_v509" and sizes["tensor"] > 1:
        # the vocabulary does not divide: replicated on tensor, split on fsdp
        assert tr.params["embed"].split_axes(0) == ()
        assert tr.params["unembed"].split_axes(1) == ()


def _jax_trainer(case: Case, sizes, jp):
    jc, _ = case.configs("bfloat16")
    jm = jmesh.build_mesh(jmesh.MeshConfig(**sizes), jax.devices()[:8])
    return JTrainer(case.loss(case.jmod, jc), jp, jm, case.jmod.SHARDING_RULES,
                    JTrainerConfig(learning_rate=1e-3, warmup_steps=1, total_steps=10))


@pytest.mark.parametrize("mesh", ["fsdp8", "d2f2t2"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_mesh_trainer_matches_jax(name, mesh):
    case, sizes = CASES[name], MESHES[mesh]
    jp = case.jax_params("bfloat16")
    batches = case.batches(STEPS)
    jt = _jax_trainer(case, sizes, jp)
    want = [jt.train_step(b) for b in batches]
    _, tc = case.configs("bfloat16")
    tt = Trainer(case.loss(case.tmod, tc), case.port_params(jp),
                 TrainerConfig(learning_rate=1e-3, warmup_steps=1, total_steps=10),
                 mesh=_tmesh(sizes), rules=case.tmod.SHARDING_RULES)
    got = [tt.train_step(b) for b in batches]
    for g, w in zip(got, want):
        assert abs(g["loss"] - float(w["loss"])) <= LOSS_ATOL, (got, want)
        assert abs(g["grad_norm"] - float(w["grad_norm"])) <= NORM_RTOL * abs(
            float(w["grad_norm"])), (got, want)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("name", sorted(CASES) + ["decoder_v509"])
def test_f32_loss_and_every_gradient_match_one_device(name, mesh):
    """The mesh's loss and each parameter's gradient (gathered from the
    local slices) against the one-device port's, in f32."""
    case = ODD_VOCAB if name == "decoder_v509" else CASES[name]
    _, tc = case.configs("float32")
    model = case.port_params(case.jax_params("float32"))
    b = _torch_batch(case.batches(1)[0])
    leaves = named_leaves(model)
    for t in leaves.values():
        t.requires_grad_()
    loss = case.loss(case.tmod, tc)
    want = loss(model, b)
    want_grads = torch.autograd.grad(want, list(leaves.values()))
    m = _tmesh(MESHES[mesh])
    tree = shard_params(model, m, case.tmod.SHARDING_RULES)
    flat = named_leaves(tree)
    for st in flat.values():
        for t in st.locals:
            t.requires_grad_(True)
    with m:
        got = loss(tree, b)
    got.backward()
    torch.testing.assert_close(got.detach(), want.detach(), rtol=F32_RTOL, atol=F32_ATOL)
    for (n, st), g in zip(flat.items(), want_grads):
        grad = st.like([torch.zeros_like(t) if t.grad is None else t.grad
                        for t in st.shards]).gather()
        torch.testing.assert_close(grad, g, rtol=F32_RTOL, atol=F32_ATOL,
                                   msg=lambda m_: f"{name} {mesh} {n}: {m_}")


@pytest.mark.parametrize("mesh", ["d2f2t2", "f2t4"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_forward_on_a_mesh_matches_one_device(name, mesh):
    """``forward`` (the decoder's ``forward_full``) under ``with mesh:``
    gives a ShardedTensor split over the batch, and over ``tensor`` on the
    classes where the rules split them; gathered, the one-device logits."""
    case = CASES[name]
    _, tc = case.configs("float32")
    model = case.port_params(case.jax_params("float32"))
    b = _torch_batch(case.batches(1)[0])
    m = _tmesh(MESHES[mesh])

    def fwd():
        if name == "decoder":
            return tdec.forward_full(model, tc, b["tokens"])
        return case.tmod.forward(model, tc, b["images"])

    with torch.no_grad():
        want = fwd()
        with m:
            got = fwd()
    assert isinstance(got, ShardedTensor) and tuple(got.shape) == tuple(want.shape)
    assert tuple(got.spec)[0] == ("data", "fsdp")
    torch.testing.assert_close(got.gather(), want, rtol=1e-5, atol=1e-5)


def test_mnist_accuracy_on_a_mesh_is_the_global_mean():
    case = CASES["mnist"]
    _, tc = case.configs("float32")
    model = case.port_params(case.jax_params("float32"))
    b = _torch_batch(case.batches(1, batch=8)[0])
    want = tmnist.accuracy(model, tc, b["images"], b["labels"])
    with _tmesh(MESHES["d2f2t2"]):
        got = tmnist.accuracy(model, tc, b["images"], b["labels"])
    assert float(got) == float(want)


def test_decoder_loss_is_the_global_mean_not_the_shards_mean():
    """Four batch shards of 2 rows: the psum of the token sums over the psum
    of the counts is the one-device mean; a double-counted partial (the
    fault a plain leaf read as replicated makes) would not be."""
    case = CASES["decoder"]
    _, tc = case.configs("float32")
    model = case.port_params(case.jax_params("float32"))
    toks = torch.from_numpy(case.batches(1)[0]["tokens"])
    want = float(tdec.lm_loss(model, tc, toks))
    for sizes in (dict(data=2, fsdp=2, tensor=2), dict(fsdp=4, tensor=2)):
        mesh = tmesh.build_mesh(tmesh.MeshConfig(**sizes), ["cpu"] * 8)
        with torch.no_grad(), mesh:
            assert abs(float(tdec.lm_loss(model, tc, toks)) - want) <= 1e-6


def test_dict_tree_checkpoint_reshards_and_global_params(tmp_path):
    """ResNet's dict tree (with its ``blocks`` list) on ``d2f2t2``: the
    checkpoint restores on another mesh and on one device, and
    ``global_params`` hands back the tree of global tensors."""
    case = CASES["resnet"]
    _, tc = case.configs("bfloat16")
    jp = case.jax_params("bfloat16")
    cfg = TrainerConfig(learning_rate=1e-3, warmup_steps=1, total_steps=10,
                        checkpoint_dir=str(tmp_path / "ckpt"), checkpoint_every=2)
    batches = case.batches(3, seed=5)

    def trainer(sizes):
        if sizes is None:
            return Trainer(case.loss(tresnet, tc), case.port_params(jp), cfg, device="cpu")
        return Trainer(case.loss(tresnet, tc), case.port_params(jp), cfg,
                       mesh=_tmesh(sizes), rules=tresnet.SHARDING_RULES)

    t1 = trainer(MESHES["d2f2t2"])
    for b in batches[:2]:
        t1.train_step(b)
    t1.finalize()
    tree = t1.global_params()
    assert isinstance(tree["blocks"], list) and len(tree["blocks"]) == 2
    saved = named_leaves(tree)
    assert all(isinstance(t, torch.Tensor) and not t.requires_grad for t in saved.values())
    for sizes in (MESHES["f2t4"], None):
        t2 = trainer(sizes)
        assert t2.restore_latest() and t2.step_num == 2
        for n, t in named_leaves(t2.global_params()).items():
            assert torch.equal(t, saved[n]), n
    one = trainer(None)
    assert one.restore_latest()
    assert one.mfu_label == "1 device (cpu)"
    assert t1.mfu_label == "8 mesh shards on 1 device (cpu)"
    # both continue alike from the restored state
    again = trainer(MESHES["d2f2t2"])
    again.restore_latest()
    assert again.train_step(batches[2])["loss"] == t1.train_step(batches[2])["loss"]
