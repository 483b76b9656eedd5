"""Port parity: kubeflow_tpu_torch's ResNet (GroupNorm) against the JAX
package's.

The JAX package's ``resnet.init`` makes the weights; ``params_from_jax``
carries the tree (its ``blocks`` list, HWIO kernels as OIHW) into the port,
and the same numpy-seeded NHWC images go through both on the CPU, at a
small stage tuple and width with both strides: 32x32 images take the
stride-2 stem's (2, 3) padding, the max pool's (0, 1) and a stride-2 block's
(0, 1); 30x30 images a symmetric pool.  The optimizer is held to
``optax.sgd(0.1, momentum=0.9)`` over three steps on shared gradients."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kubeflow_tpu.models import resnet as jresnet
from kubeflow_tpu_torch.models import resnet as tresnet
from kubeflow_tpu_torch.models._tree import named_leaves
from kubeflow_tpu_torch.train.trainer import SGD

SMALL = dict(stages=(1, 2), width=8, num_classes=10, groups=4)
B = 4
# f32: the same graph summed in another order by XLA's and oneDNN's CPU
# convolutions, through 3 blocks and 4 GroupNorms (which rescale each
# rounding difference by 1/std): the reference's f32 kernel bound (1e-5) for
# logits and loss, its flash-vs-dense gradient bound (1e-4,
# tests/test_longcontext.py:113) for the parameter gradients
F32_TOL, GRAD_TOL = 1e-5, 1e-4
# bf16: rounding at the same places, accumulation in other orders; the
# reference's bf16 logit bound (tests/test_engine.py:211)
BF16_TOL = 5e-2
DT = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _setup(dtype, **over):
    jd, td = DT[dtype]
    kw = {**SMALL, **over}
    jc, tc = jresnet.ResNetConfig(**kw, dtype=jd), tresnet.ResNetConfig(**kw, dtype=td)
    jp = jresnet.init(jax.random.PRNGKey(0), jc)
    return jc, tc, jp, tresnet.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _batch(size, seed=0, classes=10):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, size, size, 3), dtype=np.float32),
            rng.integers(0, classes, B).astype(np.int32))


def _jax_leaves(tree) -> dict:
    """The JAX tree's leaves under the port's dotted names, in the port's
    layout (OIHW conv kernels), as f32 numpy."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        name = ".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
        a = np.array(leaf, np.float32)
        out[name] = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a
    return out


def test_params_from_jax_keeps_the_tree_bit_exact():
    _, tc, jp, tp = _setup("bfloat16")
    assert len(tp["blocks"]) == sum(SMALL["stages"])
    assert "proj" in tp["blocks"][0] and "proj" not in tp["blocks"][2]
    want = _jax_leaves(jp)
    got = named_leaves(tp)
    assert set(got) == set(want)
    for name, t in got.items():
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(t.float().numpy(), want[name], err_msg=name)
    assert tresnet.count_params(tp) == jresnet.count_params(jp)
    fresh = named_leaves(tresnet.init(tc, "cpu"))
    assert {k: tuple(v.shape) for k, v in fresh.items()} == {k: tuple(v.shape) for k, v in got.items()}
    assert all(float(t.abs().max()) == 0 for k, t in fresh.items() if k.endswith("gn3.scale"))


def test_resnet50_param_count_matches_jax():
    n = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(
        jax.eval_shape(lambda: jresnet.init(jax.random.PRNGKey(0), jresnet.ResNetConfig()))))
    assert tresnet.count_params(tresnet.init(tresnet.ResNetConfig(), "cpu")) == n


@pytest.mark.parametrize("size", [32, 30])
def test_same_padding_matches_jax(size):
    for k, stride in ((7, 2), (3, 2), (3, 1), (1, 2), (1, 1)):
        x = np.random.default_rng(k).standard_normal((1, size, size, 2)).astype(np.float32)
        w = np.random.default_rng(k + 1).standard_normal((k, k, 2, 3)).astype(np.float32)
        want = np.asarray(jax.lax.conv_general_dilated(
            x, w, (stride, stride), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC")))
        got = tresnet._conv(torch.from_numpy(x).permute(0, 3, 1, 2),
                            torch.from_numpy(w).permute(3, 2, 0, 1), stride)
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=F32_TOL,
                                   atol=F32_TOL, err_msg=f"{k}x{k} stride {stride}")
    x = np.random.default_rng(9).standard_normal((1, size, size, 2)).astype(np.float32)
    want = np.asarray(jax.lax.reduce_window(x, -jnp.inf, jax.lax.max, (1, 3, 3, 1),
                                            (1, 2, 2, 1), "SAME"))
    got = tresnet._max_pool_3x3_s2(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


@pytest.mark.parametrize("size", [32, 30])
def test_forward_loss_and_grads_match_jax_f32(size):
    jc, tc, jp, tp = _setup("float32")
    images, labels = _batch(size)
    jloss, jgrads = jax.jit(lambda p, x, y: jax.value_and_grad(jresnet.loss)(p, jc, x, y))(
        jp, images, labels)
    jlogits = np.asarray(jax.jit(lambda p, x: jresnet.forward(p, jc, x))(jp, images))
    leaves = named_leaves(tp)
    for t in leaves.values():
        t.requires_grad_()
    np.testing.assert_allclose(tresnet.forward(tp, tc, torch.from_numpy(images)).detach().numpy(),
                               jlogits, rtol=F32_TOL, atol=F32_TOL)
    tloss = tresnet.loss(tp, tc, torch.from_numpy(images), torch.from_numpy(labels))
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=F32_TOL, atol=F32_TOL)
    grads = dict(zip(leaves, torch.autograd.grad(tloss, list(leaves.values()))))
    want = _jax_leaves(jgrads)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[name], rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=name)


def test_forward_matches_jax_bf16():
    jc, tc, jp, tp = _setup("bfloat16")
    images, _ = _batch(32, seed=1)
    jlogits = np.asarray(jax.jit(lambda p, x: jresnet.forward(p, jc, x))(jp, images))
    got = tresnet.forward(tp, tc, torch.from_numpy(images))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), jlogits, rtol=BF16_TOL, atol=BF16_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_three_sgd_momentum_steps_match_optax(dtype):
    """optax.sgd(0.1, momentum=0.9) and the port's ``SGD`` on the same
    parameters and three shared gradients.  f32: the same arithmetic, to f32
    rounding (1e-6).  bf16: both keep the trace in bf16 and round each
    operation there; XLA may fuse ``g + 0.9 t`` and round once, so a
    parameter may land one bf16 ulp of its magnitude apart (2**-7)."""
    jd, _ = DT[dtype]
    _, _, jp, tp = _setup(dtype)
    leaves = named_leaves(tp)
    opt, topt = optax.sgd(0.1, momentum=0.9), SGD(0.1, 0.9)
    jstate, tstate = opt.init(jp), topt.init(leaves)
    update = jax.jit(lambda g, s, p: opt.update(g, s, p))
    rng = np.random.default_rng(3)
    for _ in range(3):
        jg = jax.tree.map(lambda a: jnp.asarray(
            rng.standard_normal(a.shape).astype(np.float32) * 0.01, jd), jp)
        u, jstate = update(jg, jstate, jp)
        jp = optax.apply_updates(jp, u)
        tg = {k: torch.from_numpy(v).to(leaves[k].dtype) for k, v in _jax_leaves(jg).items()}
        topt.update(tg, tstate, leaves)
    tol = 1e-6 if dtype == "float32" else 2.0 ** -7
    want = _jax_leaves(jp)
    for k, t in leaves.items():
        np.testing.assert_allclose(t.float().numpy(), want[k], rtol=tol, atol=tol, err_msg=k)


def test_synthetic_batch_has_the_jax_layout():
    """The batches phase 19 trains on: the JAX function's shapes and dtypes
    (NHWC f32 images, int32 labels), labels in range, N(0, 1) images, and
    the same draws for the same seed (numpy's numbers, not jax.random's)."""
    got = tresnet.synthetic_batch(3, B, image_size=32, num_classes=10)
    want = jresnet.synthetic_batch(jax.random.PRNGKey(3), B, image_size=32, num_classes=10)
    for k in ("images", "labels"):
        assert got[k].shape == tuple(want[k].shape) and got[k].dtype == want[k].dtype, k
    assert got["labels"].min() >= 0 and got["labels"].max() < 10
    images = got["images"]
    assert abs(float(images.mean())) < 0.05 and abs(float(images.std()) - 1) < 0.05
    again = tresnet.synthetic_batch(3, B, image_size=32, num_classes=10)
    assert all(np.array_equal(got[k], again[k]) for k in got)
