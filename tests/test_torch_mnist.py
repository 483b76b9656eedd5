"""Port parity: kubeflow_tpu_torch's MNIST CNN and its worker against the
JAX package's.

The JAX package's ``mnist.init`` makes the weights; ``params_from_jax``
carries them into the port (HWIO kernels as OIHW), and the same numpy-seeded
images go through both models on the CPU at the full ``MnistConfig``
widths.  The optimizer is held to ``optax.adam`` over three steps on shared
gradients."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kubeflow_tpu.models import mnist as jmnist
from kubeflow_tpu_torch.models import mnist as tmnist
from kubeflow_tpu_torch.train.trainer import adam

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 8
# f32: the same graph summed in another order (XLA's and oneDNN's CPU
# convolutions): the reference's f32 kernel bound, 1e-5, for the logits and
# the loss; its flash-vs-dense gradient bound (tests/test_longcontext.py:113),
# 1e-4, for the gradients, whose dense_kernel entries sum over the batch
F32_TOL, GRAD_TOL = 1e-5, 1e-4
# bf16: both round at the same places, but the frameworks' CPU convolutions
# accumulate in other orders, so one rounding flip propagates; the
# reference's bf16 logit bound (tests/test_engine.py:211)
BF16_TOL = 5e-2


def _cfgs(dtype):
    return (jmnist.MnistConfig(dtype={"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]),
            tmnist.MnistConfig(dtype={"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]))


def _params(dtype):
    jc, _ = _cfgs(dtype)
    jp = jmnist.init(jax.random.PRNGKey(0), jc)
    return jp, tmnist.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((B, 28, 28, 1), dtype=np.float32)
    labels = rng.integers(0, 10, B).astype(np.int32)
    return images, labels


def _jax_value_and_grad(jp, jc, images, labels):
    # the test's own jit: no compile-cache entry shared with a reference test
    return jax.jit(lambda p, x, y: jax.value_and_grad(jmnist.loss)(p, jc, x, y))(
        jp, images, labels)


def _to_torch_layout(name, arr):
    t = torch.from_numpy(np.array(arr, np.float32))
    return t.permute(3, 2, 0, 1) if name in tmnist.CONV_KERNELS else t


def test_params_from_jax_bit_exact_oihw_and_count():
    jp, tp = _params("bfloat16")
    assert set(tp) == set(jp)
    for name, arr in jp.items():
        want = _to_torch_layout(name, arr).to(torch.bfloat16)
        assert tp[name].dtype == torch.bfloat16
        assert torch.equal(tp[name], want), name
    assert tuple(tp["conv2_kernel"].shape) == (64, 32, 5, 5)
    assert sum(t.numel() for t in tp.values()) == tmnist.MnistConfig().num_params
    fresh = tmnist.init(tmnist.MnistConfig(), "cpu", seed=0)
    assert {k: tuple(v.shape) for k, v in fresh.items()} == {k: tuple(v.shape) for k, v in tp.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_loss_and_grads_match_jax(dtype):
    jc, tc = _cfgs(dtype)
    jp, tp = _params(dtype)
    images, labels = _batch()
    jlogits = np.asarray(jax.jit(lambda p, x: jmnist.forward(p, jc, x))(jp, images))
    leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
    tlogits = tmnist.forward(leaves, tc, torch.from_numpy(images))
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(tlogits.detach().numpy(), jlogits, rtol=tol, atol=tol)
    jloss, jgrads = _jax_value_and_grad(jp, jc, images, labels)
    tloss = tmnist.loss(leaves, tc, torch.from_numpy(images), torch.from_numpy(labels))
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=tol, atol=tol)
    if dtype == "float32":
        grads = torch.autograd.grad(tloss, list(leaves.values()))
        for (name, g) in zip(leaves, grads):
            np.testing.assert_allclose(g.numpy(), _to_torch_layout(name, jgrads[name]).numpy(),
                                       rtol=GRAD_TOL, atol=GRAD_TOL, err_msg=name)


def test_accuracy_matches_jax():
    jc, tc = _cfgs("float32")
    jp, tp = _params("float32")
    images, labels = _batch(1)
    jacc = float(jax.jit(lambda p, x, y: jmnist.accuracy(p, jc, x, y))(jp, images, labels))
    tacc = float(tmnist.accuracy(tp, tc, torch.from_numpy(images), torch.from_numpy(labels)))
    assert tacc == jacc


def test_synthetic_batch_is_class_structured():
    b = tmnist.synthetic_batch(3, 16)
    assert b["images"].shape == (16, 28, 28, 1) and b["images"].dtype == np.float32
    assert b["labels"].shape == (16,) and b["labels"].dtype == np.int32
    # the label's row is lit: its mean stands ~1 above every other row's
    rows = b["images"][..., 0].mean(axis=2)
    assert (rows.argmax(axis=1) == b["labels"]).all()
    np.testing.assert_array_equal(tmnist.synthetic_batch(3, 16)["images"], b["images"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_three_adam_steps_match_optax(dtype):
    """optax.adam(1e-3) and the port's ``adam`` on the same parameters and
    the same three gradients.  f32: the same arithmetic, to f32 rounding
    (1e-6).  bf16: both keep the moments in bf16 and round each operation
    there (optax's 0.999 acts as bf16 0.99609375 on both sides); XLA may
    fuse a chain and round once where the port rounds per operation, so a
    parameter may land one bf16 ulp of its magnitude apart (2**-7)."""
    jp, tp = _params(dtype)
    tp = {k: v.clone() for k, v in tp.items()}
    opt, topt = optax.adam(1e-3), adam(1e-3)
    jstate, tstate = opt.init(jp), topt.init(tp)
    rng = np.random.default_rng(7)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    update = jax.jit(lambda g, s, p: opt.update(g, s, p))
    for _ in range(3):
        gs = {k: rng.standard_normal(np.asarray(v).shape).astype(np.float32) * 0.01
              for k, v in jp.items()}
        jg = {k: jnp.asarray(v, jdt) for k, v in gs.items()}
        u, jstate = update(jg, jstate, jp)
        jp = optax.apply_updates(jp, u)
        tg = {k: _to_torch_layout(k, jg[k]).to(tp[k].dtype) for k in tp}
        topt.update(tg, tstate, tp)
    tol = 1e-6 if dtype == "float32" else 2.0 ** -7
    for k in tp:
        want = _to_torch_layout(k, jp[k]).numpy()
        np.testing.assert_allclose(tp[k].float().numpy(), want, rtol=tol, atol=tol, err_msg=k)


def test_worker_prints_its_four_lines():
    env = dict(os.environ, TORCH_DEVICE="cpu", TRAIN_STEPS="20", BATCH_SIZE="32",
               PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-m", "kubeflow_tpu_torch.examples.mnist_worker"],
                       cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = r.stdout.strip().splitlines()
    assert [line.split("=")[0] for line in lines] == ["loss", "accuracy", "samples_per_sec",
                                                       "MNIST-OK"]
    # the JAX CNN's bar (tests/test_model_families.py:41) after 40 steps at 64
    assert float(lines[1].split("=")[1]) > 0.8


def test_more_than_one_local_device_is_refused():
    # in a job of two processes (one process takes LOCAL_DEVICES as mesh
    # shards on its device): refused before any group is joined
    env = dict(os.environ, TORCH_DEVICE="cpu", TRAIN_STEPS="1", LOCAL_DEVICES="2",
               JAX_COORDINATOR_ADDRESS="127.0.0.1:1", JAX_NUM_PROCESSES="2",
               JAX_PROCESS_ID="0", PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-m", "kubeflow_tpu_torch.examples.mnist_worker"],
                       cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and "item 3.3" in r.stderr
