"""Port parity: the flash-attention op of kubeflow_tpu_torch against the JAX
package's Pallas kernel (run in interpret mode on the CPU) and its custom VJP.

The same numpy-seeded inputs go through ``kubeflow_tpu``'s ``_flash_fwd(...,
interpret=True)`` / ``flash_attention`` and the port's
``flash_attention_plain`` / ``flash_attention`` on CPU tensors, which run the
port's plain PyTorch version.  The Hopper kernel itself is held against that
plain version on the card (tests/test_torch_kernels_cuda.py and
chip_smoke.py).  Sizes follow tests/test_longcontext.py: B=2, S=64, H=4,
D=16, blocks of 16.

The JAX forward runs through ``jax_reference_fwd``, a jit of this file's
own: the pallas call dispatched eagerly compiles to a module that
tests/test_longcontext.py compiles too, with the same persistent-cache key
(the tests share one ``.jax_cache``), and an executable that test wrote
from another worker process at the same moment has given outputs 3.7e-5
off (1.8x this file's f32 tolerance) where a fresh compile agrees to
4e-7.  Under this file's own module name the key is this file's alone."""

import functools
import importlib

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

JF = importlib.import_module("kubeflow_tpu.ops.flash_attention")
TF = importlib.import_module("kubeflow_tpu_torch.ops.flash_attention")
from kubeflow_tpu_torch.ops.attention import multihead_attention, padding_mask  # noqa: E402

B, S, H, D = 2, 64, 4, 16

# f32: both sides compute in f32 and differ only in summation order — the
# reference's own flash-vs-dense bound (tests/test_longcontext.py:47) is
# 2e-5.  bf16 inputs: both sides compute in f32 from the same bf16 values
# and round the output to bf16, so they differ by at most one bf16 ulp
# (2**-8 relative at |x| >= 1, below 5e-2 absolute for |x| < 6).
F32_TOL, BF16_TOL = 2e-5, 5e-2
# gradients through the VJP at f32: the reference's flash-vs-dense gradient
# bound (tests/test_longcontext.py:113)
GRAD_TOL = 1e-4


def _qkv(dtype=np.float32, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((B, S, H, D)).astype(dtype) for _ in range(3))


def _mask(kind):
    """[B, S] f32 key masks: None, ragged right padding, or a left-padded
    row whose first 20 query rows see no key under causal."""
    if kind is None:
        return None
    am = np.ones((B, S), np.float32)
    if kind == "ragged":
        am[0, 40:] = 0
    else:  # "left"
        am[1, :20] = 0
    return am


def _rows(x):
    """[B, S, H, D] -> [B*H, S, D] kernel rows."""
    return np.ascontiguousarray(x.transpose(0, 2, 1, 3).reshape(B * H, S, D))


@functools.partial(jax.jit, static_argnums=(4, 5, 6, 7))
def jax_reference_fwd(q, k, v, mask, scale, causal, block_q, block_k):
    """The JAX package's Pallas forward (interpret mode) -> (out, lse)."""
    return JF._flash_fwd(q, k, v, mask, scale, causal, block_q, block_k, True, H)


def _t(x):
    """numpy (incl. ml_dtypes bf16) -> CPU tensor, bit-exact."""
    if x.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(x.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(x)


@pytest.mark.parametrize("mask_kind", [None, "ragged", "left"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("block_q,block_k", [(16, 16), (32, 16), (16, 32)])
def test_plain_forward_matches_jax_kernel(causal, mask_kind, block_q, block_k):
    q, k, v = (_rows(x) for x in _qkv())
    am = _mask(mask_kind)
    scale = D ** -0.5
    jm = None if am is None else jnp.asarray(am.reshape(B, 1, S))
    ref_o, ref_l = jax_reference_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jm,
                                     scale, causal, block_q, block_k)
    tm = None if am is None else torch.from_numpy(am.reshape(B, 1, S))
    out, lse = TF.flash_attention_plain(_t(q), _t(k), _t(v), tm, scale, causal,
                                        block_q, block_k)
    assert out.dtype == torch.float32 and lse.shape == (B * H, S)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_o), rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_l), rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_plain_forward_bf16_matches_jax_kernel(causal):
    q, k, v = (_rows(x) for x in _qkv(ml_dtypes.bfloat16, seed=1))
    am = _mask("ragged")
    ref_o, ref_l = jax_reference_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     jnp.asarray(am.reshape(B, 1, S)), D ** -0.5, causal,
                                     16, 16)
    out, lse = TF.flash_attention_plain(_t(q), _t(k), _t(v),
                                        torch.from_numpy(am.reshape(B, 1, S)),
                                        D ** -0.5, causal, 16, 16)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref_o, np.float32),
                               rtol=BF16_TOL, atol=BF16_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_l), rtol=F32_TOL, atol=F32_TOL)


def test_row_with_no_visible_key_averages_visited_values():
    """Causal + left padding: batch 1's first 20 query rows see no key.  With
    blocks of 16, query row 5 (block 0) visits keys 0..15 and averages V
    over exactly those; row 18 (block 1) visits keys 0..31."""
    q, k, v = _qkv()
    am = torch.from_numpy(_mask("left"))
    out = TF.flash_attention(_t(q), _t(k), _t(v), causal=True, block_q=16,
                             block_k=16, kv_mask=am)
    np.testing.assert_allclose(out[1, 5].numpy(), v[1, :16].mean(0), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out[1, 18].numpy(), v[1, :32].mean(0), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mask_kind", [None, "ragged", "left"])
@pytest.mark.parametrize("causal", [False, True])
def test_gradients_match_jax_vjp(causal, mask_kind):
    """The autograd Function's backward against jax.grad through the custom
    VJP, the masked rows that see no key included: both recompute P over
    every key block from the saved lse (see _flash_bwd's docstring)."""
    q, k, v = _qkv(seed=2)
    am = _mask(mask_kind)
    rng = np.random.default_rng(3)
    w = rng.standard_normal((B, S, H, D)).astype(np.float32)  # a random cotangent

    def jloss(q, k, v):
        o = JF.flash_attention(q, k, v, causal=causal, block_q=16, block_k=32,
                               kv_mask=None if am is None else jnp.asarray(am))
        return jnp.sum(o * w)

    ref = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    qt, kt, vt = (_t(x).requires_grad_() for x in (q, k, v))
    out = TF.flash_attention(qt, kt, vt, causal=causal, block_q=16, block_k=32,
                             kv_mask=None if am is None else torch.from_numpy(am))
    (out * torch.from_numpy(w)).sum().backward()
    for name, got, want in zip("qkv", (qt.grad, kt.grad, vt.grad), ref):
        assert got.dtype == torch.float32, name
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=f"d{name}")


def test_bf16_gradients_keep_input_dtypes():
    q, k, v = (_t(x).requires_grad_() for x in _qkv(ml_dtypes.bfloat16))
    TF.flash_attention(q, k, v, block_q=16, block_k=16).float().sum().backward()
    assert q.grad.dtype == k.grad.dtype == v.grad.dtype == torch.bfloat16


def test_rejects_indivisible_blocks():
    q, k, v = (_t(x) for x in _qkv())
    with pytest.raises(ValueError, match="must divide blocks"):
        TF.flash_attention(q, k, v, block_q=48, block_k=48)


def test_blocks_clamp_to_sequence_length():
    q, k, v = (_t(x) for x in _qkv())
    np.testing.assert_array_equal(
        TF.flash_attention(q, k, v, causal=True, block_q=128, block_k=128).numpy(),
        TF.flash_attention(q, k, v, causal=True, block_q=64, block_k=64).numpy())


@pytest.mark.parametrize("mask_kind", [None, "ragged"])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_matches_port_dense_attention(causal, mask_kind):
    q, k, v = (_t(x) for x in _qkv(seed=4))
    am = _mask(mask_kind)
    dense = multihead_attention(q, k, v, causal=causal,
                                mask=None if am is None else padding_mask(torch.from_numpy(am)))
    flash = TF.flash_attention(q, k, v, causal=causal, block_q=16, block_k=16,
                               kv_mask=None if am is None else torch.from_numpy(am))
    np.testing.assert_allclose(flash.numpy(), dense.numpy(), rtol=F32_TOL, atol=F32_TOL)


def test_cpu_tensors_take_plain_path_and_count_no_launch():
    before = TF.flash_attention.launches
    q, k, v = (_t(x) for x in _qkv())
    TF.flash_attention(q, k, v, block_q=16, block_k=16)
    assert TF.flash_attention.launches == before == 0


def test_unsupported_device_raises():
    q = torch.empty((B, S, H, D), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        TF.flash_attention(q, q, q, block_q=16, block_k=16)
