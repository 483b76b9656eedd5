"""Port parity: the paged-attention wrapper of kubeflow_tpu_torch against the
JAX package's Pallas kernel (run in interpret mode on the CPU).

The same numpy-seeded inputs go through ``kubeflow_tpu``'s
``paged_attention(interpret=True)`` and the port's ``paged_attention`` on
CPU tensors, which runs the port's plain PyTorch version.  The Hopper
kernel itself is held against that plain version on the card
(tests/test_torch_kernels_cuda.py and chip_smoke.py)."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from kubeflow_tpu.serving.engine.paged_attention import paged_attention as jax_paged_attention
from kubeflow_tpu_torch.serving.engine import paged_attention as PA

B, Hq, Hkv, hd, ps, P = 3, 4, 2, 16, 8, 12
PAGE_TABLE = np.array([[3, 5, 7], [1, 2, 0], [0, 0, 0]], np.int32)
SEQ_LENS = np.array([20, 9, 0], np.int32)  # partial last pages; slot 2 idle

# (pool kind, q dtype, atol=rtol).  f32: the reference's kernel tolerance
# (tests/test_engine.py:357) — both sides compute in f32 and differ only in
# summation order.  bf16: both compute in f32 from the same bf16 inputs and
# round the output to bf16, so one bf16 ulp at |x| ~ 1 (2**-7) bounds it.
# int8: the dequantization is the same f32 product on both sides, so the
# f32 bound holds.
CASES = [("f32", np.float32, 1e-5), ("bf16", ml_dtypes.bfloat16, 1e-2),
         ("int8", np.float32, 1e-5)]


def _inputs(kind, q_dtype, K, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, K, Hq, hd)).astype(q_dtype)
    if kind == "int8":
        def pool():
            return {"q": rng.integers(-127, 128, (P, Hkv, ps, hd)).astype(np.int8),
                    "s": (rng.random((P, Hkv, ps, 1)) * 0.05 + 1e-3
                          ).astype(ml_dtypes.bfloat16)}
        return q, pool(), pool()
    dt = np.float32 if kind == "f32" else ml_dtypes.bfloat16
    return (q, rng.standard_normal((P, Hkv, ps, hd)).astype(dt),
            rng.standard_normal((P, Hkv, ps, hd)).astype(dt))


def _t(x):
    """numpy (incl. ml_dtypes bf16) -> CPU tensor, bit-exact."""
    if isinstance(x, dict):
        return {k: _t(v) for k, v in x.items()}
    if x.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(x.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(x)


def _j(x):
    if isinstance(x, dict):
        return {k: jnp.asarray(v) for k, v in x.items()}
    return jnp.asarray(x)


def _f32(x):
    return (x.float() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32))


@pytest.mark.parametrize("K", [1, 5])
@pytest.mark.parametrize("kind,q_dtype,tol", CASES, ids=[c[0] for c in CASES])
def test_plain_matches_jax_kernel(kind, q_dtype, tol, K):
    q, kp, vp = _inputs(kind, q_dtype, K)
    ref = jax_paged_attention(_j(q), _j(kp), _j(vp), jnp.asarray(PAGE_TABLE),
                              jnp.asarray(SEQ_LENS), ps, interpret=True)
    out = PA.paged_attention(_t(q), _t(kp), _t(vp), torch.from_numpy(PAGE_TABLE),
                             torch.from_numpy(SEQ_LENS), ps)
    assert out.shape == (B, K, Hq, hd) and out.dtype == _t(q).dtype
    np.testing.assert_allclose(_f32(out).numpy(), np.asarray(ref, np.float32),
                               rtol=tol, atol=tol)


def test_idle_slot_and_unseeing_rows():
    """An idle K=1 slot visits no page and returns exact zeros; with K=5 the
    idle slot visits page 0 (row 4's horizon is 4) and its row 0 — which
    sees no position — averages V uniformly over that page's positions."""
    q, kp, vp = _inputs("f32", np.float32, 5)
    pt, sl = torch.from_numpy(PAGE_TABLE), torch.from_numpy(SEQ_LENS)
    out1 = PA.paged_attention(_t(q[:, :1]), _t(kp), _t(vp), pt, sl, ps)
    assert torch.equal(out1[2], torch.zeros_like(out1[2]))
    out5 = PA.paged_attention(_t(q), _t(kp), _t(vp), pt, sl, ps)
    page0 = vp[PAGE_TABLE[2, 0]]                       # [Hkv, ps, hd]
    for hq in range(Hq):
        np.testing.assert_allclose(out5[2, 0, hq].numpy(),
                                   page0[hq // (Hq // Hkv)].mean(0),
                                   rtol=1e-5, atol=1e-5)


def test_cpu_tensors_take_plain_path_and_count_no_launch():
    q, kp, vp = _inputs("bf16", ml_dtypes.bfloat16, 1)
    before = PA.paged_attention.launches
    out = PA.paged_attention(_t(q), _t(kp), _t(vp), torch.from_numpy(PAGE_TABLE),
                             torch.from_numpy(SEQ_LENS), ps)
    plain = PA.paged_attention_plain(_t(q), _t(kp), _t(vp), torch.from_numpy(PAGE_TABLE),
                                     torch.from_numpy(SEQ_LENS), ps)
    assert torch.equal(out, plain)
    assert PA.paged_attention.launches == before == 0


def test_unsupported_device_raises():
    q = torch.empty((1, 1, Hq, hd), device="meta")
    pool = torch.empty((P, Hkv, ps, hd), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        PA.paged_attention(q, pool, pool, torch.zeros((1, 3), dtype=torch.int32),
                           torch.zeros((1,), dtype=torch.int32), ps)
