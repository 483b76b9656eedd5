"""Port parity: kubeflow_tpu_torch's trainable decoder LM family against the
JAX package's ``models/decoder.py``.

The JAX engine's ``init`` makes the weights (f32 for the algorithm, bf16 for
the working type); ``params_from_jax`` carries them into the port, and the
same numpy-seeded token batches go through ``lm_loss`` on both sides on the
CPU, at ``tiny()`` and with the Gemma flags (GeGLU, scaled embeddings, a
decoupled head_dim) as tests/test_model_families.py trains them.  AdamW is
held to ``optax.adamw(3e-3)`` over three steps on shared gradients."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kubeflow_tpu.models import decoder as jdec
from kubeflow_tpu_torch.models import decoder as tdec
from kubeflow_tpu_torch.train.trainer import adamw

B, S = 2, 16
GEMMA = dict(act="gelu_tanh", scale_embed=True, head_dim_override=24)
# f32: the same graph summed in another order: the reference's f32 bound
# (1e-5) for the loss, its flash-vs-dense gradient bound (1e-4,
# tests/test_longcontext.py:113) for the gradients
F32_TOL, GRAD_TOL = 1e-5, 1e-4
# bf16: the reference's bf16 logit bound (tests/test_engine.py:211)
BF16_TOL = 5e-2


def _cfgs(family):
    j, t = jdec.tiny(), tdec.tiny()
    if family == "gemma":
        j, t = dataclasses.replace(j, **GEMMA), dataclasses.replace(t, **GEMMA)
    return j, t


def _params(jc, dtype):
    jp = jdec.init(jax.random.PRNGKey(0), jc, dtype=dtype)
    return jp, tdec.params_from_jax({k: np.asarray(v) for k, v in jp.items()}, "cpu")


def _tokens(seed=0, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(np.int32)


def test_configs_and_flops_match_jax():
    for name in ("gemma_7b", "tiny"):
        jc, tc = getattr(jdec, name)(), getattr(tdec, name)()
        assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
        assert tc.param_count() == jc.param_count()
        assert tdec.train_flops(tc, 4, 512) == jdec.train_flops(jc, 4, 512)
    g7 = tdec.gemma_7b()
    assert (g7.vocab_size, g7.d_model, g7.n_heads, g7.head_dim, g7.d_ff) == (
        256128, 3072, 16, 256, 24576)


@pytest.mark.parametrize("family", ["llama", "gemma"])
def test_loss_and_grads_match_jax_f32(family):
    jc, tc = _cfgs(family)
    jp, tp = _params(jc, jnp.float32)
    toks = _tokens()
    jloss, jgrads = jax.jit(lambda p, t: jax.value_and_grad(jdec.lm_loss)(p, jc, t))(jp, toks)
    leaves = {k: v.requires_grad_() for k, v in tp.items()}
    tloss = tdec.lm_loss(leaves, tc, torch.from_numpy(toks))
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=F32_TOL, atol=F32_TOL)
    grads = torch.autograd.grad(tloss, list(leaves.values()))
    for name, g in zip(leaves, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jgrads[name]), rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("family", ["llama", "gemma"])
def test_logits_and_loss_match_jax_bf16(family):
    jc, tc = _cfgs(family)
    jp, tp = _params(jc, jnp.bfloat16)
    toks = _tokens(1)
    jlogits = np.asarray(jax.jit(lambda p, t: jdec.forward_full(p, jc, t))(jp, toks))
    np.testing.assert_allclose(tdec.forward_full(tp, tc, torch.from_numpy(toks)).numpy(),
                               jlogits, rtol=BF16_TOL, atol=BF16_TOL)
    jloss = float(jax.jit(lambda p, t: jdec.lm_loss(p, jc, t))(jp, toks))
    np.testing.assert_allclose(float(tdec.lm_loss(tp, tc, torch.from_numpy(toks))), jloss,
                               rtol=BF16_TOL, atol=BF16_TOL)


def test_synthetic_lm_batches_follow_the_markov_law():
    gen = tdec.synthetic_lm_batches(97, 4, 33, seed=5)
    a, b = next(gen)["tokens"], next(gen)["tokens"]
    assert a.shape == (4, 33) and a.dtype == np.int32 and not np.array_equal(a, b)
    assert set(np.unique((a[:, 1:] - a[:, :-1]) % 97)) <= {0, 1, 2}
    assert a.min() >= 0 and a.max() < 97
    np.testing.assert_array_equal(next(tdec.synthetic_lm_batches(97, 4, 33, seed=5))["tokens"], a)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_three_adamw_steps_match_optax(dtype):
    """optax.adamw(3e-3) (weight decay 1e-4, optax's default) and the port's
    ``adamw(3e-3)`` on the same parameters and three shared gradients.  f32:
    the same arithmetic to f32 rounding (1e-6).  bf16: both keep the moments
    in bf16 and round each operation there; XLA may fuse a chain and round
    once, so a parameter may land one bf16 ulp of its magnitude apart
    (2**-7)."""
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    jc, _ = _cfgs("gemma")
    jp, tp = _params(jc, jd)
    opt, topt = optax.adamw(3e-3), adamw(3e-3)
    assert topt.weight_decay == 1e-4
    jstate, tstate = opt.init(jp), topt.init(tp)
    update = jax.jit(lambda g, s, p: opt.update(g, s, p))
    rng = np.random.default_rng(11)
    for _ in range(3):
        gs = {k: jnp.asarray(rng.standard_normal(v.shape).astype(np.float32) * 0.01, jd)
              for k, v in jp.items()}
        u, jstate = update(gs, jstate, jp)
        jp = optax.apply_updates(jp, u)
        topt.update({k: torch.from_numpy(np.array(v, np.float32)).to(tp[k].dtype)
                     for k, v in gs.items()}, tstate, tp)
    tol = 1e-6 if dtype == "float32" else 2.0 ** -7
    for k, t in tp.items():
        np.testing.assert_allclose(t.float().numpy(), np.asarray(jp[k], np.float32), rtol=tol,
                                   atol=tol, err_msg=k)
