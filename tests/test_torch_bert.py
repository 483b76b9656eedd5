"""Port parity: kubeflow_tpu_torch's BERT MLM against the JAX package's.

The JAX package's ``bert.init`` makes the weights; ``params_from_jax``
carries them into the port bit for bit, and the same numpy-seeded batches go
through both models on the CPU (the JAX flash path runs its Pallas kernel in
interpret mode, the port's flash path its plain PyTorch version).  Sizes
are the tiny config of tests/test_models_training.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import bert as jbert
from kubeflow_tpu_torch.models import bert as tbert

TINY = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
            intermediate_size=128, max_position=64)
B, S = 2, 32
# f32 (dtype=float32): both sides compute the same f32 graph and differ in
# summation order only: the reference's f32 kernel bound (1e-5) for
# activations and the loss, its flash-vs-dense gradient bound
# (tests/test_longcontext.py:113, 1e-4) for parameter gradients.
F32_TOL, GRAD_TOL = 1e-5, 1e-4
# bf16 (the default dtype): the two frameworks round to bf16 at the same
# places but their CPU matmuls accumulate in different orders, so one bf16
# rounding flip propagates; the reference's bf16 logit bound
# (tests/test_engine.py:211) is 5e-2.
BF16_TOL = 5e-2


def _configs(dtype: str, attention: str = "dense"):
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    td = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    return (jbert.BertConfig(**TINY, dtype=jd, attention=attention),
            tbert.BertConfig(**TINY, dtype=td, attention=attention))


@pytest.fixture(scope="module")
def jparams():
    return jbert.init(jax.random.PRNGKey(0), jbert.BertConfig(**TINY))


@pytest.fixture(scope="module")
def np_tree(jparams):
    return jax.tree.map(np.asarray, jparams)


def _batch(seed=0, masked=0.3):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, TINY["vocab_size"], (B, S)).astype(np.int32)
    labels = np.where(rng.random((B, S)) < masked,
                      rng.integers(0, TINY["vocab_size"], (B, S)), -100).astype(np.int32)
    am = np.ones((B, S), np.int32)
    am[1, 20:] = 0  # one ragged row
    return ids, labels, am


def _model(np_tree):
    return tbert.params_from_jax(np_tree, "cpu")


def test_params_from_jax_is_bit_exact_and_keeps_names(np_tree):
    model = _model(np_tree)
    sd = model.state_dict()
    want = {f"{g}.{n}": a for g, leaves in np_tree.items() for n, a in leaves.items()}
    assert set(sd) == set(want)
    for name, arr in want.items():
        assert sd[name].dtype == torch.float32
        np.testing.assert_array_equal(sd[name].numpy(), arr, err_msg=name)
    assert tuple(sd["layers.attn_qkv_kernel"].shape) == (2, 64, 3, 4, 16)
    assert sum(p.numel() for p in model.parameters()) == tbert.BertConfig(**TINY).num_params


def test_config_fields_and_flop_formulas_match_reference():
    jf = {f.name: f.default for f in dataclasses.fields(jbert.BertConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(tbert.BertConfig)}
    assert list(jf) == list(tf)
    assert jnp.dtype(jf.pop("dtype")).name == str(tf.pop("dtype")).removeprefix("torch.")
    assert jf == tf
    for kw in ({}, TINY):
        jc, tc = jbert.BertConfig(**kw), tbert.BertConfig(**kw)
        assert tc.head_dim == jc.head_dim
        assert tc.num_params == jc.num_params
        for seq in (128, 512):
            assert tc.flops_per_token(seq) == jc.flops_per_token(seq)
            assert tc.train_flops(32, seq, 20 * seq // 128) == jc.train_flops(32, seq, 20 * seq // 128)
            assert tc.train_flops(8, seq) == jc.train_flops(8, seq)


def test_init_is_seeded_with_reference_shapes_and_statistics(np_tree):
    a = tbert.init(tbert.BertConfig(**TINY), "cpu", seed=0).state_dict()
    b = tbert.init(tbert.BertConfig(**TINY), "cpu", seed=0).state_dict()
    c = tbert.init(tbert.BertConfig(**TINY), "cpu", seed=1).state_dict()
    for g, leaves in np_tree.items():
        for n, arr in leaves.items():
            key = f"{g}.{n}"
            assert tuple(a[key].shape) == arr.shape and a[key].dtype == torch.float32
            assert torch.equal(a[key], b[key])
    assert not torch.equal(a["embeddings.word"], c["embeddings.word"])
    assert abs(float(a["embeddings.word"].std()) - 0.02) < 1e-3
    assert torch.equal(a["layers.ln1_scale"], torch.ones(2, 64))
    assert torch.equal(a["mlm.output_bias"], torch.zeros(512))


@pytest.mark.parametrize("dtype,tol", [("float32", F32_TOL), ("bfloat16", BF16_TOL)])
def test_encode_and_forward_match_reference(np_tree, jparams, dtype, tol):
    jc, tc = _configs(dtype)
    ids, _, am = _batch()
    p = jax.tree.map(jnp.asarray, np_tree)
    model = _model(np_tree)
    with torch.no_grad():
        hid = tbert.encode(model, tc, torch.from_numpy(ids), torch.from_numpy(am))
        logits = tbert.forward(model, tc, torch.from_numpy(ids), torch.from_numpy(am))
    jhid = jbert.encode(p, jc, jnp.asarray(ids), jnp.asarray(am))
    jlog = jbert.forward(p, jc, jnp.asarray(ids), jnp.asarray(am))
    assert hid.dtype == tc.dtype and logits.shape == (B, S, TINY["vocab_size"])
    np.testing.assert_allclose(hid.float().numpy(), np.asarray(jhid, np.float32),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(logits.float().numpy(), np.asarray(jlog, np.float32),
                               rtol=tol, atol=tol)


def _loss_and_grads(np_tree, dtype, attention, max_predictions, batch):
    jc, tc = _configs(dtype, attention)
    ids, labels, am = batch

    def jloss(p):
        return jbert.mlm_loss(p, jc, jnp.asarray(ids), jnp.asarray(labels),
                              jnp.asarray(am), max_predictions=max_predictions)

    jl, jg = jax.jit(jax.value_and_grad(jloss))(jax.tree.map(jnp.asarray, np_tree))
    model = _model(np_tree)
    tl = tbert.mlm_loss(model, tc, torch.from_numpy(ids), torch.from_numpy(labels),
                        torch.from_numpy(am), max_predictions=max_predictions)
    tl.backward()
    return float(jl), jg, float(tl.detach()), dict(model.named_parameters())


@pytest.mark.parametrize("max_predictions", [None, 3, 12])
@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_mlm_loss_and_grads_match_reference_f32(np_tree, attention, max_predictions):
    """max_predictions=3 is below every row's masked count, so which masked
    positions are gathered is decided among ties: lax.top_k takes the lowest
    indices, and so must the port.  12 exceeds one row's count, so the
    unmasked (weight-0) padding slots come in too."""
    batch = _batch(seed=1)
    assert (batch[1] != -100).sum(1).min() > 3
    jl, jg, tl, tp = _loss_and_grads(np_tree, "float32", attention, max_predictions, batch)
    np.testing.assert_allclose(tl, jl, rtol=F32_TOL)
    for g, leaves in jg.items():
        for n, want in leaves.items():
            np.testing.assert_allclose(tp[f"{g}.{n}"].grad.numpy(), np.asarray(want),
                                       rtol=GRAD_TOL, atol=GRAD_TOL, err_msg=f"{g}.{n}")


@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_mlm_loss_matches_reference_bf16(np_tree, attention):
    """bf16 end to end: the loss within 1e-3 relative (bf16 logits upcast
    for an f32 log-softmax; measured 4e-5 to 6e-5) and the gradient's global
    norm within the reference's flash-vs-dense gradient bound, 5e-3
    (tests/test_longcontext.py:145; measured 1e-4 to 2.5e-4)."""
    jl, jg, tl, tp = _loss_and_grads(np_tree, "bfloat16", attention, 12, _batch(seed=2))
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
    jnorm = float(jnp.sqrt(sum(jnp.sum(x.astype(jnp.float32) ** 2)
                               for x in jax.tree.leaves(jg))))
    tnorm = float(torch.sqrt(sum(p.grad.float().square().sum() for p in tp.values())))
    np.testing.assert_allclose(tnorm, jnorm, rtol=5e-3)


def test_max_predictions_picks_top_k_positions():
    """The gathered positions are exactly lax.top_k's, ties to the lowest
    index: masked positions first in order, then unmasked ones in order."""
    valid = np.zeros((3, 16), np.int32)
    valid[0, [2, 5, 9, 11]] = 1
    valid[1, :] = 1
    _, jidx = jax.lax.top_k(jnp.asarray(valid), 6)
    _, tidx = torch.sort(torch.from_numpy(valid), dim=1, descending=True, stable=True)
    np.testing.assert_array_equal(tidx[:, :6].numpy(), np.asarray(jidx))


def test_all_ignored_loss_is_exactly_zero(np_tree):
    _, tc = _configs("bfloat16")
    ids = torch.zeros((2, 8), dtype=torch.int32)
    loss = tbert.mlm_loss(_model(np_tree), tc, ids, torch.full((2, 8), -100, dtype=torch.int32))
    assert float(loss) == 0.0


def test_unported_options_raise():
    # remat is ported (tests/test_torch_bert_remat.py) and so is pipeline
    # parallelism (tests/test_torch_gpipe.py): nothing is refused any more,
    # and an unknown policy is an error
    tbert.BertConfig(remat=True)
    tbert.BertConfig(remat_policy="dots")
    cfg = tbert.BertConfig(pipeline_stages=2)
    assert (cfg.pipeline_stages, cfg.pipeline_microbatches) == (2, 4)
    with pytest.raises(ValueError, match="remat_policy"):
        tbert.BertConfig(remat=True, remat_policy="everything")
