"""BERT rematerialization in the port against no remat, and against the JAX
package's remat policies.

Every policy is a pure memory/FLOPs trade: the loss and the gradients with
remat equal those without it at tests/test_models_training.py:148-174's
``atol=1e-4``, on the dense path and on the flash path (the plain version of
the kernel here), in f32 (the algorithm) and in bf16 (the working type).

What each policy keeps for the backward is read in two places: what
autograd keeps directly (the checkpoints' inputs, the head's activations)
through ``torch.autograd.graph.saved_tensors_hooks``, and what the
selective checkpoint policy keeps in its own cache (which autograd's hooks
never see) from that cache: more kept values, more kept bytes."""

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
POLICIES = ["nothing", "dots", "save_qkv", "save_attn", "save_mlp"]
B, S = 2, 32
# tests/test_models_training.py:173 (remat against no remat)
REMAT_ATOL = 1e-4
# the port's f32 remat against the JAX package's: the reference's f32 bound
# (1e-5) for the loss, its gradient bound (1e-4)
F32_TOL, GRAD_TOL = 1e-5, 1e-4


@pytest.fixture(scope="module")
def np_tree():
    return jax.tree.map(np.asarray, jbert.init(jax.random.PRNGKey(3), jbert.BertConfig(**TINY)))


def _batch():
    rng = np.random.default_rng(4)
    ids = rng.integers(0, TINY["vocab_size"], (B, S)).astype(np.int32)
    labels = ids.copy()
    labels[:, ::3] = -100
    am = np.ones((B, S), np.int32)
    am[1, 20:] = 0
    return ids, labels, am


def _loss_and_grads(model, cfg):
    ids, labels, am = (torch.from_numpy(a) for a in _batch())
    loss = tbert.mlm_loss(model, cfg, ids, labels, am)
    return float(loss.detach()), torch.autograd.grad(loss, list(model.parameters()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("attention", ["dense", "flash"])
@pytest.mark.parametrize("policy", POLICIES)
def test_remat_matches_no_remat(np_tree, policy, attention, dtype):
    base = tbert.BertConfig(**TINY, attention=attention,
                            dtype={"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype])
    model = tbert.params_from_jax(np_tree, "cpu")
    l0, g0 = _loss_and_grads(model, base)
    l1, g1 = _loss_and_grads(model, dataclasses.replace(base, remat=True, remat_policy=policy))
    assert abs(l0 - l1) < REMAT_ATOL
    for name, a, b in zip(dict(model.named_parameters()), g0, g1):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=REMAT_ATOL, err_msg=name)


@pytest.mark.parametrize("policy", POLICIES)
def test_remat_matches_the_jax_policy_f32(np_tree, policy):
    jc = jbert.BertConfig(**TINY, dtype=jnp.float32, remat=True, remat_policy=policy)
    tc = tbert.BertConfig(**TINY, dtype=torch.float32, remat=True, remat_policy=policy)
    ids, labels, am = _batch()
    jparams = jax.tree.map(jnp.asarray, np_tree)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jbert.mlm_loss(p, jc, ids, labels, am)))(jparams)
    model = tbert.params_from_jax(np_tree, "cpu")
    tloss, tgrads = _loss_and_grads(model, tc)
    np.testing.assert_allclose(tloss, float(jloss), rtol=F32_TOL, atol=F32_TOL)
    for (name, _), g in zip(model.named_parameters(), tgrads):
        group, leaf = name.split(".")
        np.testing.assert_allclose(g.numpy(), np.asarray(jgrads[group][leaf]), rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=name)


def _kept(model, cfg, monkeypatch) -> tuple:
    """(activation bytes, {layer-cache kind: count}) of what the forward
    keeps for the backward: the distinct [B, S, ...] storages autograd's
    saved-tensor hooks see, plus every tensor in the selective checkpoint
    caches, counted by the op that made it."""
    caches = []
    make = torch.utils.checkpoint.create_selective_checkpoint_contexts

    def recording(policy):
        fwd, rec = make(policy)
        caches.append(fwd.storage)
        return fwd, rec

    monkeypatch.setattr(torch.utils.checkpoint, "create_selective_checkpoint_contexts",
                        recording)
    seen, kinds = {}, {}

    def pack(t):
        if t.dim() >= 2 and tuple(t.shape[:2]) == (B, S):
            st = t.untyped_storage()
            seen[st.data_ptr()] = st.nbytes()
        return t

    def walk(v, op):
        if isinstance(v, torch.Tensor):
            seen[v.untyped_storage().data_ptr()] = v.untyped_storage().nbytes()
            kinds[str(op)] = kinds.get(str(op), 0) + 1
        elif isinstance(v, (list, tuple)):
            for u in v:
                walk(u, op)
        elif isinstance(v, dict):
            for u in v.values():
                walk(u, op)
        elif hasattr(v, "val"):
            walk(v.val, op)

    ids, labels, am = (torch.from_numpy(a) for a in _batch())
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss = tbert.mlm_loss(model, cfg, ids, labels, am)
    for storage in caches:
        for op, entries in storage.items():
            walk(entries, op)
    monkeypatch.undo()
    del loss
    return sum(seen.values()), kinds


@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_kept_tensors_grow_with_the_policy(np_tree, attention, monkeypatch):
    model = tbert.params_from_jax(np_tree, "cpu")
    base = tbert.BertConfig(**TINY, attention=attention)
    got = {p: _kept(model, dataclasses.replace(base, remat=True, remat_policy=p), monkeypatch)
           for p in POLICIES}
    nbytes = {p: v[0] for p, v in got.items()}
    nbytes["none"] = _kept(model, base, monkeypatch)[0]
    assert nbytes["nothing"] < nbytes["save_qkv"] <= nbytes["save_attn"] <= nbytes["save_mlp"]
    assert nbytes["save_mlp"] < nbytes["none"] and nbytes["nothing"] < nbytes["dots"] < nbytes["none"]
    # per layer: the named copies of each policy, and dots' four projections
    layers = TINY["num_layers"]
    mark = "kubeflow_tpu_torch.checkpoint_name.default"
    assert got["nothing"][1] == {}
    assert got["save_qkv"][1] == {mark: layers}
    assert got["save_attn"][1] == {mark: 2 * layers}
    assert got["save_mlp"][1] == {mark: 5 * layers}
    assert got["dots"][1] == {"aten.mm.default": 4 * layers}


def test_saved_values_are_the_jax_policies():
    assert tbert.REMAT_SAVES["save_mlp"] == {"qkv", "attn_out", "attn_proj", "ffn1", "ffn2"}
    assert tbert.REMAT_SAVES["save_attn"] == {"qkv", "attn_out"}
    assert tbert.REMAT_SAVES["save_qkv"] == {"qkv"}
    assert not tbert.REMAT_SAVES["nothing"]
    assert tbert.REMAT_SAVES["dots"] == {"dots"}
