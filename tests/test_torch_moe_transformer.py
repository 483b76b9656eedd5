"""Port parity: the composed MoE transformer (models/moe_transformer.py).

At tests/test_pipeline.py's composed sizes in f32, the weights from one
numpy tree: the port's loss on the composed mesh (stages 2 × seq 2 ×
expert 2 over ``["cpu"] * 8``, GPipe over the stages) against the JAX loss
on the same mesh of tests/conftest.py's virtual devices, within 1e-4, and
every leaf's gradient within 1e-4 relative.  Then a pp case with capacity
drops, where capacity is per microbatch, against JAX pp, beside the
unpipelined case (capacity over the whole batch) against JAX unpipelined;
and the seq split's causal offset.  Each JAX reference is computed once
per module through a ``jax.jit`` of this file's own."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.models import moe_transformer as jmt
from kubeflow_tpu.parallel import mesh as jmesh
from kubeflow_tpu.parallel.sharding import shard_params as jshard_params
from kubeflow_tpu_torch.models import moe_transformer as tmt
from kubeflow_tpu_torch.parallel.mesh import MeshConfig, build_mesh
from kubeflow_tpu_torch.parallel.sharding import ShardedTensor, shard_params
from kubeflow_tpu_torch.train.trainer import _flatten

BASE = dict(vocab_size=128, d_model=32, n_layers=2, n_heads=4, num_experts=2, top_k=1)
# no token dropped (tests/test_pipeline.py's case), and one that drops
CAPACITY = {"no_drops": 4.0, "drops": 0.5}
COMPOSED = dict(stages=2, fsdp=1, seq=2, expert=2)
TOL = 1e-4


def _rel(got, want) -> float:
    return float(np.linalg.norm(np.asarray(got) - np.asarray(want))
                 / max(np.linalg.norm(np.asarray(want)), 1e-30))


def _tokens():
    return np.random.default_rng(1).integers(0, 128, (4, 17)).astype(np.int32)


@pytest.fixture(scope="module")
def jax_ref():
    """Per capacity: the JAX loss and gradients, pipelined on the composed
    mesh and unpipelined with no mesh."""
    params = jmt.init(jax.random.PRNGKey(0), jmt.MoeTransformerConfig(**BASE))
    toks = jnp.asarray(_tokens())
    mesh = jmesh.build_mesh(jmesh.MeshConfig(**COMPOSED), jax.devices()[:8])
    sharded = jshard_params(params, mesh, jmt.SHARDING_RULES)
    out = {}
    for name, cf in CAPACITY.items():
        ref = jmt.MoeTransformerConfig(**BASE, capacity_factor=cf, dtype=jnp.float32)
        pp = jmt.MoeTransformerConfig(**BASE, capacity_factor=cf, dtype=jnp.float32,
                                      pipeline_stages=2, pipeline_microbatches=2)
        with jax.set_mesh(mesh):
            loss_pp, g_pp = jax.jit(jax.value_and_grad(
                lambda p, t, pp=pp: jmt.lm_loss(p, pp, t)))(sharded, toks)
        loss_ref, g_ref = jax.jit(jax.value_and_grad(
            lambda p, t, ref=ref: jmt.lm_loss(p, ref, t)))(params, toks)
        out[name] = {"pp": (float(loss_pp), jax.tree.map(np.asarray, g_pp)),
                     "ref": (float(loss_ref), jax.tree.map(np.asarray, g_ref))}
    return jax.tree.map(np.asarray, params), out


def _config(cf, pp):
    kw = dict(pipeline_stages=2, pipeline_microbatches=2) if pp else {}
    return tmt.MoeTransformerConfig(**BASE, capacity_factor=cf, dtype=torch.float32, **kw)


def _port(np_tree, config, sizes=None):
    """(loss, {dotted name: global gradient}) on one device or on a mesh
    of ``sizes`` over ``["cpu"] * n``."""
    model = tmt.params_from_jax(np_tree, "cpu")
    toks = torch.from_numpy(_tokens())
    if sizes is None:
        loss = tmt.lm_loss(model, config, toks)
        names = [n for n, _ in model.named_parameters()]
        return float(loss.detach()), dict(zip(names, (g.numpy() for g in torch.autograd.grad(
            loss, list(model.parameters())))))
    n = int(np.prod(list(sizes.values())))
    mesh = build_mesh(MeshConfig(**sizes), ["cpu"] * n)
    flat = _flatten(shard_params(model, mesh, tmt.SHARDING_RULES))
    tree = {}
    for name, st in flat.items():
        for t in st.locals:
            t.requires_grad_(True)
        *groups, leaf = name.split(".")
        node = tree
        for g in groups:
            node = node.setdefault(g, {})
        node[leaf] = st
    with mesh:
        loss = tmt.lm_loss(tree, config, toks)
    loss.backward()
    return float(loss.detach()), {n: st.like([t.grad for t in st.shards]).gather().numpy()
                                  for n, st in flat.items()}


def _jax_grad(grads, name):
    node = grads
    for k in name.split("."):
        node = node[k]
    return node


def _check(got, want):
    loss, grads = got
    w_loss, w_grads = want
    assert abs(loss - w_loss) <= TOL, (loss, w_loss)
    for name, g in grads.items():
        assert _rel(g, _jax_grad(w_grads, name)) <= TOL, name


@pytest.mark.parametrize("sizes", [COMPOSED, dict(COMPOSED, tensor=2)],
                         ids=["stages2_seq2_expert2", "stages2_seq2_expert2_tensor2"])
def test_composed_mesh_matches_jax(jax_ref, sizes):
    np_tree, ref = jax_ref
    _check(_port(np_tree, _config(4.0, True), sizes), ref["no_drops"]["pp"])
    # nothing dropped: the pipelined loss is also the unpipelined one
    assert abs(ref["no_drops"]["pp"][0] - ref["no_drops"]["ref"][0]) <= TOL


@pytest.mark.parametrize("name", sorted(CAPACITY))
def test_unsharded_matches_jax(jax_ref, name):
    np_tree, ref = jax_ref
    _check(_port(np_tree, _config(CAPACITY[name], False)), ref[name]["ref"])


@pytest.mark.parametrize("on_mesh", [True, False], ids=["composed_mesh", "one_device"])
def test_pp_with_drops_counts_capacity_per_microbatch_as_jax(jax_ref, on_mesh):
    np_tree, ref = jax_ref
    got = _port(np_tree, _config(0.5, True), COMPOSED if on_mesh else None)
    _check(got, ref["drops"]["pp"])
    # capacity per microbatch differs from capacity over the batch here
    assert abs(ref["drops"]["pp"][0] - ref["drops"]["ref"][0]) > 1e-3


def test_seq_shards_offset_the_causal_mask():
    """A seq split's forward against the unsharded one: each seq shard's
    queries see the keys up to their global position.  Masking from index
    0 in each shard (a plain causal mask on the local queries) would let
    the second shard's first query see only the first key."""
    config = _config(4.0, False)
    model = tmt.init(config, "cpu", seed=0)
    toks = torch.from_numpy(_tokens()[:, :16])
    want = tmt.forward(model, config, toks)
    mesh = build_mesh(MeshConfig(fsdp=1, seq=2), ["cpu"] * 2)
    with mesh:
        got = tmt.forward(model, config, toks)
    assert isinstance(got, ShardedTensor) and tuple(got.spec)[1] == "seq"
    assert [tuple(t.shape) for t in got.shards] == [(4, 8, 128)] * 2
    torch.testing.assert_close(got.gather(), want, rtol=1e-5, atol=1e-5)
    # the second half alone, masked from its own index 0, is another answer
    half = tmt.forward(model, config, toks[:, 8:])
    assert (half - want[:, 8:]).abs().max() > 1e-3


def test_init_and_params_from_jax(jax_ref):
    np_tree, _ = jax_ref
    model = tmt.params_from_jax(np_tree, "cpu")
    names = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert names == {n: tuple(_jax_grad(np_tree, n).shape) for n in names}
    assert len(names) == 10 and model["layers"]["wqkv"].shape == (2, 32, 3, 4, 8)
    config = tmt.MoeTransformerConfig(**BASE)
    a, b = tmt.init(config, "cpu", seed=3), tmt.init(config, "cpu", seed=3)
    assert {n: tuple(p.shape) for n, p in a.named_parameters()} == names
    assert all(torch.equal(p, q) for p, q in zip(a.parameters(), b.parameters()))
    assert [r[0] for r in tmt.SHARDING_RULES] == [r[0] for r in jmt.SHARDING_RULES]
    assert [tuple(r[1]) for r in tmt.SHARDING_RULES] == [tuple(r[1]) for r in jmt.SHARDING_RULES]
