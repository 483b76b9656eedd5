"""Port parity: the MoE FFN (ops/moe.py).

``moe_ffn`` against the JAX op in f32 at the four shapes of
tests/test_longcontext.py's MoE tests (routing, capacity drops, aux values,
gradients), the weights from one numpy tree (the JAX ``init_moe`` draws,
in f32), the JAX side through a ``jax.jit`` of this file's own, computed
once per module.  Outputs and gradients within 1e-4, the aux values within
1e-5 and ``fraction_dropped`` equal.  Then the expert-sharded op on
``["cpu"] * n`` meshes against the unsharded one and against JAX,
including a batch × seq split that drops tokens: capacity is global, so
the split drops exactly the tokens the unsharded op drops."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.ops import moe as jmoe
from kubeflow_tpu_torch.ops import moe as tmoe
from kubeflow_tpu_torch.parallel.mesh import MeshConfig, build_mesh
from kubeflow_tpu_torch.parallel.sharding import P, ShardedTensor

TOL, AUX_TOL = 1e-4, 1e-5
AUX_KEYS = ("load_balance_loss", "router_z_loss", "fraction_dropped")
# name: (config, x shape, x kind), as tests/test_longcontext.py's MoE tests
# draw them; "drops" adds a batch x seq shape that overflows its capacity
CASES = {
    "routes_and_balances": (dict(num_experts=4, top_k=2, d_model=32, d_ff=64,
                                 capacity_factor=2.0), (2, 16, 32), "normal"),
    "capacity_drops_overflow": (dict(num_experts=4, top_k=1, d_model=8, d_ff=16,
                                     capacity_factor=0.25), (1, 32, 8), "ones"),
    "sharded_matches_unsharded": (dict(num_experts=8, top_k=2, d_model=16, d_ff=32,
                                       capacity_factor=2.0), (2, 32, 16), "normal"),
    "grads_flow": (dict(num_experts=4, top_k=2, d_model=16, d_ff=32), (1, 8, 16), "normal"),
    "drops": (dict(num_experts=4, top_k=2, d_model=16, d_ff=32, capacity_factor=0.5),
              (4, 16, 16), "normal"),
}


def _inputs(name):
    kw, shape, kind = CASES[name]
    params = jax.tree.map(lambda a: np.array(a, np.float32),
                          jmoe.init_moe(jax.random.PRNGKey(0), jmoe.MoEConfig(**kw)))
    rng = np.random.default_rng(1)
    x = (np.ones(shape, np.float32) if kind == "ones"
         else rng.standard_normal(shape).astype(np.float32))
    return kw, params, x


def _loss(out, aux):
    return (out ** 2).sum() + 0.01 * aux["load_balance_loss"] + 0.01 * aux["router_z_loss"]


@pytest.fixture(scope="module")
def jax_ref():
    """Per case: JAX's output, aux and the gradients of ``_loss``."""
    refs = {}
    for name in CASES:
        kw, params, x = _inputs(name)
        cfg = jmoe.MoEConfig(**kw)

        def f(p, xx, cfg=cfg):
            out, aux = jmoe.moe_ffn(p, xx, cfg, shard=False)
            return (out ** 2).sum() + 0.01 * aux["load_balance_loss"] + \
                0.01 * aux["router_z_loss"], (out, aux)

        (_, (out, aux)), grads = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(
            jax.tree.map(jnp.asarray, params), jnp.asarray(x))
        refs[name] = (np.asarray(out), {k: float(v) for k, v in aux.items()},
                      jax.tree.map(np.asarray, grads))
    return refs


def _port(name, sizes=None):
    kw, params, x = _inputs(name)
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in params.items()}
    tx = torch.from_numpy(x).requires_grad_()
    cfg = tmoe.MoEConfig(**kw)
    if sizes is None:
        out, aux = tmoe.moe_ffn(tp, tx, cfg, shard=False)
    else:
        n = int(np.prod(list(sizes.values())))
        with build_mesh(MeshConfig(**sizes), ["cpu"] * n):
            out, aux = tmoe.moe_ffn(tp, tx, cfg)
    grads = torch.autograd.grad(_loss(out, aux), [tp["router"], tp["wi"], tp["wo"], tx])
    return (out.detach().numpy(), {k: float(v.detach()) for k, v in aux.items()},
            dict(zip(("router", "wi", "wo", "x"), (g.numpy() for g in grads))))


def _check(got, want):
    out, aux, grads = got
    w_out, w_aux, (w_params, w_x) = want
    np.testing.assert_allclose(out, w_out, rtol=TOL, atol=TOL)
    for k in AUX_KEYS:
        assert abs(aux[k] - w_aux[k]) <= AUX_TOL, (k, aux[k], w_aux[k])
    assert aux["fraction_dropped"] == pytest.approx(w_aux["fraction_dropped"], abs=0)
    for k in ("router", "wi", "wo"):
        np.testing.assert_allclose(grads[k], w_params[k], rtol=TOL, atol=TOL, err_msg=k)
    np.testing.assert_allclose(grads["x"], w_x, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_moe_ffn_matches_jax(jax_ref, name):
    got = _port(name)
    _check(got, jax_ref[name])
    if name == "capacity_drops_overflow":
        assert got[1]["fraction_dropped"] > 0.5
    if name == "routes_and_balances":
        assert got[1]["fraction_dropped"] == 0.0
        assert got[1]["load_balance_loss"] >= 1.0 - 1e-5


SHARDED = {"expert2": dict(fsdp=1, expert=2), "expert4": dict(fsdp=1, expert=4),
           "batch2_seq2_expert2": dict(fsdp=2, seq=2, expert=2),
           "data2_seq2_expert2_tensor2": dict(data=2, fsdp=1, seq=2, expert=2, tensor=2)}


@pytest.mark.parametrize("mesh", sorted(SHARDED))
@pytest.mark.parametrize("name", ["drops", "sharded_matches_unsharded"])
def test_sharded_moe_matches_unsharded_and_jax(jax_ref, name, mesh):
    got = _port(name, SHARDED[mesh])
    _check(got, jax_ref[name])
    one = _port(name)
    np.testing.assert_allclose(got[0], one[0], rtol=1e-5, atol=1e-6)
    assert got[1] == pytest.approx(one[1], abs=AUX_TOL)
    if name == "drops":
        assert got[1]["fraction_dropped"] > 0


def test_global_capacity_is_what_passes_under_a_batch_seq_split(jax_ref):
    """Each of the four batch × seq shards routed alone, with its own
    capacity and slots, drops other tokens than the whole call: the split's
    agreement with the unsharded op is the global prefix's doing."""
    kw, params, x = _inputs("drops")
    cfg = tmoe.MoEConfig(**kw)
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    local = np.concatenate([np.concatenate(
        [tmoe.moe_ffn(tp, torch.from_numpy(x[i:i + 2, j:j + 8]), cfg, shard=False)[0].numpy()
         for j in (0, 8)], axis=1) for i in (0, 2)], axis=0)
    want = jax_ref["drops"][0]
    assert np.abs(local - want).max() > 1e-2
    got = _port("drops", SHARDED["batch2_seq2_expert2"])[0]
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_sharded_moe_keeps_a_sharded_input_layout():
    kw, params, x = _inputs("drops")
    cfg = tmoe.MoEConfig(**kw)
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    mesh = build_mesh(MeshConfig(fsdp=2, seq=2, expert=2), ["cpu"] * 8)
    xs = ShardedTensor.shard(torch.from_numpy(x), mesh, P(("data", "fsdp"), "seq", None))
    with mesh:
        out, _ = tmoe.moe_ffn(tp, xs, cfg)
    assert isinstance(out, ShardedTensor) and out.spec == xs.spec
    assert [tuple(t.shape) for t in out.shards] == [(2, 8, 16)] * 8
    want, _ = tmoe.moe_ffn(tp, torch.from_numpy(x), cfg, shard=False)
    np.testing.assert_allclose(out.gather().numpy(), want.numpy(), rtol=1e-5, atol=1e-6)


def test_config_init_and_params_from_jax():
    assert dataclasses.asdict(tmoe.MoEConfig()) == dataclasses.asdict(jmoe.MoEConfig())
    cfg = tmoe.MoEConfig(num_experts=4, d_model=16, d_ff=32)
    a, b = tmoe.init_moe(cfg, "cpu", seed=3), tmoe.init_moe(cfg, "cpu", seed=3)
    assert {k: (tuple(v.shape), v.dtype) for k, v in a.items()} == {
        "router": ((16, 4), torch.float32), "wi": ((4, 16, 32), torch.bfloat16),
        "wo": ((4, 32, 16), torch.bfloat16)}
    assert all(torch.equal(a[k], b[k]) for k in a)
    jp = jmoe.init_moe(jax.random.PRNGKey(0), jmoe.MoEConfig(**dataclasses.asdict(cfg)))
    tp = tmoe.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    assert tp["wi"].dtype == torch.bfloat16
    for k in jp:
        np.testing.assert_array_equal(tp[k].float().numpy(), np.asarray(jp[k], np.float32))
    assert tmoe.capacity(tmoe.MoEConfig(), 8 * 1024) == 2560
