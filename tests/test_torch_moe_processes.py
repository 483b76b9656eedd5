"""Port parity: expert parallelism and the composed MoE transformer on a
mesh across processes (ops/moe.py, models/moe_transformer.py,
graft_entry.py), on the CPU over ``gloo``.

- ``moe_ffn`` over ``expert=4`` on 2 processes of 2 positions (the expert
  axis spans processes) and over ``expert=2 x fsdp=2`` on 4 processes of
  one, at tests/test_torch_moe.py's "drops" and "sharded_matches_unsharded"
  cases (the weights from the JAX ``init_moe`` draws, in f32): against the
  JAX ``moe_ffn`` under this file's own ``jax.jit`` (output and gradients
  within 1e-4, aux within 1e-5, ``fraction_dropped`` equal) and against the
  port's one-controller mesh (within 1e-5).
- ``graft_entry.dryrun_multichip(8)`` on the job's global devices over 2
  processes of 4 positions and 4 of 2: both ``OK`` lines in every member,
  the composed step (stages 2 x seq 2 x expert 2) across processes; then
  that composed model in f32 on the JAX weights: loss and every gradient
  within 1e-5 of the one-process 8-shard port, the loss within 1e-4 of
  the JAX MoE transformer (tests/test_torch_moe_transformer.py's bound).

The members run in tests/test_torch_mesh_processes.py, which imports no
JAX; every gang has a timeout of its own and shares its result through a
module-scoped fixture."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import test_torch_mesh_processes as G
from kubeflow_tpu.models import moe_transformer as jmt
from kubeflow_tpu.ops import moe as jmoe
from kubeflow_tpu.parallel import mesh as jmesh
from kubeflow_tpu.parallel.sharding import shard_params as jshard_params
from kubeflow_tpu_torch import graft_entry as ge
from kubeflow_tpu_torch.parallel.mesh import MeshConfig, build_mesh

TOL, AUX_TOL, F32_TOL, COMPOSED_TOL = 1e-4, 1e-5, 1e-5, 1e-4
GANG_TIMEOUT_S = 180
# tests/test_torch_moe.py's cases: (config, x shape)
CASES = {"drops": (dict(num_experts=4, top_k=2, d_model=16, d_ff=32, capacity_factor=0.5),
                   (4, 16, 16)),
         "sharded_matches_unsharded": (dict(num_experts=8, top_k=2, d_model=16, d_ff=32,
                                            capacity_factor=2.0), (2, 32, 16))}
# name: (mesh sizes, positions a process, processes)
LAYOUTS = {"expert4_2x2": (dict(fsdp=1, expert=4), 2, 2),
           "expert2_fsdp2_4x1": (dict(fsdp=2, expert=2), 1, 4)}
COMPOSED_LAYOUTS = {"2x4": (4, 2), "4x2": (2, 4)}


def _inputs(name):
    kw, shape = CASES[name]
    params = jax.tree.map(lambda a: np.array(a, np.float32),
                          jmoe.init_moe(jax.random.PRNGKey(0), jmoe.MoEConfig(**kw)))
    return kw, params, np.random.default_rng(1).standard_normal(shape).astype(np.float32)


@pytest.fixture(scope="module")
def jax_moe():
    """Per case: JAX's output, aux and gradients of tests/test_torch_moe.py's loss."""
    refs = {}
    for name in CASES:
        kw, params, x = _inputs(name)
        cfg = jmoe.MoEConfig(**kw)

        def f(p, xx, cfg=cfg):
            out, aux = jmoe.moe_ffn(p, xx, cfg, shard=False)
            return (out ** 2).sum() + 0.01 * aux["load_balance_loss"] + \
                0.01 * aux["router_z_loss"], (out, aux)

        (_, (out, aux)), (g, gx) = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(
            jax.tree.map(jnp.asarray, params), jnp.asarray(x))
        refs[name] = (np.asarray(out), {k: float(v) for k, v in aux.items()},
                      jax.tree.map(np.asarray, g), np.asarray(gx))
    return refs


@pytest.fixture(scope="module")
def moe_gangs():
    out = {}
    for layout, (sizes, local, world) in LAYOUTS.items():
        for name in CASES:
            kw, params, x = _inputs(name)
            out[(layout, name)] = G.run_gang(G.moe_member, sizes, kw, params, x, world=world,
                                             local=local, timeout=GANG_TIMEOUT_S)
    return out


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_mesh_moe_across_processes_matches_jax_and_one_controller(jax_moe, moe_gangs, layout,
                                                                  name):
    sizes, local, world = LAYOUTS[layout]
    gang = moe_gangs[(layout, name)]
    w_out, w_aux, w_grads, w_gx = jax_moe[name]
    kw, params, x = _inputs(name)
    one = G.moe_run(build_mesh(MeshConfig(**sizes), ["cpu"] * (local * world)), kw, params, x)
    for rank, got in gang.items():
        assert got["local"] == list(range(rank * local, (rank + 1) * local))
        np.testing.assert_allclose(got["out"], w_out, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(got["out"], one["out"], rtol=F32_TOL, atol=F32_TOL)
        for k, v in got["aux"].items():
            assert abs(v - w_aux[k]) <= AUX_TOL and abs(v - one["aux"][k]) <= AUX_TOL, k
        assert got["aux"]["fraction_dropped"] == w_aux["fraction_dropped"]
    if name == "drops":
        assert gang[0]["aux"]["fraction_dropped"] > 0
    # each process's share of the gradients, summed over the gang
    grads = {k: sum(g["grads"][k] for g in gang.values()) for k in ("router", "wi", "wo")}
    gx = sum(g["x_grad"] for g in gang.values())
    for k, v in grads.items():
        np.testing.assert_allclose(v, w_grads[k], rtol=TOL, atol=TOL, err_msg=k)
        np.testing.assert_allclose(v, one["grads"][k], rtol=F32_TOL, atol=F32_TOL, err_msg=k)
    np.testing.assert_allclose(gx, w_gx, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(gx, one["x_grad"], rtol=F32_TOL, atol=F32_TOL)


# ------------------------------------------------------- the composed step


@pytest.fixture(scope="module")
def composed_tree():
    cfg = {k: v for k, v in G.COMPOSED_CFG.items() if not k.startswith("pipeline")}
    return jax.tree.map(np.asarray, jmt.init(jax.random.PRNGKey(0),
                                             jmt.MoeTransformerConfig(**cfg)))


@pytest.fixture(scope="module")
def composed_gangs(composed_tree):
    return {name: G.run_gang(G.composed_member, composed_tree, world=world, local=local,
                             timeout=GANG_TIMEOUT_S)
            for name, (world, local) in COMPOSED_LAYOUTS.items()}


@pytest.fixture(scope="module")
def jax_composed_loss(composed_tree):
    cfg = jmt.MoeTransformerConfig(**G.COMPOSED_CFG, dtype=jnp.float32)
    mesh = jmesh.build_mesh(jmesh.MeshConfig(**G.COMPOSED_SIZES), jax.devices()[:8])
    sharded = jshard_params(jax.tree.map(jnp.asarray, composed_tree), mesh, jmt.SHARDING_RULES)
    with jax.set_mesh(mesh):
        return float(jax.jit(lambda p, t: jmt.lm_loss(p, cfg, t))(
            sharded, jnp.asarray(G.composed_tokens().numpy())))


@pytest.mark.parametrize("layout", sorted(COMPOSED_LAYOUTS))
def test_composed_step_across_processes(composed_tree, composed_gangs, jax_composed_loss,
                                        layout, capsys):
    gang = composed_gangs[layout]
    # the entry point over the job's global devices: both OK lines, the
    # composed mesh of 8, one loss over the gang, the one-process losses
    want_entry = ge.dryrun_multichip(8, ["cpu"] * 8)
    capsys.readouterr()
    for got in gang.values():
        assert any(x.startswith("dryrun_multichip OK: mesh=") for x in got["stdout"])
        assert any(x.startswith("dryrun_composed OK: mesh={'data': 1, 'stages': 2, 'fsdp': 1, "
                                "'seq': 2, 'expert': 2, 'tensor': 1}") for x in got["stdout"])
        assert got["entry"] == gang[0]["entry"]
        for k, v in want_entry.items():
            assert abs(got["entry"][k] - v) <= COMPOSED_TOL, (k, got["entry"], want_entry)
    # the composed model in f32: the one-process 8-shard port and JAX
    one = G.composed_grads(build_mesh(MeshConfig(**G.COMPOSED_SIZES), ["cpu"] * 8),
                           composed_tree)
    grads = G._summed_shares([g["grads"] for g in gang.values()])
    assert grads.keys() == one["grads"].keys()
    for k, v in grads.items():
        np.testing.assert_allclose(v, one["grads"][k], rtol=F32_TOL, atol=F32_TOL, err_msg=k)
    for got in gang.values():
        assert abs(got["loss"] - one["loss"]) <= F32_TOL
        assert abs(got["loss"] - jax_composed_loss) <= COMPOSED_TOL
