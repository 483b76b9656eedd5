"""Port parity: the seq-axis ops (ops/{ring_attention,ulysses,shard_map_compat}.py).

Ring attention and Ulysses go through both packages on a 4-shard ``seq``
mesh in f32 (the JAX side on tests/conftest.py's virtual CPU devices, the
port's on ``["cpu"] * 4``), at tests/test_longcontext.py's shapes and
bounds: outputs within 2e-5, gradients within 1e-4.  The port's
collectives are held against ``jax.lax``'s inside a JAX ``shard_map``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as JP

from kubeflow_tpu.ops.ring_attention import ring_attention as jring
from kubeflow_tpu.ops.shard_map_compat import shard_map as jshard_map
from kubeflow_tpu.ops.ulysses import ulysses_attention as julysses
from kubeflow_tpu.parallel import mesh as jmesh
from kubeflow_tpu.parallel import presets as jpresets
from kubeflow_tpu_torch.ops import shard_map_compat as smc
from kubeflow_tpu_torch.ops.attention import multihead_attention
from kubeflow_tpu_torch.ops.flash_attention import flash_attention
from kubeflow_tpu_torch.ops.ring_attention import ring_attention
from kubeflow_tpu_torch.ops.ulysses import ulysses_attention
from kubeflow_tpu_torch.parallel import mesh as tmesh
from kubeflow_tpu_torch.parallel import presets as tpresets
from kubeflow_tpu_torch.parallel.sharding import P

B, S, H, D = 2, 64, 4, 16
OUT_TOL, GRAD_TOL = 2e-5, 1e-4


@pytest.fixture(scope="module")
def qkv():
    rng = np.random.default_rng(0)
    return tuple(rng.standard_normal((B, S, H, D)).astype(np.float32) for _ in range(3))


@pytest.fixture(scope="module")
def meshes():
    return (jmesh.build_mesh(jmesh.MeshConfig(fsdp=1, seq=4), jax.devices()[:4]),
            tmesh.build_mesh(tmesh.MeshConfig(fsdp=1, seq=4), ["cpu"] * 4))


def _jax_out_and_grads(op, qkv, jm, causal):
    sh = NamedSharding(jm, JP(None, "seq", None, None))
    args = tuple(jax.device_put(x, sh) for x in qkv)

    def fwd(a, b, c):
        return op(a, b, c, jm, causal=causal)

    def loss(a, b, c):
        return jnp.sum(fwd(a, b, c) ** 2)

    out = jax.jit(fwd)(*args)
    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(*args)
    return np.asarray(out), [np.asarray(g) for g in grads]


def _port_out_and_grads(op, qkv, causal):
    args = [torch.from_numpy(x).requires_grad_() for x in qkv]
    out = op(*args, causal=causal)
    (out ** 2).sum().backward()
    return out.detach().numpy(), [a.grad.numpy() for a in args]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("op", ["ring", "ulysses"])
def test_matches_jax_outputs_and_grads(qkv, meshes, op, causal):
    jm, tm = meshes
    jop, top = (jring, ring_attention) if op == "ring" else (julysses, ulysses_attention)
    jout, jgrads = _jax_out_and_grads(jop, qkv, jm, causal)
    tout, tgrads = _port_out_and_grads(functools.partial(top, mesh=tm), qkv, causal)
    np.testing.assert_allclose(tout, jout, rtol=OUT_TOL, atol=OUT_TOL)
    for g, w in zip(tgrads, jgrads):
        np.testing.assert_allclose(g, w, rtol=GRAD_TOL, atol=GRAD_TOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("op", ["ring", "ulysses"])
def test_matches_dense_attention(qkv, meshes, op, causal):
    _, tm = meshes
    top = ring_attention if op == "ring" else ulysses_attention
    q, k, v = (torch.from_numpy(x) for x in qkv)
    ref = multihead_attention(q, k, v, causal=causal)
    np.testing.assert_allclose(top(q, k, v, tm, causal=causal).numpy(), ref.numpy(),
                               rtol=OUT_TOL, atol=OUT_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_with_the_flash_inner(qkv, meshes, causal):
    """``inner=flash_attention`` (its plain version on CPU tensors, one call
    per shard) against the JAX op with its dense inner."""
    jm, tm = meshes
    jout, jgrads = _jax_out_and_grads(julysses, qkv, jm, causal)
    fa = __import__("kubeflow_tpu_torch.ops.flash_attention", fromlist=["x"])
    calls = []
    plain = fa.flash_attention_plain

    def counting(*a, **kw):
        calls.append(a[0].shape)
        return plain(*a, **kw)

    fa.flash_attention_plain = counting
    try:
        tout, tgrads = _port_out_and_grads(
            functools.partial(ulysses_attention, mesh=tm, inner=flash_attention), qkv, causal)
    finally:
        fa.flash_attention_plain = plain
    # one forward per shard: its H/4 heads at full length
    assert calls == [(B * H // 4, S, D)] * 4
    np.testing.assert_allclose(tout, jout, rtol=OUT_TOL, atol=OUT_TOL)
    for g, w in zip(tgrads, jgrads):
        np.testing.assert_allclose(g, w, rtol=GRAD_TOL, atol=GRAD_TOL)


def test_ulysses_rejects_indivisible_heads(qkv):
    mesh = tmesh.build_mesh(tmesh.MeshConfig(fsdp=1, seq=8), ["cpu"] * 8)
    q, k, v = (torch.from_numpy(x) for x in qkv)  # H=4 < seq=8
    with pytest.raises(ValueError, match="heads") as got:
        ulysses_attention(q, k, v, mesh)
    jm = jmesh.build_mesh(jmesh.MeshConfig(fsdp=1, seq=8), jax.devices()[:8])
    with pytest.raises(ValueError) as want:
        julysses(*(jnp.asarray(x) for x in qkv), jm)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("name", ["ring-cp", "ulysses"])
def test_seq_presets_run_their_op(qkv, name):
    jp, tp = jpresets.get_preset(name, 4), tpresets.get_preset(name, 4)
    jm = jmesh.build_mesh(jp.mesh, jax.devices()[:4])
    tm = tmesh.build_mesh(tp.mesh, ["cpu"] * 4)
    sh = NamedSharding(jm, JP(None, "seq", None, None))
    want = jax.jit(lambda a, b, c: jp.attention(a, b, c, jm, causal=True))(
        *(jax.device_put(x, sh) for x in qkv))
    got = tp.attention(*(torch.from_numpy(x) for x in qkv), tm, causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=OUT_TOL, atol=OUT_TOL)


# ------------------------------------------------------------- collectives

COLLECTIVES = ["psum", "ppermute", "all_to_all_2_1", "all_to_all_1_2", "axis_index"]


def _jax_collective(name, x, jm):
    def body(xs):
        if name == "psum":
            return jax.lax.psum(xs, "seq")
        if name == "ppermute":
            return jax.lax.ppermute(xs, "seq", [(0, 2), (2, 1), (1, 0)])
        if name == "axis_index":
            return xs * 0 + jax.lax.axis_index("seq").astype(xs.dtype)
        split, concat = (2, 1) if name.endswith("2_1") else (1, 2)
        return jax.lax.all_to_all(xs, "seq", split_axis=split, concat_axis=concat, tiled=True)

    spec = JP(None, "seq", None, None)
    fn = jshard_map(body, mesh=jm, in_specs=(spec,), out_specs=spec, check_vma=False)
    return np.asarray(jax.jit(fn)(jax.device_put(x, NamedSharding(jm, spec))))


def _port_collective(name, x, tm):
    def body(xs):
        if name == "psum":
            return smc.psum(xs, "seq")
        if name == "ppermute":
            return smc.ppermute(xs, "seq", [(0, 2), (2, 1), (1, 0)])
        if name == "axis_index":
            return [t * 0 + i for t, i in zip(xs, smc.axis_index("seq"))]
        split, concat = (2, 1) if name.endswith("2_1") else (1, 2)
        return smc.all_to_all(xs, "seq", split_axis=split, concat_axis=concat, tiled=True)

    spec = P(None, "seq", None, None)
    return smc.shard_map(body, tm, in_specs=(spec,), out_specs=spec)(torch.from_numpy(x)).numpy()


@pytest.mark.parametrize("name", COLLECTIVES)
def test_collectives_match_jax_lax(qkv, meshes, name):
    jm, tm = meshes
    x = qkv[0]
    np.testing.assert_array_equal(_port_collective(name, x, tm),
                                  _jax_collective(name, x, jm))


def test_psum_over_two_axes_and_each_runs_once_per_distinct_argument():
    tm = tmesh.build_mesh(tmesh.MeshConfig(data=2, fsdp=2, tensor=2), ["cpu"] * 8)
    xs = [torch.tensor(float(p)) for p in range(tm.size)]
    with tm:
        out = smc.psum(xs, ("data", "fsdp"))
        idx = smc.axis_index(("data", "fsdp"))
        assert smc.psum(1, "tensor") == [2] * 8
    for pos in range(tm.size):
        t = tm.coords(pos)["tensor"]
        assert float(out[pos]) == sum(q for q in range(8) if tm.coords(q)["tensor"] == t)
        c = tm.coords(pos)
        assert idx[pos] == 2 * c["data"] + c["fsdp"]
    # the members of a group on one device share one result
    assert len({id(o) for o in out}) == 2
    calls = []
    shared = torch.ones(1)
    res = smc.each(lambda a, b: calls.append(b) or a + b, [shared] * 8, [0, 1] * 4)
    assert calls == [0, 1] and res[0] is res[2]
