"""Port parity: the mesh layer (parallel/{mesh,sharding,presets}.py).

``MeshConfig`` and ``build_mesh`` (fills and errors), the path rules'
specs, ``sanitize_spec``, every BERT leaf's shard shape and the presets go
through both packages; the JAX side runs on the 8 virtual CPU devices of
tests/conftest.py, the port's meshes on ``["cpu"] * n``."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding as JNamedSharding
from jax.sharding import PartitionSpec as JP

from kubeflow_tpu.models import bert as jbert
from kubeflow_tpu.parallel import mesh as jmesh
from kubeflow_tpu.parallel import presets as jpresets
from kubeflow_tpu.parallel import sharding as jsharding
from kubeflow_tpu_torch.models import bert as tbert
from kubeflow_tpu_torch.parallel import mesh as tmesh
from kubeflow_tpu_torch.parallel import presets as tpresets
from kubeflow_tpu_torch.parallel import sharding as tsharding
from kubeflow_tpu_torch.parallel.sharding import P, ShardedTensor

TINY = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
            intermediate_size=128, max_position=64)


def _outcome(fn):
    try:
        return ("ok", fn())
    except ValueError as e:
        return ("ValueError", str(e))


SIZE_CASES = [
    (dict(), 8), (dict(data=2, fsdp=-1, tensor=2), 8), (dict(data=3, fsdp=-1), 8),
    (dict(fsdp=-1, tensor=-1), 8), (dict(data=2, fsdp=2, tensor=2), 8),
    (dict(data=2, fsdp=2, tensor=2), 4), (dict(fsdp=1, seq=4), 4),
    (dict(stages=2, fsdp=-1, expert=2), 8), (dict(fsdp=-1), 1),
]


@pytest.mark.parametrize("kw,n", SIZE_CASES, ids=range(len(SIZE_CASES)))
def test_mesh_config_sizes_match_jax(kw, n):
    assert tmesh.AXES == jmesh.AXES
    assert (_outcome(lambda: tmesh.MeshConfig(**kw).sizes(n))
            == _outcome(lambda: jmesh.MeshConfig(**kw).sizes(n)))


@pytest.mark.parametrize("kw,n", SIZE_CASES, ids=range(len(SIZE_CASES)))
def test_build_mesh_matches_jax(kw, n):
    def shape(m):
        return dict(zip(m.axis_names, m.devices.shape)), m.devices.size

    got = _outcome(lambda: shape(tmesh.build_mesh(tmesh.MeshConfig(**kw), ["cpu"] * n)))
    want = _outcome(lambda: shape(jmesh.build_mesh(jmesh.MeshConfig(**kw),
                                                   jax.devices()[:n])))
    assert got == want
    if got[0] == "ok":
        m = tmesh.build_mesh(tmesh.MeshConfig(**kw), ["cpu"] * n)
        assert m.shape == got[1][0] and m.size == n
        assert m.distinct_devices == [torch.device("cpu")]
        assert all(m.position(m.coords(p)) == p for p in range(n))


def test_build_mesh_refuses_no_card_and_mixed_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no visible card"):
        tmesh.build_mesh()
    with pytest.raises(RuntimeError, match="no visible card"):
        tmesh.single_device_mesh()
    with pytest.raises(ValueError, match="mixed device types"):
        tmesh.Mesh(np.array([torch.device("cpu"), torch.device("meta")],
                            dtype=object).reshape(1, 1, 2, 1, 1, 1))


def test_single_device_mesh_and_the_current_mesh():
    one = tmesh.single_device_mesh("cpu")
    assert one.devices.shape == (1,) * len(tmesh.AXES) and one.size == 1
    two = tmesh.build_mesh(tmesh.MeshConfig(fsdp=2), ["cpu", "cpu"])
    assert tmesh.current_mesh() is None
    with one:
        assert tmesh.current_mesh() is one
        with two:
            assert tmesh.current_mesh() is two
        assert tmesh.current_mesh() is one
    assert tmesh.current_mesh() is None


def test_rules_and_pp_rules_match_jax():
    def plain(rules):
        return [(pat, tuple(spec)) for pat, spec in rules]

    assert plain(tbert.SHARDING_RULES) == plain(jbert.SHARDING_RULES)
    assert plain(tbert.pp_sharding_rules()) == plain(jbert.pp_sharding_rules())


@pytest.mark.parametrize("rules", ["bert", "pp"])
def test_tree_specs_match_jax(rules):
    jrules = jbert.SHARDING_RULES if rules == "bert" else jbert.pp_sharding_rules()
    trules = tbert.SHARDING_RULES if rules == "bert" else tbert.pp_sharding_rules()
    jtree = jax.eval_shape(lambda: jbert.init(jax.random.PRNGKey(0), jbert.BertConfig(**TINY)))
    want = jsharding.tree_specs(jtree, jrules)
    model = tbert.init(tbert.BertConfig(**TINY), "cpu")
    got = tsharding.tree_specs(model, trules)
    assert got.keys() == want.keys()
    for group in want:
        assert got[group].keys() == want[group].keys()
        for name, spec in want[group].items():
            assert tuple(got[group][name]) == tuple(spec), (group, name)
    # optimizer-state paths embed the param paths
    assert tuple(tsharding.spec_for("mu/layers/attn_qkv_kernel", trules, 5)) == tuple(
        jsharding.spec_for("1/0/mu/layers/attn_qkv_kernel", jrules, 5))


SANITIZE = [
    (("tensor", "fsdp"), (30522, 768)), (("tensor", "fsdp"), (2, 768)),
    ((None, "fsdp", None, "tensor", None), (12, 768, 3, 12, 64)),
    ((("data", "fsdp"),), (32, 512)), ((("data", "fsdp"),), (6, 512)),
    (("tensor",), (7,)), ((None, "tensor"), (4,)),
]


@pytest.mark.parametrize("sizes", [dict(data=1, fsdp=2, tensor=4), dict(data=2, fsdp=2, tensor=2)])
@pytest.mark.parametrize("spec,shape", SANITIZE, ids=range(len(SANITIZE)))
def test_sanitize_spec_matches_jax(sizes, spec, shape):
    jm = jmesh.build_mesh(jmesh.MeshConfig(**sizes), jax.devices()[:8])
    tm = tmesh.build_mesh(tmesh.MeshConfig(**sizes), ["cpu"] * 8)
    want = jsharding.sanitize_spec(JP(*spec), shape, jm)
    got = tsharding.sanitize_spec(P(*spec), shape, tm)
    assert tuple(got) == tuple(want)


@pytest.mark.parametrize("cfg", ["tiny", "base"])
@pytest.mark.parametrize("sizes", [dict(data=1, fsdp=2, tensor=4), dict(data=2, fsdp=2, tensor=2),
                                   dict(fsdp=8)])
def test_every_bert_leaf_shard_shape_matches_jax(cfg, sizes):
    conf = TINY if cfg == "tiny" else {}
    jm = jmesh.build_mesh(jmesh.MeshConfig(**sizes), jax.devices()[:8])
    tm = tmesh.build_mesh(tmesh.MeshConfig(**sizes), ["cpu"] * 8)
    jtree = jax.eval_shape(lambda: jbert.init(jax.random.PRNGKey(0), jbert.BertConfig(**conf)))
    jsh = jsharding.tree_shardings(jtree, jm, jbert.SHARDING_RULES)
    tsh = tsharding.tree_shardings(jtree, tm, tbert.SHARDING_RULES)
    for group in jtree:
        for name, leaf in jtree[group].items():
            want = jsh[group][name].shard_shape(leaf.shape)
            assert isinstance(jsh[group][name], JNamedSharding)
            assert tsh[group][name].shard_shape(leaf.shape) == want, (group, name)


@pytest.mark.parametrize("sizes", [dict(data=1, fsdp=2, tensor=4), dict(data=2, fsdp=2, tensor=2)])
def test_shard_params_local_shapes_and_bytes(sizes):
    """Every position's local slice has its rule's shard shape; positions
    that share a device and a slice share one tensor, so one device holds
    each distinct slice once."""
    tm = tmesh.build_mesh(tmesh.MeshConfig(**sizes), ["cpu"] * 8)
    model = tbert.init(tbert.BertConfig(**TINY), "cpu")
    placed = tsharding.shard_params(model, tm, tbert.SHARDING_RULES)
    for group, leaves in placed.items():
        for name, st in leaves.items():
            full = model[group][name]
            shape = st.sharding.shard_shape(tuple(full.shape))
            assert all(tuple(t.shape) == shape for t in st.shards), (group, name)
            # one device: one tensor per distinct slice, however many
            # positions hold it
            assert len(st.locals) == len({st.block(p) for p in range(tm.size)})
            assert torch.equal(st.gather(), full.detach())
            assert all(t.is_leaf and t.data_ptr() != full.data_ptr() for t in st.locals)


def test_view_gathers_and_its_backward_is_a_reduce_scatter():
    tm = tmesh.build_mesh(tmesh.MeshConfig(data=2, fsdp=2, tensor=2), ["cpu"] * 8)
    g = torch.arange(4 * 6 * 8, dtype=torch.float32).reshape(4, 6, 8)
    st = ShardedTensor.shard(g, tm, P(None, "fsdp", "tensor"), fresh=True)
    for t in st.locals:
        t.requires_grad_(True)
    views = tsharding.Views(tm)
    per_pos = views(st, keep=("tensor",), index=1)
    for pos, v in enumerate(per_pos):
        t = tm.coords(pos)["tensor"]
        assert torch.equal(v.detach(), g[1, :, t * 4:(t + 1) * 4])
    # the two data replicas of one device share the view
    assert len({id(v) for v in per_pos}) == 2
    # every position's use adds into the one local holding each slice
    loss = sum((v * (pos + 1)).sum() for pos, v in enumerate(per_pos))
    loss.backward()
    for pos in range(tm.size):
        local = st.shards[pos]
        f, t = tm.coords(pos)["fsdp"], tm.coords(pos)["tensor"]
        users = sum(q + 1 for q in range(tm.size) if tm.coords(q)["tensor"] == t)
        want = torch.zeros_like(local)
        want[1] = users
        assert torch.equal(local.grad, want), (f, t)
    st.assign_(g * 2)
    assert torch.equal(st.gather().detach(), g * 2)


PRESETS = ["dp", "data", "fsdp", "tp", "tensor", "ring-cp", "ring", "cp", "ulysses", "sp",
           "moe-ep", "ep", "expert", "pp", "pipeline", "nope"]


@pytest.mark.parametrize("name", PRESETS)
@pytest.mark.parametrize("n,tensor,stages", [(8, 1, 1), (8, 4, 4), (6, 1, 3), (3, 1, 1),
                                             (4, 3, 1), (8, 1, 3)])
def test_every_preset_matches_jax(name, n, tensor, stages):
    def resolve(mod):
        p = mod.get_preset(name, n, tensor=tensor, stages=stages)
        return p.name, p.mesh.sizes(n), p.attention.__name__

    assert _outcome(lambda: resolve(tpresets)) == _outcome(lambda: resolve(jpresets))


@pytest.mark.parametrize("env", [{}, {"TPU_PARALLELISM_PRESET": "tp"},
                                 {"TPU_PARALLELISM_PRESET": "tp", "TPU_TENSOR_PARALLEL": "4"},
                                 {"TPU_PARALLELISM_PRESET": "ulysses"},
                                 {"TPU_PARALLELISM_PRESET": "bogus"}])
def test_preset_from_env_matches_jax(env, monkeypatch):
    for k in ("TPU_PARALLELISM_PRESET", "TPU_TENSOR_PARALLEL"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)

    def resolve(mod):
        p = mod.preset_from_env(8)
        return p.name, p.mesh.sizes(8)

    assert _outcome(lambda: resolve(tpresets)) == _outcome(lambda: resolve(jpresets))


def test_parallel_package_exports_what_jax_exports():
    import kubeflow_tpu.parallel as jp
    import kubeflow_tpu_torch.parallel as tp

    for name in ("MeshConfig", "build_mesh", "Preset", "get_preset", "preset_from_env"):
        assert hasattr(jp, name) and getattr(tp, name) is not None
