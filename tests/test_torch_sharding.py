"""Port parity: ``serving/engine/sharding.py``, the tensor-parallel layout.

The same numpy-seeded params (bf16, and the JAX package's int8 ``{"q",
"s"}`` tree) go through the JAX ``shard_params`` on the forced 8-device CPU
mesh and through the port's ``shard_params`` on a mesh of N shards on the
CPU: every port shard equals, bit for bit, the addressable shard that the
JAX package places on the matching mesh position, for TP 2 and 4.  The
port's split axes are the JAX ``PartitionSpec``s' ``tensor`` axes;
``validate_config`` and ``tensor_mesh`` raise the JAX messages; the pool is
allocated per shard; snapshot and scatter move each shard's own pages;
``all_reduce_sum`` sums in the partials' dtype and makes no copy where the
shards share a device; ``shard_lora`` splits B's columns for the
column-parallel targets and A's rows for the row-parallel ones."""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from kubeflow_tpu.serving.engine import model as JM
from kubeflow_tpu.serving.engine import sharding as JS
from kubeflow_tpu_torch.serving.engine import model as TM
from kubeflow_tpu_torch.serving.engine import sharding as TS

CFG_J = JM.DecoderConfig(vocab_size=64, d_model=32, n_layers=2, n_heads=8,
                         n_kv_heads=4, d_ff=64)
CFG_T = TM.DecoderConfig(**dataclasses.asdict(CFG_J))


def _np_params(seed=0) -> dict:
    """bf16 params of CFG's shapes from numpy draws (ml_dtypes bf16)."""
    rng = np.random.default_rng(seed)
    c, hd, n = CFG_J, CFG_J.head_dim, CFG_J.n_layers
    shapes = {"embed": (c.vocab_size, c.d_model), "wq": (n, c.d_model, c.n_heads * hd),
              "wk": (n, c.d_model, c.n_kv_heads * hd), "wv": (n, c.d_model, c.n_kv_heads * hd),
              "wo": (n, c.n_heads * hd, c.d_model), "w1": (n, c.d_model, c.d_ff),
              "w3": (n, c.d_model, c.d_ff), "w2": (n, c.d_ff, c.d_model),
              "ln_attn": (n, c.d_model), "ln_mlp": (n, c.d_model), "ln_out": (c.d_model,),
              "unembed": (c.d_model, c.vocab_size)}
    return {k: (rng.standard_normal(s) * 0.2).astype(ml_dtypes.bfloat16)
            for k, s in shapes.items()}


def _bits(x) -> np.ndarray:
    """Bit patterns of a JAX array's or a torch tensor's data, for a bitwise
    comparison whatever the dtype."""
    if isinstance(x, torch.Tensor):
        t = x.cpu()
        return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype == ml_dtypes.bfloat16 else a


def _jax_shard(arr, device):
    return next(s.data for s in arr.addressable_shards if s.device == device)


@pytest.mark.parametrize("quant", [None, "int8"])
@pytest.mark.parametrize("tp", [2, 4])
def test_each_port_shard_is_the_jax_shard(tp, quant):
    np_params = _np_params()
    if quant:
        jparams = JM.quantize_weights_int8({k: jnp.asarray(v) for k, v in np_params.items()})
        np_params = jax.tree.map(np.asarray, jparams)
    mesh = JS.tensor_mesh(tp)
    jsh = JS.shard_params(np_params, mesh)
    tsh = TS.shard_params(TM.params_from_jax(np_params, "cpu"), TS.tensor_mesh(tp, ["cpu"] * tp))
    assert len(tsh) == tp
    for name, jleaf in jsh.items():
        parts = jleaf if isinstance(jleaf, dict) else {"": jleaf}
        for part, arr in parts.items():
            for i, dev in enumerate(mesh.devices.flat):
                t = tsh[i][name][part] if part else tsh[i][name]
                want = _jax_shard(arr, dev)
                assert tuple(t.shape) == tuple(want.shape), (name, part, i)
                np.testing.assert_array_equal(_bits(t), _bits(want), err_msg=f"{name}{part}[{i}]")


def test_split_axes_are_the_jax_partition_specs():
    for name, spec in JS.PARAM_SPECS.items():
        axes = [i for i, ax in enumerate(spec) if ax == "tensor"]
        assert TS.PARAM_SPECS[name] == (axes[0] if axes else None), name
    assert TS.POOL_SPEC == list(JS.POOL_SPEC).index("tensor")
    # the int8 scale rule: the singleton contraction axis stays whole
    for name in ("wq", "wo", "w2", "w1"):
        jspec, tspec = JS.PARAM_SPECS[name], TS.PARAM_SPECS[name]
        s_shape = (2, 1, 64)
        j = list(JS._scale_spec(jspec, s_shape))
        assert TS._scale_spec(tspec, s_shape) == (j.index("tensor") if "tensor" in j else None)


@pytest.mark.parametrize("case", ["heads", "d_ff"])
def test_validate_config_messages_match(case):
    cfg = dataclasses.asdict(CFG_J)
    tp = 3
    if case == "d_ff":
        cfg.update(n_heads=4, n_kv_heads=4, d_ff=66)
        tp = 4
    with pytest.raises(ValueError) as ref:
        JS.validate_config(JM.DecoderConfig(**cfg), JS.tensor_mesh(tp))
    with pytest.raises(ValueError) as port:
        TS.validate_config(TM.DecoderConfig(**cfg), TS.tensor_mesh(tp, ["cpu"] * tp))
    assert str(port.value) == str(ref.value)


def test_tensor_mesh_refuses_fewer_cards_with_the_jax_message(monkeypatch):
    have = len(jax.devices())
    with pytest.raises(ValueError) as ref:
        JS.tensor_mesh(have + 8)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: have)
    with pytest.raises(ValueError) as port:
        TS.tensor_mesh(have + 8)
    assert str(port.value) == str(ref.value)
    # an explicit list may repeat a device: N shards on the CPU
    mesh = TS.tensor_mesh(4, ["cpu"] * 4)
    assert mesh.shape == {"tensor": 4} and mesh.distinct_devices == [torch.device("cpu")]
    with pytest.raises(ValueError, match="one device per shard"):
        TS.tensor_mesh(2, ["cpu"])


@pytest.mark.parametrize("quant", [None, "int8"])
def test_pool_is_allocated_per_shard_and_moves_shard_by_shard(quant):
    mesh = TS.tensor_mesh(4, ["cpu"] * 4)
    shape = (2, 10, 8, 4, 16)  # [L, P, Hkv, page, hd]
    pools = TS.alloc_pool(shape, mesh, quant=quant)
    assert len(pools) == 4
    leaf = (lambda p: p["q"]) if quant else (lambda p: p)
    assert all(tuple(leaf(p).shape) == (2, 10, 2, 4, 16) for p in pools)
    # a full pool's pages written shard by shard read back as their own heads
    rng = np.random.default_rng(1)
    full = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(torch.bfloat16)
    shards = [full[:, :, 2 * i:2 * i + 2].contiguous() for i in range(4)]
    pages = np.array([3, 7, 1])
    host = TS.snapshot_shards(shards, pages)
    assert [h.shape for h in host] == [(2, 3, 2, 4, 16)] * 4
    target = TS.alloc_pool(shape, mesh)
    TS.scatter_shards(target, pages, host)
    for i in range(4):
        assert torch.equal(target[i][:, pages], shards[i][:, pages])
        assert torch.count_nonzero(target[i][:, [0, 2, 4, 5, 6, 8, 9]]) == 0


def test_all_reduce_sum_dtype_flow_and_no_copy_on_one_device():
    mesh = TS.tensor_mesh(2, ["cpu"] * 2)
    rng = np.random.default_rng(2)
    a, b = (torch.from_numpy(rng.standard_normal((3, 5)).astype(np.float32)).to(torch.bfloat16)
            for _ in range(2))
    out = TS.all_reduce_sum([a, b], mesh)
    assert len(out) == 2 and out[0] is out[1]  # one device: one result tensor
    assert out[0].dtype == torch.bfloat16 and torch.equal(out[0], a + b)
    assert TS.all_reduce_sum([a], None) == [a]


def test_shard_lora_splits_b_columns_and_a_rows():
    rng = np.random.default_rng(3)
    table = {"wq": {"A": rng.standard_normal((3, 2, 32, 4)), "B": rng.standard_normal((3, 2, 4, 64))},
             "wo": {"A": rng.standard_normal((3, 2, 64, 4)), "B": rng.standard_normal((3, 2, 4, 32))}}
    table = {k: {f: torch.from_numpy(v) for f, v in d.items()} for k, d in table.items()}
    shards = TS.shard_lora(table, TS.tensor_mesh(2, ["cpu"] * 2))
    for i, sh in enumerate(shards):
        assert torch.equal(sh["wq"]["A"], table["wq"]["A"])
        assert torch.equal(sh["wq"]["B"], table["wq"]["B"][..., 32 * i:32 * (i + 1)])
        assert torch.equal(sh["wo"]["A"], table["wo"]["A"][:, :, 32 * i:32 * (i + 1)])
        assert torch.equal(sh["wo"]["B"], table["wo"]["B"])
