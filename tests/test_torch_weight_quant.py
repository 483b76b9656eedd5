"""Port parity: int8 weights (``EngineConfig.weight_quant="int8"``).

``quantize_weights_int8`` of kubeflow_tpu_torch against the JAX package's on
the same bf16 weights: the int8 payload and the bf16 scales are the same
bytes, per output channel for the matmuls and per row for ``embed``, at
column chunks that do and do not divide the widths.  ``forward_full`` on the
quantized weights stays within 5e-2 of the JAX package's; the int8 tree
takes under 0.6x the bf16 bytes; ``params_from_jax`` carries a quantized
tree bit for bit; an int8 engine's tokens pass the tie-aware greedy oracle
of the JAX ``forward_full`` on the quantized weights at both pipeline
depths and on the paged and gather paths, byte-identical to the JAX int8
engine where the oracle's top-2 gap is clear; ``engine.json``'s
``weight_quant`` builds an int8 engine, and a bad value raises the JAX
package's message.  ``init_int8`` gives the same tree shapes and dtypes as
quantizing ``init``."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.serving.engine import Engine as JEngine
from kubeflow_tpu.serving.engine import EngineConfig as JEngineConfig
from kubeflow_tpu.serving.engine import model as JM
from kubeflow_tpu_torch.serving.engine import engine as E
from kubeflow_tpu_torch.serving.engine import model as TM
from kubeflow_tpu_torch.serving.engine.serve import JetStreamModel

CFG_J = JM.DecoderConfig(vocab_size=101, d_model=64, n_layers=2, n_heads=4,
                         n_kv_heads=2, d_ff=96)
CFG_T = TM.DecoderConfig(**{f: getattr(CFG_J, f) for f in TM.DecoderConfig.__dataclass_fields__})
GEO = dict(max_slots=4, num_pages=64, page_size=8, max_pages_per_slot=12)
PROMPTS = [[(i * 7 + 3) % 100 + 1 for i in range(n)] for n in (5, 13, 21, 40)]
N_NEW = 12
LOGIT_TOL = 5e-2
TIE_EPS = 5e-2
STABLE_GAP = 0.07
ORACLE_LEN = 64

_forward = jax.jit(lambda p, t: JM.forward_full(p, CFG_J, t))


@pytest.fixture(scope="module")
def params():
    """(JAX bf16 params, their numpy leaves, JAX int8 tree)."""
    jp = JM.init(jax.random.PRNGKey(0), CFG_J)
    npp = {k: np.asarray(v) for k, v in jp.items()}
    jq = JM.quantize_weights_int8(npp)
    return jp, npp, jq


def _jq_device(jq):
    return jax.tree.map(jnp.asarray, jq)


def _bits(t: torch.Tensor) -> np.ndarray:
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


@pytest.mark.parametrize("col_chunk", [2048, 40, 7])
def test_quantized_bytes_equal_the_jax_packages(params, col_chunk):
    _, npp, _ = params
    jq = JM.quantize_weights_int8(npp, col_chunk=col_chunk)
    tq = TM.quantize_weights_int8(TM.params_from_jax(npp, "cpu"), col_chunk=col_chunk)
    assert set(tq) == set(jq)
    for name, ref in jq.items():
        got = tq[name]
        if not isinstance(ref, dict):
            assert not isinstance(got, dict)
            assert np.array_equal(_bits(got), np.asarray(ref).view(np.int16)), name
            continue
        assert got["q"].dtype == torch.int8 and got["s"].dtype == torch.bfloat16
        assert got["q"].shape == ref["q"].shape and got["s"].shape == ref["s"].shape, name
        assert np.array_equal(got["q"].numpy(), ref["q"]), name
        assert np.array_equal(_bits(got["s"]), ref["s"].view(np.int16)), name
    # per row for the embedding table, per output channel for the matmuls
    assert tq["embed"]["s"].shape == (CFG_J.vocab_size, 1)
    assert tq["wq"]["s"].shape == (CFG_J.n_layers, 1, CFG_J.n_heads * CFG_J.head_dim)
    assert tq["unembed"]["s"].shape == (1, CFG_J.vocab_size)


def test_params_from_jax_carries_an_int8_tree_bit_for_bit(params):
    _, _, jq = params
    tq = TM.params_from_jax(jq, "cpu")
    for name, ref in jq.items():
        if isinstance(ref, dict):
            assert np.array_equal(tq[name]["q"].numpy(), ref["q"])
            assert np.array_equal(_bits(tq[name]["s"]), ref["s"].view(np.int16))


def test_forward_full_on_int8_weights_matches_jax(params):
    _, npp, jq = params
    tq = TM.quantize_weights_int8(TM.params_from_jax(npp, "cpu"))
    toks = np.random.default_rng(0).integers(0, CFG_J.vocab_size, (3, 17), dtype=np.int32)
    ref = np.asarray(_forward(_jq_device(jq), toks))
    with torch.inference_mode():
        got = TM.forward_full(tq, CFG_T, torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(got, ref, rtol=LOGIT_TOL, atol=LOGIT_TOL)
    # dequantization is what the JAX package computes: the int8 logits
    # differ from the bf16 ones, by the same amount in both packages
    dense = np.asarray(_forward(params[0], toks))
    assert np.abs(ref - dense).max() > 0
    with torch.inference_mode():
        tdense = TM.forward_full(TM.params_from_jax(npp, "cpu"), CFG_T,
                                 torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(got - tdense, ref - dense, atol=2 * LOGIT_TOL)


def test_int8_tree_is_under_0_6_of_the_bf16_bytes(params):
    _, npp, _ = params
    tp = TM.params_from_jax(npp, "cpu")
    ratio = TM.param_bytes(TM.quantize_weights_int8(tp)) / TM.param_bytes(tp)
    assert 0.5 < ratio < 0.6


def test_init_int8_matches_the_quantized_tree_layout(params):
    _, npp, _ = params
    want = TM.quantize_weights_int8(TM.params_from_jax(npp, "cpu"))
    got = TM.init_int8(CFG_T, "cpu", seed=3)
    assert set(got) == set(want)
    for name, ref in want.items():
        if isinstance(ref, dict):
            for k in ("q", "s"):
                assert got[name][k].shape == ref[k].shape and got[name][k].dtype == ref[k].dtype
            assert int(got[name]["q"].abs().max()) == 127  # each block spans the range
        else:
            assert got[name].shape == ref.shape and got[name].dtype == ref.dtype
    # a deterministic seed
    again = TM.init_int8(CFG_T, "cpu", seed=3)
    assert torch.equal(again["w1"]["q"], got["w1"]["q"])


def _oracle_rows(jq, prompt, got):
    toks = list(prompt) + list(got)
    padded = np.zeros((1, ORACLE_LEN), np.int32)
    padded[0, :len(toks)] = toks
    return np.asarray(_forward(_jq_device(jq), padded))[0, len(prompt) - 1:len(toks) - 1]


def _stable(rows, got) -> bool:
    """Every step's emitted token is the oracle's argmax with a clear top-2
    gap (a nearer tie may flip across frameworks)."""
    top2 = np.sort(rows, axis=-1)[:, -2:]
    return bool(((top2[:, 1] - top2[:, 0]) > STABLE_GAP).all()
                and all(int(r.argmax()) == g for r, g in zip(rows, got)))


@pytest.fixture(scope="module")
def jax_int8_runs(params):
    jp, _, _ = params
    eng = JEngine(jp, CFG_J, JEngineConfig(**GEO, weight_quant="int8"))
    eng.start()
    try:
        futs = [eng.generate_async(p, N_NEW) for p in PROMPTS]
        return [f.result(timeout=300)["tokens"] for f in futs]
    finally:
        eng.stop()


@pytest.mark.parametrize("depth", [1, 0])
@pytest.mark.parametrize("paged", [True, False], ids=["paged", "gather"])
def test_int8_engine_tokens_match_the_jax_int8_engine(params, jax_int8_runs, depth, paged):
    jp, npp, jq = params
    eng = E.Engine(TM.params_from_jax(npp, "cpu"), CFG_T,
                   E.EngineConfig(**GEO, weight_quant="int8", pipeline_depth=depth,
                                  paged_kernel=paged), device="cpu")
    assert eng.params["w1"]["q"].dtype == torch.int8
    assert eng.params["ln_attn"].dtype == torch.bfloat16  # norms stay dense
    eng.start()
    try:
        futs = [eng.generate_async(p, N_NEW) for p in PROMPTS]
        outs = [f.result(timeout=300)["tokens"] for f in futs]
        st = eng.stats
        assert st["free_pages"] + st["cached_pages"] == GEO["num_pages"] - 1
    finally:
        eng.stop()
    stable = 0
    for prompt, got, ref in zip(PROMPTS, outs, jax_int8_runs):
        assert len(got) == len(ref) == N_NEW
        for toks in (got, ref):
            rows = _oracle_rows(jq, prompt, toks)
            for i, g in enumerate(toks):
                assert rows[i, g] >= rows[i].max() - TIE_EPS, (prompt, i, g)
        if _stable(_oracle_rows(jq, prompt, ref), ref):
            stable += 1
            assert got == ref
    assert stable >= 1, "no tie-stable prompt to compare bytes"


def test_weight_quant_validation_matches_jax(params):
    jp, npp, _ = params
    with pytest.raises(ValueError) as ref:
        JEngine(jp, CFG_J, JEngineConfig(**GEO, weight_quant="int4"))
    with pytest.raises(ValueError) as got:
        E.Engine(TM.params_from_jax(npp, "cpu"), CFG_T,
                 E.EngineConfig(**GEO, weight_quant="int4"), device="cpu")
    assert str(got.value) == str(ref.value) == "unsupported weight_quant 'int4'"


def test_engine_json_weight_quant_serves_int8(tmp_path):
    d = tmp_path / "m"
    d.mkdir()
    # the byte tokenizer addresses ids 0..255
    (d / "config.json").write_text(json.dumps(
        {"vocab_size": 256, **{f: getattr(CFG_J, f) for f in (
            "d_model", "n_layers", "n_heads", "n_kv_heads", "d_ff")}}))
    (d / "engine.json").write_text(json.dumps({**GEO, "weight_quant": "int8"}))
    m = JetStreamModel("m", str(d), device="cpu")
    m.load()
    try:
        assert m.engine.ec.weight_quant == "int8"
        assert all(isinstance(m.engine.params[k], dict) for k in TM._QUANT_KEYS)
        out = m.generate({"text_input": "hi", "parameters": {"max_tokens": 3}})
        assert out["tokens"] == 3
    finally:
        m.engine.stop()
