"""Port parity: kubeflow_tpu_torch's decoder against the JAX package's.

Weights come from the JAX package's ``init`` at the tiny config of
tests/test_engine.py and cross to the port through ``params_from_jax``;
inputs are numpy-seeded and fed to both.  Logits are compared at the upper
end of the bf16 tolerances the JAX package itself uses for its paged path
against its oracle (rtol/atol 5e-2; tests/test_engine.py:211,231 use 2e-2
to 5e-2 within one framework): the two frameworks round bf16 at different
places, which moves a logit near 1.0 by a few bf16 ulps (2**-7 each), so
bitwise equality is not expected.  KV pages, one projection deep, are held
at 2e-2."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from kubeflow_tpu.serving.engine import model as JM
from kubeflow_tpu_torch.serving.engine import model as TM

CFG_J = JM.DecoderConfig(vocab_size=101, d_model=64, n_layers=2, n_heads=4,
                         n_kv_heads=2, d_ff=128)
CFG_T = TM.DecoderConfig(**{f: getattr(CFG_J, f) for f in
                            TM.DecoderConfig.__dataclass_fields__})
PS = 8


@pytest.fixture(scope="module")
def params():
    jp = JM.init(jax.random.PRNGKey(0), CFG_J)
    return jp, TM.params_from_jax({k: np.asarray(v) for k, v in jp.items()}, "cpu")


def _t(x):
    """numpy (incl. ml_dtypes bf16) -> CPU tensor through the carrier."""
    return TM.params_from_jax({"x": np.asarray(x)}, "cpu")["x"]


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def test_params_from_jax_round_trip_is_bit_exact(params):
    jp, tp = params
    for name, arr in jp.items():
        arr = np.asarray(arr)
        assert tp[name].dtype == torch.bfloat16 and tuple(tp[name].shape) == arr.shape
        np.testing.assert_array_equal(tp[name].view(torch.int16).numpy(),
                                      arr.view(np.int16))


def test_config_matches_reference():
    for name in ("llama3_8b",):
        assert (getattr(TM.DecoderConfig, name)().__dict__
                == getattr(JM.DecoderConfig, name)().__dict__)
    c8 = TM.DecoderConfig.llama3_8b()
    j8 = JM.DecoderConfig.llama3_8b()
    assert c8.param_count() == j8.param_count()
    assert c8.matmul_flops_per_token() == j8.matmul_flops_per_token()
    assert c8.attn_flops_per_token(2048) == j8.attn_flops_per_token(2048)


def test_forward_full_matches_jax(params):
    jp, tp = params
    toks = np.random.default_rng(0).integers(0, CFG_J.vocab_size, (2, 12)).astype(np.int32)
    ref = JM.forward_full(jp, CFG_J, jnp.asarray(toks))
    out = TM.forward_full(tp, CFG_T, torch.from_numpy(toks))
    np.testing.assert_allclose(_np(out), _np(ref), rtol=5e-2, atol=5e-2)


def test_prefill_and_write_pages_match_jax(params):
    jp, tp = params
    rng = np.random.default_rng(1)
    S = 16
    toks = rng.integers(0, CFG_J.vocab_size, (2, S)).astype(np.int32)
    lens = np.array([16, 11], np.int32)
    jl, jk, jv = JM.prefill(jp, CFG_J, jnp.asarray(toks), jnp.asarray(lens), PS)
    tl, tk, tv = TM.prefill(tp, CFG_T, torch.from_numpy(toks), torch.from_numpy(lens), PS)
    np.testing.assert_allclose(_np(tl), _np(jl), rtol=5e-2, atol=5e-2)
    assert tuple(tk.shape) == jk.shape
    np.testing.assert_allclose(_np(tk), _np(jk), rtol=2e-2, atol=2e-2)

    shape = (CFG_J.n_layers, 8, CFG_J.n_kv_heads, PS, CFG_J.head_dim)
    rows = np.array([[3, 5], [6, 0]], np.int32)  # row 1's tail -> trash page 0
    # scatter the SAME (JAX-computed) pages on both sides: the scatter
    # itself must then agree bit for bit
    jkp, jvp = JM.write_pages(jnp.zeros(shape, jnp.bfloat16), jnp.zeros(shape, jnp.bfloat16),
                              jk, jv, jnp.asarray(rows))
    tkp, tvp = TM.make_kv_pool(shape, device="cpu"), TM.make_kv_pool(shape, device="cpu")
    out = TM.write_pages(tkp, tvp, _t(jk), _t(jv), torch.from_numpy(rows))
    assert out[0] is tkp and out[1] is tvp  # in place
    for page in (3, 5, 6):
        np.testing.assert_array_equal(_np(tkp)[:, page], _np(jkp)[:, page])
        np.testing.assert_array_equal(_np(tvp)[:, page], _np(jvp)[:, page])


@pytest.mark.parametrize("quant", [None, "int8"])
def test_prefill_chunk_matches_jax(params, quant):
    jp, tp = params
    rng = np.random.default_rng(2)
    C = 16
    shape = (CFG_J.n_layers, 12, CFG_J.n_kv_heads, PS, CFG_J.head_dim)
    toks = rng.integers(0, CFG_J.vocab_size, (2, C)).astype(np.int32)
    lens = np.array([40, 27], np.int32)
    hist = np.array([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)  # chunk 2 of each
    chunk = hist[:, 2:].copy()
    base = rng.standard_normal(shape).astype(ml_dtypes.bfloat16)

    def pools_j():
        if quant is None:
            return jnp.asarray(base), jnp.asarray(base)
        return ({"q": q, "s": s} for q, s in
                (JM._quantize_kv(jnp.asarray(base)) for _ in range(2)))

    def pools_t():
        if quant is None:
            return _t(base), _t(base).clone()
        q, s = TM._quantize_kv(_t(base))
        return {"q": q, "s": s}, {"q": q.clone(), "s": s.clone()}

    jk, jv = pools_j()
    tk, tv = pools_t()
    jl, jk, jv = JM.prefill_chunk(jp, CFG_J, jnp.asarray(toks), jnp.int32(16),
                                  jnp.asarray(lens), jnp.asarray(chunk), jnp.asarray(hist),
                                  jk, jv, PS)
    tl, tk, tv = TM.prefill_chunk(tp, CFG_T, torch.from_numpy(toks), 16,
                                  torch.from_numpy(lens), torch.from_numpy(chunk),
                                  torch.from_numpy(hist), tk, tv, PS)
    np.testing.assert_allclose(_np(tl), _np(jl), rtol=5e-2, atol=5e-2)
    if quant is None:
        np.testing.assert_allclose(_np(tk), _np(jk), rtol=2e-2, atol=2e-2)


def test_quantize_kv_matches_jax():
    x = np.random.default_rng(3).standard_normal((4, 3, 16)).astype(ml_dtypes.bfloat16)
    jq, js = JM._quantize_kv(jnp.asarray(x))
    tq, ts = TM._quantize_kv(_t(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(_np(ts), _np(js))


@pytest.mark.parametrize("paged", [False, True], ids=["gather", "paged"])
@pytest.mark.parametrize("quant", [None, "int8"])
def test_decode_step_matches_jax(params, paged, quant):
    """One decode step on identical pool state, against the JAX gather path
    (the JAX engine's default) — so both the port's gather path and its
    paged path are held to the reference."""
    jp, tp = params
    rng = np.random.default_rng(4)
    shape = (CFG_J.n_layers, 16, CFG_J.n_kv_heads, PS, CFG_J.head_dim)
    k0 = rng.standard_normal(shape).astype(ml_dtypes.bfloat16)
    v0 = rng.standard_normal(shape).astype(ml_dtypes.bfloat16)
    pt = np.array([[3, 5, 0, 0], [7, 0, 0, 0], [0, 0, 0, 0]], np.int32)
    lens = np.array([11, 5, 0], np.int32)  # partial pages; slot 2 idle
    toks = np.array([42, 7, 0], np.int32)

    if quant is None:
        jk, jv, tk, tv = jnp.asarray(k0), jnp.asarray(v0), _t(k0), _t(v0)
    else:
        jk = dict(zip("qs", JM._quantize_kv(jnp.asarray(k0))))
        jv = dict(zip("qs", JM._quantize_kv(jnp.asarray(v0))))
        tk = dict(zip("qs", TM._quantize_kv(_t(k0))))
        tv = dict(zip("qs", TM._quantize_kv(_t(v0))))
    jl, jk, jv = JM.decode_step(jp, CFG_J, jnp.asarray(toks), jnp.asarray(lens),
                                jnp.asarray(pt), jk, jv)
    tl, tk2, tv2 = TM.decode_step(tp, CFG_T, torch.from_numpy(toks), torch.from_numpy(lens),
                                  torch.from_numpy(pt), tk, tv, paged=paged)
    assert tk2 is tk and tv2 is tv  # pools update in place
    np.testing.assert_allclose(_np(tl)[:2], _np(jl)[:2], rtol=5e-2, atol=5e-2)
    # the step's KV write landed at (page 5, offset 2) and (page 7, offset 4)
    jq = jk["q"] if quant else jk
    tq = tk["q"] if quant else tk
    for page, off in ((5, 2), (7, 4)):
        np.testing.assert_allclose(_np(tq)[:, page, :, off], _np(jq)[:, page, :, off],
                                   rtol=2e-2, atol=2e-2 if quant is None else 1.01)


def test_decode_paged_matches_gather(params):
    """decode_step(paged=True) == the gather path on identical pool state
    (tests/test_engine.py:360 for the port)."""
    _, tp = params
    rng = np.random.default_rng(5)
    shape = (CFG_J.n_layers, 16, CFG_J.n_kv_heads, PS, CFG_J.head_dim)
    k0 = _t(rng.standard_normal(shape).astype(ml_dtypes.bfloat16))
    v0 = _t(rng.standard_normal(shape).astype(ml_dtypes.bfloat16))
    pt = torch.tensor([[3, 5, 0, 0], [7, 0, 0, 0]], dtype=torch.int32)
    lens = torch.tensor([11, 5], dtype=torch.int32)
    toks = torch.tensor([42, 7], dtype=torch.int32)
    lg, _, _ = TM.decode_step(tp, CFG_T, toks, lens, pt, k0.clone(), v0.clone())
    lp, _, _ = TM.decode_step(tp, CFG_T, toks, lens, pt, k0.clone(), v0.clone(), paged=True)
    np.testing.assert_allclose(_np(lp), _np(lg), rtol=2e-2, atol=2e-2)


def test_sample_tokens_greedy_tie_break_matches_jax_exactly():
    logits = np.array([[1.0, 3.0, 3.0, 2.0],     # tie -> lowest id 1
                       [5.0, 5.0, 5.0, 5.0],     # all tied -> 0
                       [np.nan] * 4,             # no finite max -> V-1
                       [-1.0, -2.0, 0.5, 0.5]], np.float32)
    ref = np.asarray(JM.sample_tokens(jnp.asarray(logits), jax.random.PRNGKey(0), 0.0))
    out = TM.sample_tokens(torch.from_numpy(logits))
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(ref, [1, 0, 3, 2])


def test_sample_tokens_temperature_draws_from_the_softmax():
    """Sampling at temperature > 0 cannot match JAX's bits (another
    generator); its distribution must match the softmax."""
    logits = torch.tensor([[0.0, 1.0, 2.0]]).expand(20000, 3)
    g = torch.Generator().manual_seed(0)
    draws = TM.sample_tokens(logits, g, temperature=1.0)
    freq = np.bincount(draws.numpy(), minlength=3) / draws.numel()
    np.testing.assert_allclose(freq, torch.softmax(logits[0], -1).numpy(), atol=0.02)


def test_out_of_range_page_routes_to_trash_page(params):
    """A row stepped past its page table writes its KV to trash page 0
    (model.py:636-646 in the JAX package) instead of raising or aliasing
    the row's last owned page."""
    jp, tp = params
    shape = (CFG_J.n_layers, 8, CFG_J.n_kv_heads, PS, CFG_J.head_dim)
    pt = np.array([[3, 5]], np.int32)   # 2 pages = 16 positions
    lens = np.array([17], np.int32)     # position 16 -> page index 2: past the table
    toks = np.array([9], np.int32)
    jl, jk, _ = JM.decode_step(jp, CFG_J, jnp.asarray(toks), jnp.asarray(lens),
                               jnp.asarray(pt), jnp.zeros(shape, jnp.bfloat16),
                               jnp.zeros(shape, jnp.bfloat16))
    for paged in (False, True):
        tk, tv = TM.make_kv_pool(shape, device="cpu"), TM.make_kv_pool(shape, device="cpu")
        TM.decode_step(tp, CFG_T, torch.from_numpy(toks), torch.from_numpy(lens),
                       torch.from_numpy(pt), tk, tv, paged=paged)
        assert tk[:, 0, :, 0].abs().sum() > 0           # landed on the trash page
        assert tk[:, 3].abs().sum() == 0 and tk[:, 5].abs().sum() == 0
        np.testing.assert_allclose(_np(tk)[:, 0, :, 0], _np(jk)[:, 0, :, 0],
                                   rtol=2e-2, atol=2e-2)
