"""Port parity: the fused decode steps of the pipelined and speculative loops.

``decode_step_sample``, ``decode_step_sample_packed``, ``decode_step_k`` and
``decode_step_verify_sample`` of kubeflow_tpu_torch against their JAX twins,
on the same weights (``params_from_jax``) and the same numpy-seeded pool
state, at the tiny config of tests/test_spec_pipeline.py.  The JAX side runs
its gather path (the JAX engine's default); the port runs both its gather
path and its paged path (the plain version of the kernel on the CPU), with
bf16 and int8 pools.

Tolerances: logits within 5e-2 (the cross-framework bf16 bound of
tests/test_torch_model.py).  Sampled and packed tokens must be equal where
the top-1/top-2 gap of the JAX logits exceeds 0.07, twice the largest
cross-framework logit difference seen at this size; a nearer tie may flip.
A poisoned row must come back negative (single token) or all ``-1``
(packed)."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import jax
from kubeflow_tpu.serving.engine import model as JM
from kubeflow_tpu_torch.serving.engine import model as TM

CFG_J = JM.DecoderConfig(vocab_size=101, d_model=64, n_layers=2, n_heads=4,
                         n_kv_heads=2, d_ff=128)
CFG_T = TM.DecoderConfig(**{f: getattr(CFG_J, f) for f in TM.DecoderConfig.__dataclass_fields__})
PS, PAGES, K = 8, 16, 5
LOGIT_TOL = 5e-2
STABLE_GAP = 0.07
# slot 0: mid-page; slot 1: K rows crossing into its second page; slot 2:
# idle; slot 3: draft rows stepping past its 2-page table (trash page 0)
TABLE = np.array([[3, 5, 0, 0], [7, 8, 0, 0], [0, 0, 0, 0], [9, 10, 0, 0]], np.int32)
LENS = np.array([11, 6, 0, 14], np.int32)
LIVE = [0, 1, 3]


@pytest.fixture(scope="module")
def params():
    jp = JM.init(jax.random.PRNGKey(0), CFG_J)
    return jp, TM.params_from_jax({k: np.asarray(v) for k, v in jp.items()}, "cpu")


def _t(x):
    return TM.params_from_jax({"x": np.asarray(x)}, "cpu")["x"]


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _pools(quant, seed=0):
    """(jax k, jax v, port k, port v) holding the same numpy-seeded state."""
    rng = np.random.default_rng(seed)
    shape = (CFG_J.n_layers, PAGES, CFG_J.n_kv_heads, PS, CFG_J.head_dim)
    k0 = rng.standard_normal(shape).astype(ml_dtypes.bfloat16)
    v0 = rng.standard_normal(shape).astype(ml_dtypes.bfloat16)
    if quant is None:
        return jnp.asarray(k0), jnp.asarray(v0), _t(k0), _t(v0)
    return (dict(zip("qs", JM._quantize_kv(jnp.asarray(k0)))),
            dict(zip("qs", JM._quantize_kv(jnp.asarray(v0)))),
            dict(zip("qs", TM._quantize_kv(_t(k0)))),
            dict(zip("qs", TM._quantize_kv(_t(v0)))))


def _gap(logits):
    top2 = np.sort(logits, axis=-1)[..., -2:]
    return top2[..., 1] - top2[..., 0]


def _jax_k_logits(jp, quant, tokens):
    jk, jv, _, _ = _pools(quant)
    out, _, _ = JM.decode_step_k(jp, CFG_J, jnp.asarray(tokens), jnp.asarray(LENS),
                                 jnp.asarray(TABLE), jk, jv)
    return np.asarray(out, np.float32)


MODES = pytest.mark.parametrize("paged,quant", [(False, None), (True, None),
                                                (False, "int8"), (True, "int8")],
                                ids=["gather-bf16", "paged-bf16", "gather-int8", "paged-int8"])


@MODES
def test_decode_step_sample_matches_jax(params, paged, quant):
    """Guarded tokens against the JAX twin, a negative (poisoned-last-tick)
    input token clamped before the embedding, and a poisoned row encoded as
    ``-token - 1``."""
    jp, tp = params
    toks = np.array([42, -8, 0, 7], np.int32)  # slot 1 feeds a tripped row back
    poison = np.array([False, False, False, True])
    jk, jv, tk, tv = _pools(quant)
    ref, _, _ = JM.decode_step_sample(jp, CFG_J, jnp.asarray(toks), jnp.asarray(LENS),
                                      jnp.asarray(TABLE), jk, jv, jax.random.PRNGKey(0),
                                      jnp.asarray(poison))
    out, tk2, _ = TM.decode_step_sample(tp, CFG_T, torch.from_numpy(toks),
                                        torch.from_numpy(LENS), torch.from_numpy(TABLE),
                                        tk, tv, None, torch.from_numpy(poison), paged=paged)
    assert tk2 is tk and out.dtype == torch.int32
    ref = np.asarray(ref)
    out = out.numpy()
    jk, jv, _, _ = _pools(quant)
    logits, _, _ = JM.decode_step(jp, CFG_J, jnp.asarray(np.maximum(toks, 0)),
                                  jnp.asarray(LENS), jnp.asarray(TABLE), jk, jv)
    gap = _gap(np.asarray(logits, np.float32))
    stable = [b for b in (0, 1) if gap[b] > STABLE_GAP]
    assert stable, "no tie-stable row to compare"
    for b in (0, 1):
        assert out[b] >= 0
    for b in stable:
        assert out[b] == ref[b], (b, out[b], ref[b])
    assert out[3] < 0 and ref[3] < 0


@MODES
def test_decode_step_k_matches_jax(params, paged, quant):
    """Verify logits for every one of the K rows, and the KV of the draft
    positions, against the JAX twin; rows past the table go to the trash
    page."""
    jp, tp = params
    toks = np.random.default_rng(1).integers(0, CFG_J.vocab_size, (4, K)).astype(np.int32)
    ref = _jax_k_logits(jp, quant, toks)
    jk, jv, tk, tv = _pools(quant)
    _, jk, _ = JM.decode_step_k(jp, CFG_J, jnp.asarray(toks), jnp.asarray(LENS),
                                jnp.asarray(TABLE), jk, jv)
    out, tk2, _ = TM.decode_step_k(tp, CFG_T, torch.from_numpy(toks), torch.from_numpy(LENS),
                                   torch.from_numpy(TABLE), tk, tv, paged=paged)
    assert tk2 is tk and tuple(out.shape) == (4, K, CFG_J.vocab_size)
    np.testing.assert_allclose(_np(out)[LIVE], ref[LIVE], rtol=LOGIT_TOL, atol=LOGIT_TOL)
    if quant is None:
        # slot 1 writes positions 5..9: page 7 offsets 5-7, page 8 offsets
        # 0-1; slot 3 positions 13..15 at page 10 offsets 5-7
        for page, offs in ((7, [5, 6, 7]), (8, [0, 1]), (10, [5, 6, 7])):
            np.testing.assert_allclose(_np(tk)[:, page][:, :, offs],
                                       _np(jk)[:, page][:, :, offs], rtol=2e-2, atol=2e-2)
        # slot 3's rows at positions 16, 17 (past its 2 pages) go to the
        # trash page 0, never wrapping into its last owned page 10
        np.testing.assert_array_equal(_np(tk)[:, 10, :, :5], _np(_pools(None)[2])[:, 10, :, :5])


def _greedy_drafts(jp, quant, tok0):
    """Drafts that greedy accepts: each draft is the JAX argmax at its
    position given the drafts before it."""
    toks = np.zeros((4, K), np.int32)
    toks[:, 0] = tok0
    for j in range(K - 1):
        toks[:, j + 1] = _jax_k_logits(jp, quant, toks)[:, j].argmax(-1)
    return toks


@MODES
def test_decode_step_verify_sample_matches_jax(params, paged, quant):
    """Device-side feedback from ``prev_packed``, verify, sampling and the
    longest-prefix accept: full accepts, a draft_len cut, a broken draft,
    and a poisoned row sentinel-encoded as all ``-1``."""
    jp, tp = params
    prev = np.array([[5, 42, -1, -1, -1], [17, -1, -1, -1, -1],
                     [-1, -1, -1, -1, -1], [3, 1, 7, -1, -1]], np.int32)
    tok0 = np.maximum(prev[np.arange(4), np.maximum((prev >= 0).sum(1) - 1, 0)], 0)
    full = _greedy_drafts(jp, quant, tok0)
    drafts = full[:, 1:].copy()
    drafts[1, 2] = (drafts[1, 2] + 1) % CFG_J.vocab_size  # slot 1 breaks at draft 2
    dlen = np.array([4, 4, 0, 2], np.int32)  # slot 3 offers only 2 drafts
    jk, jv, tk, tv = _pools(quant)
    ref, _, _ = JM.decode_step_verify_sample(
        jp, CFG_J, jnp.asarray(prev), jnp.asarray(drafts), jnp.asarray(dlen),
        jnp.asarray(LENS), jnp.asarray(TABLE), jk, jv, jax.random.PRNGKey(0))
    out, _, _ = TM.decode_step_verify_sample(
        tp, CFG_T, torch.from_numpy(prev), torch.from_numpy(drafts), torch.from_numpy(dlen),
        torch.from_numpy(LENS), torch.from_numpy(TABLE), tk, tv, paged=paged)
    ref, out = np.asarray(ref), out.numpy()
    assert out.dtype == np.int32 and out.shape == (4, K)
    verify_toks = np.concatenate([tok0[:, None], drafts], axis=1)
    gap = _gap(_jax_k_logits(jp, quant, verify_toks))
    stable = [b for b in LIVE if gap[b].min() > STABLE_GAP]
    assert stable, "no tie-stable row to compare"
    for b in LIVE:
        n = int((out[b] >= 0).sum())
        assert n >= 1 and (out[b, n:] == -1).all()  # leading-accepted
    for b in stable:
        np.testing.assert_array_equal(out[b], ref[b])
        assert int((out[b] >= 0).sum()) == {0: K, 1: 3, 3: 3}[b]

    # a poisoned row: all -1 on both sides, the healthy rows untouched
    poison = np.array([True, False, False, False])
    jk, jv, tk, tv = _pools(quant)
    ref_p, _, _ = JM.decode_step_verify_sample(
        jp, CFG_J, jnp.asarray(prev), jnp.asarray(drafts), jnp.asarray(dlen),
        jnp.asarray(LENS), jnp.asarray(TABLE), jk, jv, jax.random.PRNGKey(0),
        jnp.asarray(poison))
    out_p, _, _ = TM.decode_step_verify_sample(
        tp, CFG_T, torch.from_numpy(prev), torch.from_numpy(drafts), torch.from_numpy(dlen),
        torch.from_numpy(LENS), torch.from_numpy(TABLE), tk, tv,
        poison=torch.from_numpy(poison), paged=paged)
    assert (out_p.numpy()[0] == -1).all() and (np.asarray(ref_p)[0] == -1).all()
    np.testing.assert_array_equal(out_p.numpy()[1:], out[1:])


@pytest.mark.parametrize("paged", [False, True], ids=["gather", "paged"])
def test_decode_step_sample_packed_matches_jax(params, paged):
    """The no-draft tick on the packed edge: input = the last accepted entry
    (an all -1 row clamps), output ``[tok, -1, ...]``, a poisoned row with no
    leading non-negative entry."""
    jp, tp = params
    prev = np.array([[5, 42, -1, -1, -1], [-1, -1, -1, -1, -1],
                     [-1, -1, -1, -1, -1], [3, 1, 7, 9, 2]], np.int32)
    poison = np.array([False, True, False, False])
    jk, jv, tk, tv = _pools(None)
    ref, _, _ = JM.decode_step_sample_packed(
        jp, CFG_J, jnp.asarray(prev), jnp.asarray(LENS), jnp.asarray(TABLE), jk, jv,
        jax.random.PRNGKey(0), jnp.asarray(poison))
    out, _, _ = TM.decode_step_sample_packed(
        tp, CFG_T, torch.from_numpy(prev), torch.from_numpy(LENS), torch.from_numpy(TABLE),
        tk, tv, poison=torch.from_numpy(poison), paged=paged)
    ref, out = np.asarray(ref), out.numpy()
    assert out.shape == (4, K) and (out[:, 1:] == -1).all()
    assert out[1, 0] < 0 and ref[1, 0] < 0
    jk, jv, _, _ = _pools(None)
    logits, _, _ = JM.decode_step(jp, CFG_J, jnp.asarray([42, 0, 0, 2], dtype=jnp.int32),
                                  jnp.asarray(LENS), jnp.asarray(TABLE), jk, jv)
    gap = _gap(np.asarray(logits, np.float32))
    stable = [b for b in (0, 3) if gap[b] > STABLE_GAP]
    assert stable, "no tie-stable row to compare"
    for b in (0, 3):
        assert out[b, 0] >= 0
    for b in stable:
        assert out[b, 0] == ref[b, 0]


def test_fused_step_equals_decode_step_then_sample(params):
    """Within the port: the fused step's tokens are exactly
    ``sample_tokens(decode_step(...))`` — the sync and pipelined loops share
    numerics, which their byte identity rests on."""
    _, tp = params
    toks = np.array([42, 7, 0, 9], np.int32)
    for paged in (False, True):
        _, _, tk, tv = _pools(None)
        fused, _, _ = TM.decode_step_sample(tp, CFG_T, torch.from_numpy(toks),
                                            torch.from_numpy(LENS), torch.from_numpy(TABLE),
                                            tk, tv, paged=paged)
        _, _, tk, tv = _pools(None)
        logits, _, _ = TM.decode_step(tp, CFG_T, torch.from_numpy(toks),
                                      torch.from_numpy(LENS), torch.from_numpy(TABLE),
                                      tk, tv, paged=paged)
        np.testing.assert_array_equal(fused.numpy(), TM.sample_tokens(logits).numpy())
