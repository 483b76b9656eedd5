"""Port parity: tensor-parallel serving, the port's counterparts of
``tests/test_sharded.py`` (and of the TP cases of ``tests/test_engine.py``).

The same numpy-seeded bf16 params feed the JAX engine on its forced
8-device CPU mesh and the port's engine on ``["cpu"] * N`` shards:
- the model at TP 2 and 4 against the port at TP 1 in f32 (prefill,
  ``write_pages``, decode on the gather path and through the paged kernel's
  plain version, the K-row verify step, LoRA), rtol/atol 1e-5 (the shards
  sum the row-parallel partials in another order), and against the JAX
  model at the same degree in bf16, 5e-2 (the reference's bf16 range);
- greedy tokens of the port engine at TP 2 and 4 against the JAX engine at
  the same degree, tie-aware against the JAX ``forward_full``: each token
  within 5e-2 of the oracle's max.  ``SHARED + "Q?"`` is served only under
  that check: its second token is an exact bf16 tie (3.046875 for tokens
  231 and 237), which the two summation orders break either way;
- every KV movement at TP > 1 with zero leaked pages: session save and
  restore (host ``match``, a TP 4 and a TP 1 restart from disk through the
  counted ``reshard``), swap preemption (byte-identical to the calm run at
  the same degree), handoff and fabric across degrees over HTTP and across
  packages (a JAX TP 2 exporter and a port TP 2 importer, and the reverse),
  and the three shard chaos classes degrading to a re-prefill;
- int8 weights with the int8 KV pool, and LoRA, under TP;
- ``engine.json``'s ``tensor_parallel`` with the JAX messages, and the MFU
  denominator of N shards on one card."""

import dataclasses
import glob
import json
import struct

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from kubeflow_tpu.serving.engine import Engine as JEngine
from kubeflow_tpu.serving.engine import EngineConfig as JEngineConfig
from kubeflow_tpu.serving.engine import model as JM
from kubeflow_tpu.serving.engine import sharding as JS
from kubeflow_tpu.serving.engine.perf import platform_peak_flops as j_peak
from kubeflow_tpu.serving.engine.serve import JetStreamModel as JJetStreamModel
from kubeflow_tpu.serving.server import ModelServer as JModelServer
from kubeflow_tpu_torch.serving.engine import model as TM
from kubeflow_tpu_torch.serving.engine import paged_attention as PA
from kubeflow_tpu_torch.serving.engine import serve as S
from kubeflow_tpu_torch.serving.engine import sharding as TS
from kubeflow_tpu_torch.serving.engine.engine import Engine, EngineConfig
from kubeflow_tpu_torch.serving.engine.faults import (FabricFaultConfig, FaultConfig,
                                                      HandoffFaultConfig)
from kubeflow_tpu_torch.serving.engine.kvstore import (FORMAT_VERSION, KVStoreConfig,
                                                       unpack_frame)
from kubeflow_tpu_torch.serving.engine.perf import platform_peak_flops
from kubeflow_tpu_torch.serving.engine.scheduler import SchedulerConfig
from kubeflow_tpu_torch.serving.server import ModelServer

# vocab >= 256 (byte tokenizer); 4 KV heads split 2 and 4 ways
CFG_J = JM.DecoderConfig(vocab_size=288, d_model=32, n_layers=1, n_heads=4,
                         n_kv_heads=4, d_ff=64)
CFG_T = TM.DecoderConfig(**dataclasses.asdict(CFG_J))
# the model-level checks: two layers, grouped-query heads (8 q over 4 kv)
CFG2_J = dataclasses.replace(CFG_J, n_layers=2, n_heads=8)
CFG2_T = TM.DecoderConfig(**dataclasses.asdict(CFG2_J))
PAGE, NUM_PAGES = 8, 96
GEO = dict(max_slots=2, page_size=PAGE, num_pages=NUM_PAGES, max_pages_per_slot=24)
PROMPT_IDS = [(i * 13) % (CFG_J.vocab_size - 1) + 1 for i in range(20)]
PROMPT = "the quick brown fox jumps over the lazy dog"
SHARED = "You are a helpful assistant. Answer concisely and cite. " * 2
TIE_EPS = 5e-2      # logits in bf16 (tests/test_engine.py:211,231)
F32_TOL = 1e-5      # f32 kernels and models (tests/test_engine.py:357)
ORACLE_LEN = 160

_forward = jax.jit(lambda p, t: JM.forward_full(p, CFG_J, t))


def _np_params(cfg, seed=0, dtype=ml_dtypes.bfloat16) -> dict:
    """Params of ``cfg``'s shapes from numpy draws, at init's scales."""
    rng = np.random.default_rng(seed)
    c, hd, n = cfg, cfg.head_dim, cfg.n_layers

    def w(shape, fan_in):
        return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(dtype)

    return {"embed": w((c.vocab_size, c.d_model), 1.0),
            "wq": w((n, c.d_model, c.n_heads * hd), c.d_model),
            "wk": w((n, c.d_model, c.n_kv_heads * hd), c.d_model),
            "wv": w((n, c.d_model, c.n_kv_heads * hd), c.d_model),
            "wo": w((n, c.n_heads * hd, c.d_model), c.n_heads * hd),
            "w1": w((n, c.d_model, c.d_ff), c.d_model),
            "w3": w((n, c.d_model, c.d_ff), c.d_model),
            "w2": w((n, c.d_ff, c.d_model), c.d_ff),
            "ln_attn": (1 + 0.1 * rng.standard_normal((n, c.d_model))).astype(dtype),
            "ln_mlp": (1 + 0.1 * rng.standard_normal((n, c.d_model))).astype(dtype),
            "ln_out": (1 + 0.1 * rng.standard_normal((c.d_model,))).astype(dtype),
            "unembed": w((c.d_model, c.vocab_size), c.d_model)}


@pytest.fixture(scope="module")
def params():
    np_p = _np_params(CFG_J)
    return {k: jnp.asarray(v) for k, v in np_p.items()}, TM.params_from_jax(np_p, "cpu")


def _mesh(tp):
    return TS.tensor_mesh(tp, ["cpu"] * tp)


def _port(params, tp=1, **kw):
    eng = Engine(params[1], CFG_T, EngineConfig(**{**GEO, "tensor_parallel": tp, **kw}),
                 device="cpu")
    eng.start()
    return eng


def _jax(params, tp=1, **kw):
    eng = JEngine(params[0], CFG_J, JEngineConfig(**{**GEO, "tensor_parallel": tp, **kw}))
    eng.start()
    return eng


def _leak(eng) -> int:
    s = eng.stats
    return (NUM_PAGES - 1) - s["free_pages"] - s["cached_pages"]


def _gen(model, prompt, mt, **p):
    return model.generate({"text_input": prompt, "parameters": {"max_tokens": mt, **p}})


def _series(counter, label) -> dict:
    return {dict(k)[label]: v for k, v in counter.series().items()}


def assert_tie_aware(jp, prompt, got: list):
    """Every served token within TIE_EPS of the JAX ``forward_full`` max
    logit along its own trajectory; ``prompt``: text (byte ids) or ids."""
    ids = list(prompt.encode()) if isinstance(prompt, str) else list(prompt)
    toks = ids + list(got)
    padded = np.zeros((1, ORACLE_LEN), np.int32)
    padded[0, :len(toks)] = toks
    rows = np.asarray(_forward(jp, padded))[0, len(ids) - 1:len(toks) - 1]
    for i, g in enumerate(got):
        assert rows[i, g] >= rows[i].max() - TIE_EPS, (i, g, int(rows[i].argmax()))


# ------------------------------------------------------------ model level


def _prefill_pools(params, cfg, mesh, dtype, toks, lens, rows):
    """Prefill ``toks`` and write its pages into fresh pools (per-shard with
    ``mesh``) -> (logits, k pools, v pools, paged k)."""
    shape = (cfg.n_layers, 24, cfg.n_kv_heads, PAGE, cfg.head_dim)
    if mesh is None:
        kp, vp = (torch.zeros(shape, dtype=dtype) for _ in range(2))
    else:
        kp, vp = (TS.alloc_pool(shape, mesh, dtype=dtype) for _ in range(2))
    logits, pk, pv = TM.prefill(params, cfg, toks, lens, PAGE, mesh=mesh)
    TM.write_pages(kp, vp, pk, pv, rows, mesh=mesh)
    return logits, kp, vp, pk


@pytest.mark.parametrize("tp", [2, 4])
def test_model_at_tp_matches_tp1_in_f32(tp):
    """Prefill, the page scatter, decode (gather and paged), the K-row
    verify step and LoRA at TP N against TP 1, f32."""
    p1 = TM.params_from_jax(_np_params(CFG2_J, seed=1, dtype=np.float32), "cpu")
    mesh = _mesh(tp)
    pn = TS.shard_params(p1, mesh)
    rng = np.random.default_rng(2)
    B, S = 2, 16
    toks = torch.from_numpy(rng.integers(1, 288, (B, S)).astype(np.int32))
    lens = torch.tensor([16, 11], dtype=torch.int32)
    rows = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    l1, k1, v1, pk1 = _prefill_pools(p1, CFG2_T, None, torch.float32, toks, lens, rows)
    ln, kn, vn, pkn = _prefill_pools(pn, CFG2_T, mesh, torch.float32, toks, lens, rows)
    torch.testing.assert_close(ln, l1, rtol=F32_TOL, atol=F32_TOL)
    hk = CFG2_T.n_kv_heads // tp
    for s in range(tp):  # each shard's prefilled KV is its own heads' slice
        torch.testing.assert_close(pkn[s], pk1[..., s * hk:(s + 1) * hk, :, :],
                                   rtol=F32_TOL, atol=F32_TOL)
        torch.testing.assert_close(kn[s], k1[:, :, s * hk:(s + 1) * hk], rtol=F32_TOL,
                                   atol=F32_TOL)
    table = torch.tensor([[1, 2, 5, 0], [3, 4, 6, 0]], dtype=torch.int32)
    seq = torch.tensor([17, 12], dtype=torch.int32)
    tok = torch.tensor([7, 9], dtype=torch.int32)
    for paged in (False, True):
        a, _, _ = TM.decode_step(p1, CFG2_T, tok, seq, table, k1.clone(), v1.clone(),
                                 paged=paged)
        b, _, _ = TM.decode_step(pn, CFG2_T, tok, seq, table, [k.clone() for k in kn],
                                 [v.clone() for v in vn], paged=paged, mesh=mesh)
        torch.testing.assert_close(b, a, rtol=F32_TOL, atol=F32_TOL)
    drafts = torch.tensor([[7, 3, 4], [9, 9, 1]], dtype=torch.int32)
    a, _, _ = TM.decode_step_k(p1, CFG2_T, drafts, seq, table, k1, v1, paged=True)
    b, _, _ = TM.decode_step_k(pn, CFG2_T, drafts, seq, table, kn, vn, paged=True, mesh=mesh)
    torch.testing.assert_close(b, a, rtol=F32_TOL, atol=F32_TOL)
    # LoRA: B's columns split for wq/w1, A's rows for wo/w2
    r, n = 4, CFG2_T.n_layers
    dims = {"wq": (32, 32), "w1": (32, 64), "wo": (32, 32), "w2": (64, 32)}
    table_l = {}
    for name, (i, o) in dims.items():
        A = rng.standard_normal((2, n, i, r)).astype(np.float32) * 0.1
        Bm = rng.standard_normal((2, n, r, o)).astype(np.float32) * 0.1
        A[0], Bm[0] = 0, 0  # adapter 0 is "no adapter"
        table_l[name] = {"A": torch.from_numpy(A), "B": torch.from_numpy(Bm)}
    aids = torch.tensor([1, 0])
    a, _, _ = TM.prefill(p1, CFG2_T, toks, lens, PAGE, lora_params=table_l, adapter_ids=aids)
    b, _, _ = TM.prefill(pn, CFG2_T, toks, lens, PAGE, mesh=mesh,
                         lora_params=TS.shard_lora(table_l, mesh), adapter_ids=aids)
    torch.testing.assert_close(b, a, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("tp", [2, 4])
def test_model_at_tp_matches_jax_at_tp(tp):
    """Prefill and a decode step at TP N in bf16: the port's shards against
    the JAX package's GSPMD partition of the same params, 5e-2."""
    np_p = _np_params(CFG2_J, seed=3)
    jmesh = JS.tensor_mesh(tp)
    jp = JS.shard_params(np_p, jmesh)
    mesh = _mesh(tp)
    pn = TS.shard_params(TM.params_from_jax(np_p, "cpu"), mesh)
    rng = np.random.default_rng(4)
    toks = rng.integers(1, 288, (2, 16)).astype(np.int32)
    lens = np.array([16, 9], np.int32)
    rows = np.array([[1, 2], [3, 4]], np.int32)
    jl, jpk, jpv = jax.jit(lambda p, t, n: JM.prefill(p, CFG2_J, t, n, PAGE))(jp, toks, lens)
    tl, tk, tv, _ = _prefill_pools(pn, CFG2_T, mesh, torch.bfloat16, torch.from_numpy(toks),
                                   torch.from_numpy(lens), torch.from_numpy(rows))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TIE_EPS, atol=TIE_EPS)
    shape = (CFG2_J.n_layers, 24, CFG2_J.n_kv_heads, PAGE, CFG2_J.head_dim)
    jk, jv = JS.alloc_pool(shape, jmesh), JS.alloc_pool(shape, jmesh)
    jk, jv = JM.write_pages(jk, jv, jpk, jpv, rows)
    table = np.array([[1, 2, 5, 0], [3, 4, 6, 0]], np.int32)
    seq = np.array([17, 10], np.int32)
    tok = np.array([7, 9], np.int32)
    jd, _, _ = jax.jit(lambda p, t, s, pt, k, v: JM.decode_step(p, CFG2_J, t, s, pt, k, v))(
        jp, tok, seq, table, jk, jv)
    td, _, _ = TM.decode_step(pn, CFG2_T, torch.from_numpy(tok), torch.from_numpy(seq),
                              torch.from_numpy(table), tk, tv, mesh=mesh)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=TIE_EPS, atol=TIE_EPS)


def test_paged_attention_mesh_wrapper_runs_each_shard():
    """With ``mesh=``, each shard's query heads attend over its own pool:
    the outputs are the single call's head slices (CPU: the plain version,
    so no launch is counted)."""
    rng = np.random.default_rng(5)
    B, K, Hq, Hkv, hd, P = 3, 2, 8, 4, 16, 12

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    q, kp, vp = t(B, K, Hq, hd), t(P, Hkv, PAGE, hd), t(P, Hkv, PAGE, hd)
    table = torch.from_numpy(rng.integers(1, P, (B, 3)).astype(np.int32))
    lens = torch.tensor([20, 0, 7], dtype=torch.int32)
    full = PA.paged_attention(q, kp, vp, table, lens, PAGE)
    mesh = _mesh(2)
    before = PA.paged_attention.launches
    outs = PA.paged_attention([q[:, :, :4].contiguous(), q[:, :, 4:].contiguous()],
                              [kp[:, :2].contiguous(), kp[:, 2:].contiguous()],
                              [vp[:, :2].contiguous(), vp[:, 2:].contiguous()],
                              table, lens, PAGE, mesh=mesh)
    assert PA.paged_attention.launches == before
    torch.testing.assert_close(torch.cat(outs, dim=2), full, rtol=F32_TOL, atol=F32_TOL)
    with pytest.raises(ValueError, match="shards need one q"):
        PA.paged_attention([q], [kp], [vp], table, lens, PAGE, mesh=mesh)


# ------------------------------------------------------------ engine level


@pytest.mark.parametrize("tp", [2, 4])
def test_greedy_tokens_against_the_jax_engine_at_tp(params, tp):
    prompts = [PROMPT_IDS, list(PROMPT.encode()), list((SHARED + "Q?").encode())]
    je, te = _jax(params, tp), _port(params, tp)
    try:
        for ids in prompts:
            got = te.generate(ids, 12)["tokens"]
            ref = je.generate(ids, 12)["tokens"]
            assert len(got) == len(ref) == 12
            assert_tie_aware(params[0], ids, got)
            assert_tie_aware(params[0], ids, ref)
        assert te.stats["tensor_parallel"] == tp and _leak(te) == 0
        assert len(te.params) == tp and len(te.k_pool) == tp
        assert tuple(te.k_pool[0].shape)[2] == CFG_T.n_kv_heads // tp
    finally:
        je.stop()
        te.stop()


def test_session_save_restore_across_degrees(params, tmp_path):
    """Pinned at TP 2 (host ``match``), restored on a TP 4 restart and on a
    unified restart from disk through the counted ``reshard``; a TP 1
    engine's page files stay version 1 with no ``tp`` meta."""
    kv = KVStoreConfig(disk_dir=str(tmp_path / "kv"))
    e2 = _port(params, 2, max_slots=4, kv_store=kv)
    try:
        r1 = e2.generate(PROMPT_IDS, 10, session_id="s")
        ctx2 = PROMPT_IDS + r1["tokens"] + [5, 6, 7, 8, 9]
        r2 = e2.generate(ctx2, 10, session_id="s")
        assert r1["session"]["durable"] and r2["session"]["restore"] == "host"
        assert_tie_aware(params[0], PROMPT_IDS, r1["tokens"])
        assert_tie_aware(params[0], ctx2, r2["tokens"])
        assert _series(e2.telemetry.kv_reshard, "outcome") == {"match": 1.0}
        shard_bytes = _series(e2.telemetry.kv_shard_bytes, "direction")
        assert shard_bytes["export"] > 0 and shard_bytes["restore"] > 0
        assert _leak(e2) == 0
    finally:
        e2.stop()
    metas = []
    for path in glob.glob(str(tmp_path / "kv" / "**" / "*.kvpg"), recursive=True):
        with open(path, "rb") as f:
            metas.append(unpack_frame(f.read())[1]["meta"])
    assert any(m.get("tp") == 2 for m in metas)
    ctx3 = ctx2 + r2["tokens"] + [11, 12, 13]
    for tp in (4, 1):
        e = Engine(params[1], CFG_T, EngineConfig(**{**GEO, "max_slots": 4, "kv_store": kv,
                                                     "tensor_parallel": tp}), device="cpu")
        assert "s" in e.sessions()
        e.start()
        try:
            r3 = e.generate(ctx3, 10, session_id="s")
            assert r3["session"]["restore"] == "disk", tp
            assert_tie_aware(params[0], ctx3, r3["tokens"])
            assert _series(e.telemetry.kv_reshard, "outcome").get("reshard", 0) >= 1, tp
            assert _leak(e) == 0
        finally:
            e.stop()
    # each re-pin replaces the session's page file: the one left is the
    # unified engine's
    files = glob.glob(str(tmp_path / "kv" / "**" / "*.kvpg"), recursive=True)
    assert len(files) == 1
    with open(files[0], "rb") as f:
        raw = f.read()
    assert struct.unpack("<I", raw[4:8])[0] == FORMAT_VERSION
    assert "tp" not in unpack_frame(raw)[1]["meta"]  # the unified engine's pin


def test_swap_preempt_at_tp2_byte_identical_zero_leaks(params):
    prompts = [[(i * 7 + j * 13) % 287 + 1 for j in range(6 + i)] for i in range(4)]

    def run_all(eng):
        futs = [eng.generate_async(p, 20, priority="batch") for p in prompts]
        return [f.result(timeout=300)["tokens"] for f in futs]

    calm = _port(params, 2, max_slots=4)
    try:
        baseline = run_all(calm)
    finally:
        calm.stop()
    eng = _port(params, 2, max_slots=4, chaos=FaultConfig(preempt_every=5),
                scheduler=SchedulerConfig(swap_policy="swap", swap_min_tokens=8))
    try:
        assert run_all(eng) == baseline
        s = eng.stats
        assert s["preemptions"] > 0 and s["swapped_out"] > 0
        assert s["swapped_in"] == s["swapped_out"] and s["swap_used_bytes"] == 0
        shard_bytes = _series(eng.telemetry.kv_shard_bytes, "direction")
        assert shard_bytes["export"] > 0 and shard_bytes["restore"] > 0
        assert _leak(eng) == 0
    finally:
        eng.stop()
    for ids, got in zip(prompts, baseline):
        assert_tie_aware(params[0], ids, got)


class _Pair:
    """A prefill replica and a decode replica, each behind a ModelServer,
    of either package and any degree."""

    def __init__(self, params, ptp, dtp, prefill="port", decode="port", pkw=None, dkw=None):
        mk = {"port": _port, "jax": _jax}
        srv = {"port": lambda e: ModelServer([S.JetStreamModel("m", engine=e)], port=0),
               "jax": lambda e: JModelServer([JJetStreamModel("m", "", engine=e)], port=0)}
        self.ep = mk[prefill](params, ptp, role="prefill", **(pkw or {}))
        self.ed = mk[decode](params, dtp, role="decode", **(dkw or {}))
        self.sp, self.sd = srv[prefill](self.ep), srv[decode](self.ed)
        self.sp.start()
        self.sd.start()
        self.mp, self.md = self.sp.models["m"], self.sd.models["m"]

    def split(self, prompt, mt):
        pre = _gen(self.mp, prompt, mt, kv_handoff=True)
        hand = {"handle": (pre.get("handoff") or {}).get("handle"),
                "source_port": self.sp.port, "token_ids": pre["token_ids"]}
        return pre, _gen(self.md, prompt, mt, handoff=hand)

    def close(self):
        for s in (self.sp, self.sd):
            s.stop()
        for e in (self.ep, self.ed):
            e.stop(drain=False)


@pytest.mark.parametrize("ptp,dtp,outcome,depth", [
    (2, 2, "match", 0), (2, 2, "match", 1), (2, 1, "reshard", 1), (1, 2, "reshard", 1),
    (2, 4, "reshard", 1)])
def test_handoff_across_degrees(params, ptp, dtp, outcome, depth):
    pair = _Pair(params, ptp, dtp, dkw={"pipeline_depth": depth})
    try:
        pre, out = pair.split(PROMPT, 12)
        assert pre["handoff"].get("handle") and out["tokens"] == 12
        assert_tie_aware(params[0], PROMPT, out["token_ids"])
        assert pair.ed.stats["prefill_dispatches"] == 0  # the decoder never prefilled
        assert _series(pair.ed.telemetry.kv_reshard, "outcome").get(outcome, 0) >= 1
        if ptp > 1:
            assert _series(pair.ep.telemetry.kv_shard_bytes, "direction")["export"] > 0
        assert _leak(pair.ep) == 0 and _leak(pair.ed) == 0
    finally:
        pair.close()


def _fabric_hint(engine, server) -> dict:
    view = engine.fabric_view()
    assert view, "nothing published"
    return {"key": view[0]["key"], "source_port": server.port, "pages": view[0]["pages"]}


def test_fabric_across_degrees(params):
    """A prefix published at TP 2 (a sharded frame) faults in on TP 2
    (``match``), TP 4 and unified (``reshard``) pullers."""
    prompt = SHARED + "Q?"
    ea = _port(params, 2, fabric=True)
    sa = ModelServer([S.JetStreamModel("m", engine=ea)], port=0)
    sa.start()
    try:
        first = _gen(sa.models["m"], prompt, 12)
        assert_tie_aware(params[0], prompt, first["token_ids"])
        assert ea.stats["fabric"]["publishes"] == 1
        for dtp, outcome in ((2, "match"), (4, "reshard"), (1, "reshard")):
            eb = _port(params, dtp, fabric=True)
            try:
                out = _gen(S.JetStreamModel("m", engine=eb), prompt, 12,
                           fabric=_fabric_hint(ea, sa))
                assert out["fabric"] == {"restore": "hit"}, dtp
                assert_tie_aware(params[0], prompt, out["token_ids"])
                assert _series(eb.telemetry.kv_reshard, "outcome").get(outcome, 0) >= 1
                assert _leak(eb) == 0
            finally:
                eb.stop(drain=False)
        assert ea.stats["fabric"]["pulls"] == 3 and _leak(ea) == 0
    finally:
        sa.stop()
        ea.stop(drain=False)


@pytest.mark.parametrize("exporter", ["jax", "port"])
def test_handoff_and_fabric_across_packages_at_tp2(params, exporter):
    """A JAX TP 2 exporter and a port TP 2 importer, and the reverse: the
    version-2 frame crosses over HTTP both ways and scatters shard to
    shard (``match``), for a handoff and for a fabric pull."""
    importer = "port" if exporter == "jax" else "jax"
    pair = _Pair(params, 2, 2, prefill=exporter, decode=importer)
    try:
        _, out = pair.split(PROMPT, 10)
        assert_tie_aware(params[0], PROMPT, out["token_ids"])
        assert pair.ed.stats["prefill_dispatches"] == 0
        assert _series(pair.ed.telemetry.kv_reshard, "outcome").get("match", 0) >= 1
        assert _leak(pair.ep) == 0 and _leak(pair.ed) == 0
    finally:
        pair.close()
    mk = {"port": _port, "jax": _jax}
    srv = {"port": lambda e: ModelServer([S.JetStreamModel("m", engine=e)], port=0),
           "jax": lambda e: JModelServer([JJetStreamModel("m", "", engine=e)], port=0)}
    ea, eb = mk[exporter](params, 2, fabric=True), mk[importer](params, 2, fabric=True)
    sa, sb = srv[exporter](ea), srv[importer](eb)
    sa.start()
    sb.start()
    try:
        prompt = (SHARED * 2)[:120]
        _gen(sa.models["m"], prompt, 8)
        out = _gen(sb.models["m"], prompt, 8, fabric=_fabric_hint(ea, sa))
        assert out["fabric"] == {"restore": "hit"}
        assert_tie_aware(params[0], prompt, out["token_ids"])
        assert _series(eb.telemetry.kv_reshard, "outcome").get("match", 0) >= 1
        assert _leak(ea) == 0 and _leak(eb) == 0
    finally:
        sa.stop()
        sb.stop()
        ea.stop(drain=False)
        eb.stop(drain=False)


@pytest.mark.parametrize("kind", ["torn", "flip", "drop"])
@pytest.mark.parametrize("scope", ["handoff", "fabric"])
def test_shard_chaos_degrades_with_zero_leaks(params, scope, kind):
    field = {f"shard_{kind}_pull_on": 1}
    if scope == "handoff":
        pair = _Pair(params, 2, 2, dkw={"handoff_chaos": HandoffFaultConfig(**field)})
        try:
            _, out = pair.split(PROMPT, 10)
            assert out["tokens"] == 10
            assert_tie_aware(params[0], PROMPT, out["token_ids"])
            assert _series(pair.ed.telemetry.kv_handoff, "outcome").get("degraded", 0) >= 1
            assert pair.ed._handoff_chaos.stats()["injected_shard_faults"] == 1
            assert _leak(pair.ep) == 0 and _leak(pair.ed) == 0
        finally:
            pair.close()
        return
    prompt = SHARED + "Q?"
    ea = _port(params, 2, fabric=True)
    sa = ModelServer([S.JetStreamModel("m", engine=ea)], port=0)
    sa.start()
    eb = _port(params, 2, fabric=True, fabric_chaos=FabricFaultConfig(**field))
    try:
        _gen(sa.models["m"], prompt, 10)
        out = _gen(S.JetStreamModel("m", engine=eb), prompt, 10, fabric=_fabric_hint(ea, sa))
        assert out["fabric"] == {"restore": "degraded"}
        assert_tie_aware(params[0], prompt, out["token_ids"])
        outcomes = _series(eb.telemetry.kv_fabric, "outcome")
        assert outcomes.get("degraded", 0) >= 1 and outcomes.get("hit", 0) == 0
        assert eb._fabric_chaos.stats()["injected_shard_faults"] == 1
        assert _leak(ea) == 0 and _leak(eb) == 0
    finally:
        sa.stop()
        ea.stop(drain=False)
        eb.stop(drain=False)


def test_int8_weights_and_kv_under_tp(params):
    """int8 weights (quantized before the split: each shard holds int8
    ``q`` and its scales) with the int8 KV pool at TP 2, tie-aware against
    ``forward_full`` on the same quantized weights."""
    kw = {"weight_quant": "int8", "kv_quant": "int8"}
    eng = _port(params, 2, **kw)
    try:
        assert eng.params[0]["wq"]["q"].dtype == torch.int8
        assert eng.params[0]["wq"]["q"].shape[-1] == CFG_T.n_heads * CFG_T.head_dim // 2
        assert eng.params[0]["wo"]["s"].shape == eng.params[1]["wo"]["s"].shape
        assert isinstance(eng.k_pool[0], dict) and eng.k_pool[0]["q"].dtype == torch.int8
        qparams = TM.quantize_weights_int8(params[1])
        for ids in (PROMPT_IDS, list(PROMPT.encode())):
            got = eng.generate(ids, 12)["tokens"]
            full = TM.forward_full(qparams, CFG_T, torch.tensor([ids + got[:-1]]))[0]
            rows = full[len(ids) - 1:]
            picked = rows[torch.arange(len(got)), torch.tensor(got)]
            assert float((rows.max(-1).values - picked).max()) <= TIE_EPS
        assert _leak(eng) == 0
    finally:
        eng.stop()


def test_lora_under_tp(params):
    """Adapters under TP 2: the table is split per shard and a request
    under an adapter is tie-aware against ``forward_full`` with it."""
    rng = np.random.default_rng(6)
    n, r = CFG_T.n_layers, 4
    dims = {"wq": (32, 32), "wv": (32, 32), "wo": (32, 32), "w1": (32, 64), "w2": (64, 32)}
    table = {}
    for name, (i, o) in dims.items():
        A = (rng.standard_normal((2, n, i, r)) * 0.1).astype(np.float32)
        Bm = (rng.standard_normal((2, n, r, o)) * 0.1).astype(np.float32)
        A[0], Bm[0] = 0, 0
        table[name] = {"A": torch.from_numpy(A).to(torch.bfloat16),
                       "B": torch.from_numpy(Bm).to(torch.bfloat16)}
    eng = Engine(params[1], CFG_T, EngineConfig(**{**GEO, "tensor_parallel": 2}),
                 device="cpu", lora=(table, {"a": 1}))
    eng.start()
    try:
        assert len(eng._lora) == 2
        for adapter, aid in ((None, 0), ("a", 1)):
            got = eng.generate(PROMPT_IDS, 12, adapter=adapter)["tokens"]
            full = TM.forward_full(params[1], CFG_T, torch.tensor([PROMPT_IDS + got[:-1]]),
                                   lora_params=table, adapter_ids=torch.tensor([aid]))[0]
            rows = full[len(PROMPT_IDS) - 1:]
            picked = rows[torch.arange(len(got)), torch.tensor(got)]
            assert float((rows.max(-1).values - picked).max()) <= TIE_EPS, adapter
        assert _leak(eng) == 0
    finally:
        eng.stop()


def test_engine_json_tensor_parallel(tmp_path, monkeypatch):
    """The JAX messages, the file named; a CUDA pod with fewer cards than
    shards refuses; a valid degree serves sharded on the CPU."""
    base_cfg = {"vocab_size": 288, "d_model": 32, "n_layers": 1, "n_heads": 4,
                "n_kv_heads": 4, "d_ff": 64}

    def mk(name, cfg, ec):
        d = tmp_path / name
        d.mkdir()
        (d / "config.json").write_text(json.dumps(cfg))
        (d / "engine.json").write_text(json.dumps({**GEO, **ec}))
        return str(d)

    d = mk("devices", {**base_cfg, "n_heads": 16, "n_kv_heads": 16, "d_model": 64},
           {"tensor_parallel": 16})
    with pytest.raises(ValueError) as ref:
        JJetStreamModel("t", d).load()
    monkeypatch.setattr(torch.cuda, "device_count", lambda: len(jax.devices()))
    with pytest.raises(ValueError) as port:
        S._engine_config(d + "/engine.json", TM.DecoderConfig.from_dir(d), torch.device("cuda"))
    assert str(port.value) == str(ref.value)
    assert "needs 16 devices, have 8 — refusing to silently serve" in str(port.value)
    monkeypatch.undo()
    m = S.JetStreamModel("t", mk("good", base_cfg, {"tensor_parallel": 2}), device="cpu")
    m.load()
    try:
        assert m.engine._mesh is not None and m.engine.ec.tensor_parallel == 2
        assert _gen(m, PROMPT, 4)["tokens"] == 4
    finally:
        m.engine.stop()


def test_mfu_peak_counts_distinct_cards():
    """N shards on one card charge one card's peak under an ``xN`` label;
    N cards charge N peaks; the CPU estimate is the JAX package's."""
    h100 = "NVIDIA H100 80GB HBM3"
    assert platform_peak_flops("cuda", h100, 2, n_cards=1) == ("cuda-h100-sxmx2", 989.4e12)
    assert platform_peak_flops("cuda", h100, 2) == ("cuda-h100-sxmx2", 2 * 989.4e12)
    assert platform_peak_flops("cpu", "", 4) == j_peak("cpu", "", 4)
    eng = Engine(_np_to_port_small(), CFG_T, EngineConfig(**{**GEO, "tensor_parallel": 2}),
                 device="cpu")
    try:
        snap = eng.perf_snapshot()
        assert snap["platform"] == j_peak("cpu", "", 2)[0] == "cpux2"
    finally:
        eng.stop()


def _np_to_port_small():
    return TM.params_from_jax(_np_params(CFG_J, seed=7), "cpu")
