"""Port parity: multi-LoRA serving (PEFT adapters, the ``adapter`` parameter).

- The port reads ``.safetensors`` itself: its reader gives the tensors
  ``safetensors.safe_open`` gives for files that package wrote (F32, F16,
  BF16, with metadata), and refuses a broken header.
- ``load_adapters`` on the same PEFT dirs (two adapters of different ranks
  and projections, ``lora_alpha``/r folded into B) gives A and B tables
  bit-identical to the JAX package's and the same name -> id map; every
  refusal (variants, rank and alpha patterns, a missing file, bad names,
  half pairs, bad shapes and ranks) raises the JAX package's message.
- ``forward_full`` with mixed ``adapter_ids`` stays within 5e-2 of the JAX
  package's; a mixed-adapter engine's tokens pass the tie-aware oracle of
  the JAX ``forward_full`` with the same table at both pipeline depths,
  byte-identical to the JAX engine's where the oracle's top-2 gap is clear.
- ``_page_hashes(tokens, page_size, adapter_id)`` equals the JAX engine's
  ``Engine._page_hashes`` byte for byte, and identical prompts under
  different adapters share no prefix-cache page.
- A fabric frame published by the JAX package under an adapter is imported
  by a port replica serving that adapter (and degrades for the base model),
  and a port frame is imported by the JAX package.
- An adapter is served as its own OpenAI model id, bare and qualified."""

import json
import os

import jax
import numpy as np
import pytest
import torch
import urllib.error
import urllib.request

from kubeflow_tpu.serving.engine import Engine as JEngine
from kubeflow_tpu.serving.engine import EngineConfig as JEngineConfig
from kubeflow_tpu.serving.engine import model as JM
from kubeflow_tpu.serving.engine.lora import load_adapters as jload_adapters
from kubeflow_tpu.serving.engine.serve import JetStreamModel as JJetStreamModel
from kubeflow_tpu.serving.server import ModelServer as JModelServer
from kubeflow_tpu_torch.serving.engine import engine as E
from kubeflow_tpu_torch.serving.engine import model as TM
from kubeflow_tpu_torch.serving.engine.lora import load_adapters, read_safetensors
from kubeflow_tpu_torch.serving.engine.serve import JetStreamModel
from kubeflow_tpu_torch.serving.server import ModelServer

# vocab >= 256: the byte tokenizer addresses ids 0..255
CFG_J = JM.DecoderConfig(vocab_size=288, d_model=64, n_layers=2, n_heads=4,
                         n_kv_heads=2, d_ff=96)
CFG_T = TM.DecoderConfig(**{f: getattr(CFG_J, f) for f in TM.DecoderConfig.__dataclass_fields__})
GEO = dict(max_slots=4, num_pages=96, page_size=8, max_pages_per_slot=16)
HF_DIMS = {"q_proj": (64, 64), "k_proj": (64, 32), "v_proj": (64, 32), "o_proj": (64, 64),
           "gate_proj": (64, 96), "up_proj": (64, 96), "down_proj": (96, 64)}
ALL_PROJS = tuple(HF_DIMS)
# adapter "a": rank 8 on every projection; "b": rank 4 on q, v and gate
ADAPTERS = {"a": dict(rank=8, alpha=16, projs=ALL_PROJS, seed=1),
            "b": dict(rank=4, alpha=4, projs=("q_proj", "v_proj", "gate_proj"), seed=2)}
LOGIT_TOL = 5e-2
TIE_EPS = 5e-2
STABLE_GAP = 0.07
ORACLE_LEN = 128

_forward = jax.jit(lambda p, t: JM.forward_full(p, CFG_J, t))
_forward_lora = jax.jit(lambda p, t, lp, a: JM.forward_full(
    p, CFG_J, t, lora_params=lp, adapter_ids=a))


def _tensor_name(layer: int, proj: str, which: str) -> str:
    block = "self_attn" if proj in ("q_proj", "k_proj", "v_proj", "o_proj") else "mlp"
    return f"base_model.model.model.layers.{layer}.{block}.{proj}.lora_{which}.weight"


def _write_peft(path, rank, alpha, projs, seed, layers=CFG_J.n_layers, cfg_extra=None,
                tensors=None):
    """A PEFT checkout: adapter_config.json + adapter_model.safetensors, with
    NONZERO B (PEFT initialises B to zeros, which would make every check
    vacuous)."""
    from safetensors.numpy import save_file

    os.makedirs(path, exist_ok=True)
    if tensors is None:
        rng = np.random.default_rng(seed)
        tensors = {}
        for l in range(layers):
            for proj in projs:
                din, dout = HF_DIMS[proj]
                tensors[_tensor_name(l, proj, "A")] = (
                    rng.standard_normal((rank, din)).astype(np.float32) * 0.1)
                tensors[_tensor_name(l, proj, "B")] = (
                    rng.standard_normal((dout, rank)).astype(np.float32) * 0.1)
    save_file(tensors, os.path.join(path, "adapter_model.safetensors"))
    with open(os.path.join(path, "adapter_config.json"), "w") as f:
        json.dump({"peft_type": "LORA", "r": rank, "lora_alpha": alpha,
                   "target_modules": list(projs), **(cfg_extra or {})}, f)
    return tensors


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("lora_model")
    for name, spec in ADAPTERS.items():
        _write_peft(str(d / "adapters" / name), **spec)
    return str(d)


@pytest.fixture(scope="module")
def params(model_dir):
    """(JAX params, port params, JAX lora (table, ids), port lora)."""
    jp = JM.init(jax.random.PRNGKey(0), CFG_J)
    tp = TM.params_from_jax({k: np.asarray(v) for k, v in jp.items()}, "cpu")
    return jp, tp, jload_adapters(model_dir, CFG_J), load_adapters(model_dir, CFG_T, "cpu")


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy()


# ------------------------------------------------------------ safetensors


def test_safetensors_reader_matches_safe_open(tmp_path):
    from safetensors import safe_open
    from safetensors.numpy import save_file as np_save
    from safetensors.torch import save_file as pt_save

    rng = np.random.default_rng(0)
    f32 = {"x.f32": rng.standard_normal((3, 5)).astype(np.float32),
           "y.f16": rng.standard_normal((7,)).astype(np.float16),
           "z.scalar": np.asarray(rng.standard_normal(()), np.float32)}
    np_save(f32, str(tmp_path / "a.safetensors"), metadata={"format": "np"})
    bf = {"w.bf16": torch.randn(4, 6, generator=torch.Generator().manual_seed(1)).to(torch.bfloat16),
          "v.f32": torch.arange(6, dtype=torch.float32)}
    pt_save(bf, str(tmp_path / "b.safetensors"), metadata={"format": "pt"})
    for fname in ("a.safetensors", "b.safetensors"):
        got = read_safetensors(str(tmp_path / fname))
        with safe_open(str(tmp_path / fname), framework="pt") as f:
            ref = {k: f.get_tensor(k) for k in f.keys()}
        assert set(got) == set(ref)
        for k, t in ref.items():
            assert got[k].dtype == np.float32 and got[k].shape == tuple(t.shape)
            assert np.array_equal(got[k], t.float().numpy()), k
    # a header that runs past the file, and one that is not JSON
    raw = (tmp_path / "a.safetensors").read_bytes()
    (tmp_path / "torn.safetensors").write_bytes(raw[:20])
    with pytest.raises(ValueError, match="runs past the file"):
        read_safetensors(str(tmp_path / "torn.safetensors"))
    (tmp_path / "junk.safetensors").write_bytes((4).to_bytes(8, "little") + b"{{{{")
    with pytest.raises(ValueError, match="unreadable safetensors header"):
        read_safetensors(str(tmp_path / "junk.safetensors"))


# ------------------------------------------------------------ load_adapters


def test_load_adapters_tables_are_the_jax_packages_bits(params):
    _, _, (jl, jids), (tl, tids) = params
    assert tids == jids == {"a": 1, "b": 2}
    assert set(tl) == set(jl) == set(TM._QUANT_KEYS) - {"embed", "unembed"}
    for proj in jl:
        for k in ("A", "B"):
            ref = np.asarray(jl[proj][k])
            got = tl[proj][k]
            assert got.dtype == torch.bfloat16 and tuple(got.shape) == ref.shape, (proj, k)
            assert np.array_equal(_bits(got), ref.view(np.int16)), (proj, k)
        # adapter 0 is all zeros; b's rank 4 is right-padded to a's 8
        assert not tl[proj]["A"][0].any() and not tl[proj]["B"][0].any()
    assert tl["wq"]["A"].shape[-1] == 8 and not tl["wq"]["A"][2, :, :, 4:].any()
    assert not tl["wk"]["B"][2].any()  # b does not adapt k
    assert tl["wk"]["B"][1].any()      # nonzero B: the deltas are real


def _refusal_dirs(root):
    """name -> model dir holding one bad adapter."""
    cases = {}

    def mk(name, **kw):
        d = os.path.join(root, name)
        _write_peft(os.path.join(d, "adapters", "bad"), **{
            "rank": 4, "alpha": 8, "projs": ("q_proj",), "seed": 0, **kw})
        cases[name] = d

    mk("peft_type", cfg_extra={"peft_type": "IA3"})
    mk("dora", cfg_extra={"use_dora": True})
    mk("rslora", cfg_extra={"use_rslora": True})
    mk("rank_pattern", cfg_extra={"rank_pattern": {"q_proj": 2}})
    mk("too_many_layers", layers=CFG_J.n_layers + 2)
    mk("rank_mismatch", cfg_extra={"r": 8})
    a = np.zeros((4, 64), np.float32)
    b = np.zeros((64, 4), np.float32)
    mk("half_pair", tensors={_tensor_name(0, "q_proj", "A"): a})
    mk("unknown_module", tensors={_tensor_name(0, "q_proj", "A").replace("q_proj", "qkv_proj"): a})
    mk("bad_name", tensors={"model.embed_tokens.lora_A.weight": a})
    mk("bad_component", tensors={_tensor_name(0, "q_proj", "A").replace("lora_A", "lora_C"): a})
    mk("bad_shape", tensors={_tensor_name(0, "q_proj", "A"): np.zeros((4, 48), np.float32),
                             _tensor_name(0, "q_proj", "B"): b})
    d = os.path.join(root, "missing_file")
    _write_peft(os.path.join(d, "adapters", "bad"), 4, 8, ("q_proj",), 0)
    os.remove(os.path.join(d, "adapters", "bad", "adapter_model.safetensors"))
    cases["missing_file"] = d
    return cases


REFUSALS = ["peft_type", "dora", "rslora", "rank_pattern", "too_many_layers",
            "rank_mismatch", "half_pair", "unknown_module", "bad_name", "bad_component",
            "bad_shape", "missing_file"]


@pytest.mark.parametrize("case", REFUSALS)
def test_load_adapters_refuses_what_the_jax_package_refuses(tmp_path, case):
    d = _refusal_dirs(str(tmp_path))[case]
    with pytest.raises((ValueError, FileNotFoundError)) as ref:
        jload_adapters(d, CFG_J)
    with pytest.raises((ValueError, FileNotFoundError)) as got:
        load_adapters(d, CFG_T, "cpu")
    assert type(got.value) is type(ref.value)
    assert str(got.value) == str(ref.value)


def test_no_adapters_dir_means_no_table(tmp_path):
    assert load_adapters(str(tmp_path), CFG_T, "cpu") == (None, {})
    assert load_adapters("", CFG_T, "cpu") == (None, {})
    (tmp_path / "adapters").mkdir()
    assert load_adapters(str(tmp_path), CFG_T, "cpu") == (None, {})


# --------------------------------------------------------------- forward


def test_forward_full_with_mixed_adapters_matches_jax(params):
    jp, tp, (jl, _), (tl, _) = params
    toks = np.random.default_rng(3).integers(0, CFG_J.vocab_size, (4, 19), dtype=np.int32)
    aids = np.array([0, 1, 2, 1], np.int32)
    ref = np.asarray(_forward_lora(jp, toks, jl, aids))
    with torch.inference_mode():
        got = TM.forward_full(tp, CFG_T, torch.from_numpy(toks), lora_params=tl,
                              adapter_ids=torch.from_numpy(aids)).numpy()
    np.testing.assert_allclose(got, ref, rtol=LOGIT_TOL, atol=LOGIT_TOL)
    # the adapters change the logits, and row 0 (the zero adapter) is the
    # base model's
    base = np.asarray(_forward(jp, toks))
    assert np.abs(ref[1] - base[1]).max() > 4 * LOGIT_TOL
    np.testing.assert_array_equal(ref[0], base[0])


def _oracle_rows(params, prompt, got, aid):
    jp, _, (jl, _), _ = params
    toks = list(prompt) + list(got)
    padded = np.zeros((1, ORACLE_LEN), np.int32)
    padded[0, :len(toks)] = toks
    rows = np.asarray(_forward_lora(jp, padded, jl, np.array([aid], np.int32)))
    return rows[0, len(prompt) - 1:len(toks) - 1]


def _check_tie_aware(params, prompt, got, aid):
    rows = _oracle_rows(params, prompt, got, aid)
    for i, g in enumerate(got):
        assert rows[i, g] >= rows[i].max() - TIE_EPS, (aid, i, g, int(rows[i].argmax()))
    return rows


MIXED = [("the quick brown fox jumps", None), ("the quick brown fox jumps", "a"),
         ("a different prompt, longer than a page or two of bytes", "b"),
         ("short", "a")]
N_NEW = 10


@pytest.fixture(scope="module")
def jax_mixed(params):
    jp, _, jlora, _ = params
    eng = JEngine(jp, CFG_J, JEngineConfig(**GEO), lora=jlora)
    eng.start()
    try:
        futs = [eng.generate_async(list(p.encode()), N_NEW, adapter=a) for p, a in MIXED]
        return [f.result(timeout=300)["tokens"] for f in futs]
    finally:
        eng.stop()


@pytest.mark.parametrize("depth", [1, 0])
def test_mixed_adapter_engine_matches_the_jax_engine(params, jax_mixed, depth):
    _, tp, _, tlora = params
    eng = E.Engine(tp, CFG_T, E.EngineConfig(**GEO, pipeline_depth=depth), device="cpu",
                   lora=tlora)
    eng.start()
    try:
        futs = [eng.generate_async(list(p.encode()), N_NEW, adapter=a) for p, a in MIXED]
        outs = [f.result(timeout=300)["tokens"] for f in futs]
        st = eng.stats
        assert st["free_pages"] + st["cached_pages"] == GEO["num_pages"] - 1
    finally:
        eng.stop()
    compared = 0
    for (prompt, ad), got, ref in zip(MIXED, outs, jax_mixed):
        aid = tlora[1].get(ad, 0)
        ids = list(prompt.encode())
        assert len(got) == len(ref) == N_NEW
        _check_tie_aware(params, ids, got, aid)
        rows = _check_tie_aware(params, ids, ref, aid)
        # byte-identical up to the first step whose top-2 gap is a near tie
        # (which may legally flip across frameworks)
        top2 = np.sort(rows, axis=-1)[:, -2:]
        for j in range(N_NEW):
            if top2[j, 1] - top2[j, 0] <= STABLE_GAP:
                break
            assert got[j] == ref[j], (prompt, ad, j)
            compared += 1
    assert compared >= N_NEW // 2
    # the same prompt under the base model and under "a" decodes differently
    assert outs[0] != outs[1]


def test_unknown_adapter_and_adapter_weights(params):
    _, tp, _, tlora = params
    eng = E.Engine(tp, CFG_T, E.EngineConfig(**GEO), device="cpu", lora=tlora)
    try:
        with pytest.raises(E.RequestError, match="unknown adapter 'nope'"):
            eng.generate_async([1, 2], 2, adapter="nope")
    finally:
        eng.stop()
    sched = E.SchedulerConfig(adapter_weights=(("a", 3.0),))
    eng = E.Engine(tp, CFG_T, E.EngineConfig(**GEO, scheduler=sched), device="cpu",
                   lora=tlora)
    eng.stop()
    with pytest.raises(ValueError, match=r"unknown adapter 'zz' \(loaded: \['a', 'b'\]\)"):
        E.Engine(tp, CFG_T, E.EngineConfig(
            **GEO, scheduler=E.SchedulerConfig(adapter_weights=(("zz", 1.0),))),
            device="cpu", lora=tlora)


# ----------------------------------------------------------- prefix cache


@pytest.mark.parametrize("aid", [0, 1, 2, 7, 65536])
def test_page_hashes_equal_the_jax_engines(params, aid):
    jp, tp, _, _ = params
    jeng = JEngine(jp, CFG_J, JEngineConfig(**GEO))
    teng = E.Engine(tp, CFG_T, E.EngineConfig(**GEO), device="cpu")
    try:
        rng = np.random.default_rng(aid)
        for n in (0, 7, 8, 33, 80):
            toks = [int(t) for t in rng.integers(0, 288, n)]
            ref = jeng._page_hashes(toks, aid)
            got = E._page_hashes(toks, teng.ec.page_size, aid)
            assert got.dtype == ref.dtype == np.uint64
            assert np.array_equal(got, ref)
    finally:
        teng.stop()
        jeng.stop()


def test_no_prefix_page_is_shared_across_adapters(params):
    _, tp, _, tlora = params
    eng = E.Engine(tp, CFG_T, E.EngineConfig(**GEO), device="cpu", lora=tlora)
    eng.start()
    try:
        prompt = list(b"a prompt spanning several full pages of eight tokens each")

        def hits_after(adapter):
            before = eng.stats["page_hits"]
            eng.generate(prompt, 3, adapter=adapter)
            return eng.stats["page_hits"] - before

        assert hits_after(None) == 0
        assert hits_after("a") == 0   # the base model's pages are not a's
        assert hits_after("b") == 0
        full = (len(prompt) - 1) // GEO["page_size"]
        assert hits_after("a") == full  # a's own pages are
        assert hits_after(None) == full
    finally:
        eng.stop()


# --------------------------------------------------------------- fabric


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60) as r:
        return json.loads(r.read())


def _post(port, path, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


SHARED = "You are a helpful assistant tuned by this adapter. " * 2


@pytest.mark.parametrize("owner", ["jax", "port"])
def test_fabric_frame_under_an_adapter_crosses_packages(params, owner):
    jp, tp, jlora, tlora = params
    mk_j = lambda: JEngine(jp, CFG_J, JEngineConfig(**GEO, fabric=True), lora=jlora)  # noqa: E731
    mk_t = lambda: E.Engine(tp, CFG_T, E.EngineConfig(**GEO, fabric=True),  # noqa: E731
                            device="cpu", lora=tlora)
    a_eng, b_eng = (mk_j(), mk_t()) if owner == "jax" else (mk_t(), mk_j())
    a_srv = (JModelServer if owner == "jax" else ModelServer)(
        [(JJetStreamModel("m", "", engine=a_eng) if owner == "jax"
          else JetStreamModel("m", engine=a_eng))], port=0)
    b_srv = (ModelServer if owner == "jax" else JModelServer)(
        [(JetStreamModel("m", engine=b_eng) if owner == "jax"
          else JJetStreamModel("m", "", engine=b_eng))], port=0)
    a_srv.start()
    b_srv.start()
    try:
        code, _ = _post(a_srv.port, "/v2/models/m/generate",
                        {"text_input": SHARED + "Q1", "parameters": {"max_tokens": 2,
                                                                     "adapter": "a"}})
        assert code == 200
        view = a_eng.fabric_view()
        assert view
        hint = {"key": view[0]["key"], "source_port": a_srv.port, "pages": view[0]["pages"]}
        code, out = _post(b_srv.port, "/v2/models/m/generate",
                          {"text_input": SHARED + "Q2",
                           "parameters": {"max_tokens": 6, "adapter": "a", "fabric": hint}})
        assert code == 200 and out["fabric"]["restore"] == "hit"
        _check_tie_aware(params, list((SHARED + "Q2").encode()), out["token_ids"], 1)
        # the same frame for the base model: adapter mismatch, degraded
        code, out = _post(b_srv.port, "/v2/models/m/generate",
                          {"text_input": SHARED + "Q3",
                           "parameters": {"max_tokens": 2, "fabric": hint}})
        assert code == 200 and out["fabric"]["restore"] == "degraded"
    finally:
        b_srv.stop()
        a_srv.stop()
        b_eng.stop()
        a_eng.stop()


# --------------------------------------------------------------- OpenAI


def test_adapter_is_served_as_an_openai_model_id(params):
    _, tp, _, tlora = params
    eng = E.Engine(tp, CFG_T, E.EngineConfig(**GEO), device="cpu", lora=tlora)
    srv = ModelServer([JetStreamModel("llm", engine=eng)], port=0)
    srv.start()
    try:
        by_id = {m["id"]: m for m in _get(srv.port, "/openai/v1/models")["data"]}
        assert by_id["a"]["root"] == by_id["b"]["root"] == "llm"
        code, want = _post(srv.port, "/v2/models/llm/generate",
                           {"text_input": "ab", "parameters": {"max_tokens": 4, "adapter": "b"}})
        assert code == 200
        for mid in ("b", "llm:b"):
            code, out = _post(srv.port, "/openai/v1/completions",
                              {"model": mid, "prompt": "ab", "max_tokens": 4})
            assert code == 200 and out["usage"]["completion_tokens"] == 4
            assert out["choices"][0]["text"] == want["text_output"]
        assert _post(srv.port, "/openai/v1/completions",
                     {"model": "nope", "prompt": "ab", "max_tokens": 2})[0] == 404
        code, out = _post(srv.port, "/v2/models/llm/generate",
                          {"text_input": "ab", "parameters": {"adapter": "zz"}})
        assert code == 400 and "unknown adapter 'zz'" in out["error"]
        code, out = _post(srv.port, "/v1/models/llm:predict",
                          {"instances": [{"prompt": "ab", "max_tokens": 2, "adapter": "a"}]})
        assert code == 200 and out["predictions"][0]["tokens"] == 2
    finally:
        srv.stop()
        eng.stop()


def test_jetstream_model_loads_the_adapters_dir(model_dir, params):
    """``JetStreamModel.load`` reads ``adapters/`` beside the weights, as the
    JAX package's does."""
    with open(os.path.join(model_dir, "config.json"), "w") as f:
        json.dump({f: getattr(CFG_J, f) for f in ("vocab_size", "d_model", "n_layers",
                                                   "n_heads", "n_kv_heads", "d_ff")}, f)
    try:
        m = JetStreamModel("m", model_dir, device="cpu")
        m.load()
        jm = JJetStreamModel("m", model_dir)
        jm.load()
        try:
            assert m.adapters == jm.adapters == {"a": 1, "b": 2}
            out = m.generate({"text_input": "hi", "parameters": {"max_tokens": 2,
                                                                 "adapter": "b"}})
            assert out["tokens"] == 2
        finally:
            m.engine.stop()
            jm.engine.stop()
    finally:
        os.remove(os.path.join(model_dir, "config.json"))
