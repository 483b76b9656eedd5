"""Port parity: serving an unconverted HuggingFace checkout.

``kubeflow_tpu_torch/serving/engine/hf_convert.py`` is a copy of the JAX
package's converter that reads shards with the port's own safetensors
reader.  On tiny checkouts written by ``transformers.save_pretrained``, by
the ``safetensors`` package in two shards with an index, and as a
``pytorch_model.bin``, in f32 and in bf16:

- both converters write the same ``params.npz`` members, byte for byte
  (the zip's timestamps aside), and equal ``config.json``s, for Llama
  (tied and untied), Gemma-1 and the Nemo-style decoupled ``head_dim``,
  at both storage dtypes;
- a non-Llama type, ``rope_scaling``, a Gemma ``hidden_activation``, a
  missing tensor, an unmapped tensor, a non-finite fp16 value and a dir
  without weights raise the same exception with the same message;
- a crash between the two writes leaves the dir unconverted, and the next
  ``JetStreamModel.load`` converts it again and serves;
- ``JetStreamModel.load`` on an unconverted Llama, Mistral or Gemma
  checkout with a tokenizers-library ``tokenizer.json`` serves the JAX
  package's greedy tokens (tie-aware against the JAX ``forward_full``) over
  ``/v2`` text generate and the OpenAI completions route;
- the converted logits match the ``transformers`` forward at the JAX test's
  rtol/atol of 2e-3."""

import gc
import json
import os
import shutil
import urllib.request
import zipfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

# the checkouts are torch models: keep transformers from importing
# TensorFlow (seconds of import and a pool of threads per worker process)
os.environ.setdefault("USE_TF", "0")
transformers = pytest.importorskip("transformers")
safetensors_torch = pytest.importorskip("safetensors.torch")
tokenizers = pytest.importorskip("tokenizers")

from kubeflow_tpu.serving.engine import hf_convert as JH  # noqa: E402
from kubeflow_tpu.serving.engine import model as JM  # noqa: E402
from kubeflow_tpu.serving.engine.serve import JetStreamModel as JJetStreamModel  # noqa: E402
from kubeflow_tpu.serving.server import ModelServer as JModelServer  # noqa: E402
from kubeflow_tpu_torch.serving.engine import hf_convert as TH  # noqa: E402
from kubeflow_tpu_torch.serving.engine import model as TM  # noqa: E402
from kubeflow_tpu_torch.serving.engine.serve import JetStreamModel  # noqa: E402
from kubeflow_tpu_torch.serving.server import ModelServer  # noqa: E402

TIE_EPS = 5e-2      # the cross-framework bf16 logit tolerance (test_torch_model.py)
STABLE_GAP = 0.07   # a top-2 gap above this cannot flip across frameworks


def _hf_model(kind: str, vocab: int = 128):
    torch.manual_seed(0)
    common = dict(vocab_size=vocab, hidden_size=64, intermediate_size=112,
                  num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                  rope_theta=10000.0)
    if kind in ("llama", "llama_tied", "nemo"):
        cfg = transformers.LlamaConfig(
            rms_norm_eps=1e-5, tie_word_embeddings=kind == "llama_tied",
            attention_bias=False, mlp_bias=False,
            **({"head_dim": 32} if kind == "nemo" else {}), **common)
        return transformers.LlamaForCausalLM(cfg).eval()
    if kind == "mistral":
        cfg = transformers.MistralConfig(rms_norm_eps=1e-5, tie_word_embeddings=False,
                                         sliding_window=None, **common)
        return transformers.MistralForCausalLM(cfg).eval()
    if kind == "gemma":
        cfg = transformers.GemmaConfig(
            vocab_size=vocab, hidden_size=48, intermediate_size=96, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, head_dim=16,
            rope_theta=10000.0, rms_norm_eps=1e-6)
        return transformers.GemmaForCausalLM(cfg).eval()
    raise ValueError(kind)


def _write(model, d, how: str, dtype) -> str:
    """An HF checkout of ``model`` in ``d``: ``save_pretrained``, two
    safetensors shards with an index, or a ``pytorch_model.bin``."""
    d = str(d)
    model = model.to(dtype)
    if how == "save_pretrained":
        model.save_pretrained(d)
        return d
    os.makedirs(d, exist_ok=True)
    model.config.save_pretrained(d)
    sd = {k: v.detach().clone().contiguous() for k, v in model.state_dict().items()}
    if model.config.tie_word_embeddings:
        sd.pop("lm_head.weight", None)
    if how == "bin":
        torch.save(sd, os.path.join(d, "pytorch_model.bin"))
        return d
    names = sorted(sd)
    shards = {"model-00001-of-00002.safetensors": names[: len(names) // 2],
              "model-00002-of-00002.safetensors": names[len(names) // 2:]}
    index = {"metadata": {}, "weight_map": {}}
    for fname, keys in shards.items():
        safetensors_torch.save_file({k: sd[k] for k in keys}, os.path.join(d, fname),
                                    metadata={"format": "pt"})
        index["weight_map"].update({k: fname for k in keys})
    with open(os.path.join(d, "model.safetensors.index.json"), "w") as f:
        json.dump(index, f)
    return d


@pytest.fixture(autouse=True, scope="module")
def _unfreeze_after():
    yield
    gc.unfreeze()


def _frozen(fn, *a, **kw):
    """``fn`` with the heap as it stands moved out of the collector's sight
    (``gc.freeze``): both converters call ``gc.collect()`` once per stacked
    name, which scans every object JAX, torch and transformers allocated in
    this process (~0.3 s a call here) and changes nothing they compute."""
    gc.freeze()
    return fn(*a, **kw)


def _members(path) -> list:
    with zipfile.ZipFile(path) as z:
        return [(i.filename, z.read(i.filename)) for i in z.infolist()]


def _convert_both(src, tmp_path, dtype: str):
    jout, tout = tmp_path / "jax_out", tmp_path / "port_out"
    jcfg = _frozen(JH.convert_hf_checkpoint, src, str(jout), dtype)
    tcfg = _frozen(TH.convert_hf_checkpoint, src, str(tout), dtype)
    return jout, tout, jcfg, tcfg


@pytest.mark.parametrize("out_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("src_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("how", ["save_pretrained", "safetensors", "bin"])
@pytest.mark.parametrize("kind", ["llama", "llama_tied", "gemma", "nemo"])
def test_converters_write_identical_params(tmp_path, kind, how, src_dtype, out_dtype):
    src = _write(_hf_model(kind), tmp_path / "hf", how, src_dtype)
    jout, tout, jcfg, tcfg = _convert_both(src, tmp_path, out_dtype)
    assert tcfg == jcfg
    assert (json.loads((tout / "config.json").read_text())
            == json.loads((jout / "config.json").read_text()))
    jm, tm = _members(jout / "params.npz"), _members(tout / "params.npz")
    assert [n for n, _ in tm] == [n for n, _ in jm]
    for (name, a), (_, b) in zip(tm, jm):
        assert a == b, name
    assert sorted(os.listdir(tout)) == ["config.json", "params.npz"]


def _raises_alike(run_jax, run_port):
    with pytest.raises(Exception) as je:
        run_jax()
    with pytest.raises(Exception) as te:
        run_port()
    assert type(te.value) is type(je.value)
    assert str(te.value) == str(je.value)
    return te.value


def _mini_config(d, **over):
    base = {"model_type": "llama", "vocab_size": 64, "hidden_size": 32,
            "num_hidden_layers": 1, "num_attention_heads": 4, "intermediate_size": 64}
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump({**base, **over}, f)
    return str(d)


@pytest.mark.parametrize("case", ["model_type", "rope_scaling", "gemma_activation",
                                  "missing", "unmapped", "non_finite", "no_weights"])
def test_refusals_match_the_jax_converter(tmp_path, case):
    if case == "model_type":
        src = _mini_config(tmp_path / "hf", model_type="gemma2")
    elif case == "rope_scaling":
        src = _mini_config(tmp_path / "hf", rope_scaling={"rope_type": "llama3", "factor": 8.0})
    elif case == "gemma_activation":
        src = _mini_config(tmp_path / "hf", model_type="gemma", hidden_activation="gelu")
    elif case == "no_weights":
        src = _mini_config(tmp_path / "hf")
    else:
        src = _write(_hf_model("llama"), tmp_path / "hf", "safetensors", torch.float32)
        shard = os.path.join(src, "model-00001-of-00002.safetensors")
        sd = safetensors_torch.load_file(shard)
        if case == "missing":
            sd.pop(sorted(k for k in sd if ".layers." in k)[-1])
        elif case == "unmapped":
            sd["model.extra_block.weight"] = torch.zeros(4)
        elif case == "non_finite":
            key = sorted(k for k in sd if "proj" in k)[0]
            sd[key][0, 0] = 1e6  # past fp16's 65504
        safetensors_torch.save_file(sd, shard)
    err = _raises_alike(lambda: _frozen(JH.convert_hf_checkpoint, src, str(tmp_path / "j")),
                        lambda: _frozen(TH.convert_hf_checkpoint, src, str(tmp_path / "t")))
    assert isinstance(err, (ValueError, FileNotFoundError))
    # nothing written on a refusal
    assert not os.path.exists(tmp_path / "t" / "config.json")


def test_unknown_shard_dtype_is_named(tmp_path):
    """A tag the port's reader cannot size (an fp8 variant) is named; an
    integer tensor the mapper never asks for (a rotary buffer) reads."""
    src = _write(_hf_model("llama"), tmp_path / "hf", "safetensors", torch.float32)
    shard = os.path.join(src, "model-00002-of-00002.safetensors")
    sd = safetensors_torch.load_file(shard)
    sd["model.layers.0.self_attn.rotary_emb.inv_freq"] = torch.arange(4, dtype=torch.int64)
    safetensors_torch.save_file(sd, shard)
    jout, tout, jcfg, tcfg = _convert_both(src, tmp_path, "bfloat16")
    assert tcfg == jcfg
    sd["x"] = torch.zeros(2, dtype=torch.float8_e4m3fn)
    safetensors_torch.save_file(sd, shard)
    with pytest.raises(ValueError, match="unsupported dtype 'F8_E4M3'"):
        _frozen(TH.convert_hf_checkpoint, src, str(tmp_path / "t2"))


def test_from_dir_names_the_ports_converter(tmp_path):
    _mini_config(tmp_path)
    with pytest.raises(ValueError) as e:
        TM.DecoderConfig.from_dir(str(tmp_path))
    msg = str(e.value)
    assert "HuggingFace config" in msg and "kubeflow_tpu_torch.serving.engine.hf_convert" in msg
    assert "auto-converts on load" in msg
    assert TH.is_hf_config({"model_type": "llama"}) and not TH.is_hf_config({"d_model": 8})
    assert TM.is_hf_config is TH.is_hf_config  # one copy in the port


# ------------------------------------------------------------------ serving

VOCAB = 300


def _tokenizer_json() -> str:
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers, processors, trainers

    tok = Tokenizer(models.BPE())
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = decoders.ByteLevel()
    text = ["The converted checkout serves text prompts over HTTP, tokenized "
            "by the checkout's own tokenizer.json. " * 4]
    tok.train_from_iterator(text, trainers.BpeTrainer(
        vocab_size=290, show_progress=False,
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet()))
    tok.add_special_tokens(["<s>", "</s>"])
    tok.post_processor = processors.TemplateProcessing(
        single="<s> $A", special_tokens=[("<s>", tok.token_to_id("<s>"))])
    assert tok.get_vocab_size() <= VOCAB
    return tok.to_str()


def _checkout(tmp_path, kind: str) -> str:
    src = _write(_hf_model(kind, VOCAB), tmp_path / "hf", "save_pretrained", torch.bfloat16)
    with open(os.path.join(src, "tokenizer.json"), "w") as f:
        f.write(_tokenizer_json())
    with open(os.path.join(src, "engine.json"), "w") as f:
        json.dump({"max_slots": 2, "num_pages": 32, "page_size": 8,
                   "max_pages_per_slot": 8, "eos_id": -1}, f)
    return src


def _post(port, path, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def _serve(model_cls, server_cls, d, prompts, **kw):
    m = model_cls("m", d, **kw)
    gc.freeze()  # the load converts: see _frozen
    srv = server_cls([m], port=0)
    srv.start()
    try:
        gens = [_post(srv.port, "/v2/models/m/generate",
                      {"text_input": p, "parameters": {"max_tokens": 6}}) for p in prompts]
        comp = _post(srv.port, "/openai/v1/completions",
                     {"model": "m", "prompt": prompts[0], "max_tokens": 6})
        return m, gens, comp
    finally:
        srv.stop()
        m.engine.stop()


def _jax_logits(jp, cfg, ids):
    return np.asarray(JM.forward_full(jp, cfg, jnp.asarray([ids], jnp.int32)))[0]


@pytest.mark.parametrize("kind", ["llama", "mistral", "gemma"])
def test_unconverted_checkout_serves_the_jax_tokens(tmp_path, kind):
    src = _checkout(tmp_path, kind)
    jdir, tdir = str(tmp_path / "jax_dir"), str(tmp_path / "port_dir")
    shutil.copytree(src, jdir)
    shutil.copytree(src, tdir)
    prompts = ["The converted checkout serves", "tokenized by its own tokenizer"]
    jm, jgens, jcomp = _serve(JJetStreamModel, JModelServer, jdir, prompts)
    tm, tgens, tcomp = _serve(JetStreamModel, ModelServer, tdir, prompts, device="cpu")
    # converted in place, to the same bytes
    assert not JH.hf_dir_needs_conversion(tdir)
    assert _members(os.path.join(tdir, "params.npz")) == _members(os.path.join(jdir, "params.npz"))
    assert type(tm.tokenizer).__name__ == type(jm.tokenizer).__name__ == "HFTokenizer"
    jcfg = JM.DecoderConfig.from_dir(jdir)
    jp = JM.load_params(jdir, jcfg)
    for p, jg, tg in zip(prompts, jgens, tgens):
        ids = tm.tokenizer.encode(p)
        assert ids == jm.tokenizer.encode(p) and ids[0] == tm.tokenizer.encode("")[0]
        got, want = tg["token_ids"], jg["token_ids"]
        assert len(got) == len(want) == 6
        assert tg["text_output"] == tm.tokenizer.decode(got)
        logits = _jax_logits(jp, jcfg, ids + got)
        for i, g in enumerate(got):  # tie-aware along the port's own trajectory
            row = logits[len(ids) - 1 + i]
            assert row[g] >= row.max() - TIE_EPS, (i, g, int(row.argmax()))
        if got != want:  # only a near tie may flip
            k = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
            row = np.sort(_jax_logits(jp, jcfg, ids + want)[len(ids) - 1 + k])
            assert row[-1] - row[-2] < STABLE_GAP
    assert tcomp["choices"][0]["text"] == tgens[0]["text_output"]
    assert jcomp["choices"][0]["text"] == jgens[0]["text_output"]


def test_crash_between_the_writes_reconverts_on_load(tmp_path, monkeypatch):
    src = _checkout(tmp_path, "llama")

    def torn(*a, **kw):
        raise OSError("disk full")

    with monkeypatch.context() as mp:
        mp.setattr(TH.json, "dump", torn)  # config.json is the last write
        with pytest.raises(OSError, match="disk full"):
            _frozen(TH.convert_hf_checkpoint, src, src)
    assert os.path.exists(os.path.join(src, "params.npz"))
    assert TH.hf_dir_needs_conversion(src)  # still the HF config.json
    with pytest.raises(ValueError, match="HuggingFace config"):
        TM.DecoderConfig.from_dir(src)
    m = JetStreamModel("m", src, device="cpu")
    _frozen(m.load)
    try:
        assert not TH.hf_dir_needs_conversion(src)
        out = m.generate({"text_input": "The converted checkout", "parameters": {"max_tokens": 3}})
        assert out["tokens"] == 3
    finally:
        m.engine.stop()
    assert not os.path.exists(os.path.join(src, "params.npz.tmp"))


def test_checkout_eos_survives_conversion(tmp_path):
    """The EOS fallback reads ``eos_token_id`` from the converted
    ``config.json`` (passed through) when there is no generation config."""
    src = _checkout(tmp_path, "llama")
    os.remove(os.path.join(src, "engine.json"))
    for f in ("generation_config.json",):
        if os.path.exists(os.path.join(src, f)):
            os.remove(os.path.join(src, f))
    raw = json.loads(open(os.path.join(src, "config.json")).read())
    raw["eos_token_id"] = [5, 7]
    with open(os.path.join(src, "config.json"), "w") as f:
        json.dump(raw, f)
    _frozen(TH.convert_hf_checkpoint, src, src)
    assert json.loads(open(os.path.join(src, "config.json")).read())["eos_token_id"] == [5, 7]
    from kubeflow_tpu_torch.serving.engine.serve import _checkout_eos_ids

    assert _checkout_eos_ids(src) == [5, 7]


@pytest.mark.parametrize("kind", ["llama", "llama_tied", "gemma"])
def test_converted_logits_match_transformers(tmp_path, kind):
    hf = _hf_model(kind)
    src = _write(hf, tmp_path / "hf", "save_pretrained", torch.float32)
    out = tmp_path / "engine"
    _frozen(TH.convert_hf_checkpoint, src, str(out), dtype="float32")
    config = TM.DecoderConfig.from_dir(str(out))
    with np.load(out / "params.npz") as z:
        params = {k: torch.from_numpy(z[k]) for k in z.files}
    toks = np.array([[5, 17, 99, 3, 42, 7]], np.int64)
    with torch.no_grad():
        ref = hf(torch.from_numpy(toks)).logits.numpy()
        got = TM.forward_full(params, config, torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(got, ref, rtol=2e-3, atol=2e-3)


def test_converted_params_load_as_bf16(tmp_path):
    """``load_params`` casts the converted fp16 (and f32) file to bf16 on
    the device, as the JAX package's does, bit for bit."""
    src = _write(_hf_model("llama"), tmp_path / "hf", "save_pretrained", torch.bfloat16)
    for dtype in ("bfloat16", "float32"):
        out = tmp_path / dtype
        _frozen(TH.convert_hf_checkpoint, src, str(out), dtype)
        cfg = TM.DecoderConfig.from_dir(str(out))
        got = TM.load_params(str(out), cfg, "cpu")
        want = JM.load_params(str(out), JM.DecoderConfig.from_dir(str(out)))
        for k, v in want.items():
            assert got[k].dtype == torch.bfloat16
            np.testing.assert_array_equal(got[k].view(torch.int16).numpy(),
                                          np.asarray(v).view(np.int16))
