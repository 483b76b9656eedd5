"""Port parity: the agent's ``ChatSession`` and ``ModelPuller``.

- ``ChatSession`` over a tiny engine whose model dir holds a
  tokenizers-library ``tokenizer.json`` (``WordLevel`` with a BOS
  template): three turns carry the same context ids as the JAX package's
  session (BOS prepended to every turn's new text, as the library encodes
  it, so the pinned chain hashes see the same ids), the same replies and
  transcript, and the same restore history (cold, then warm); ``end()``
  drops the pin in both.
- ``ModelPuller.sync`` against the control plane's ``APIServer`` downloads
  (through the port's copy of ``storage.download``) what the JAX puller
  downloads, registers and unregisters the same models, and is
  level-triggered."""

import json
import os

import jax
import numpy as np
import pytest
from tokenizers import Tokenizer, models, pre_tokenizers, processors

from kubeflow_tpu.core.api import CRD, APIServer
from kubeflow_tpu.serving.agent import ChatSession as JChatSession
from kubeflow_tpu.serving.agent import ModelPuller as JModelPuller
from kubeflow_tpu.serving.engine import Engine as JEngine
from kubeflow_tpu.serving.engine import EngineConfig as JEngineConfig
from kubeflow_tpu.serving.engine import KVStoreConfig as JKVStoreConfig
from kubeflow_tpu.serving.engine import model as JM
from kubeflow_tpu.serving.engine.serve import JetStreamModel as JJetStreamModel
from kubeflow_tpu_torch.serving.agent import ChatSession, ModelPuller
from kubeflow_tpu_torch.serving.engine import model as TM
from kubeflow_tpu_torch.serving.engine.engine import Engine, EngineConfig
from kubeflow_tpu_torch.serving.engine.kvstore import KVStoreConfig
from kubeflow_tpu_torch.serving.engine.serve import JetStreamModel

WORDS = ["<unk>", "hello", "world", "tell", "me", "more", "about", "it", "yes",
         "no", "ok", "and", "<s>"]
CFG_J = JM.DecoderConfig(vocab_size=len(WORDS), d_model=64, n_layers=2, n_heads=4,
                         n_kv_heads=2, d_ff=128)
CFG_T = TM.DecoderConfig(**{f: getattr(CFG_J, f) for f in TM.DecoderConfig.__dataclass_fields__})
GEO = dict(max_slots=2, num_pages=64, page_size=4, max_pages_per_slot=16)
TURNS = ["hello world tell me more", "yes and more about it", "ok no hello world"]


def _tokenizer_dir(d) -> str:
    tok = Tokenizer(models.WordLevel({w: i for i, w in enumerate(WORDS)}, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.add_special_tokens(["<s>"])
    tok.post_processor = processors.TemplateProcessing(
        single="<s> $A", special_tokens=[("<s>", WORDS.index("<s>"))])
    os.makedirs(d, exist_ok=True)
    tok.save(os.path.join(d, "tokenizer.json"))
    return str(d)


def _chat(model):
    chat = (ChatSession if isinstance(model, JetStreamModel) else JChatSession)(
        model, session_id="s1", max_tokens=6)
    outs = [chat.turn(t) for t in TURNS]
    record = {"context_ids": list(chat.context_ids), "transcript": chat.transcript,
              "history": list(chat.restore_history),
              "replies": [o["token_ids"] for o in outs],
              "prompt_tokens": [o["prompt_tokens"] for o in outs],
              "pinned": [bool((o["session"] or {}).get("pinned")) for o in outs]}
    assert chat.session_id in model.engine.sessions()
    assert chat.end()
    assert chat.session_id not in model.engine.sessions()
    return record


def test_chat_session_matches_jax(tmp_path):
    d = _tokenizer_dir(tmp_path / "model")
    jp = JM.init(jax.random.PRNGKey(0), CFG_J)
    tp = TM.params_from_jax({k: np.asarray(v) for k, v in jp.items()}, "cpu")
    jeng = JEngine(jp, CFG_J, JEngineConfig(
        **GEO, kv_store=JKVStoreConfig(disk_dir=str(tmp_path / "jkv"))))
    teng = Engine(tp, CFG_T, EngineConfig(
        **GEO, kv_store=KVStoreConfig(disk_dir=str(tmp_path / "tkv"))), device="cpu")
    jm, tm = JJetStreamModel("llm", d, engine=jeng), JetStreamModel("llm", d, engine=teng)
    jm.load()
    tm.load()
    try:
        want, got = _chat(jm), _chat(tm)
    finally:
        jeng.stop()
        teng.stop()
    assert got == want
    bos = WORDS.index("<s>")
    # every turn's new text starts with BOS, as the library encodes it
    assert got["context_ids"].count(bos) == len(TURNS)
    assert got["history"][0] == "cold" and all(h in ("host", "disk") for h in got["history"][1:])
    assert got["transcript"].startswith(TURNS[0])


def test_chat_session_refuses_engineless_model():
    with pytest.raises(ValueError, match="engine-backed"):
        ChatSession(JetStreamModel("llm", "", device="cpu"))


def _trained_model(name, isvc, uri):
    return {"apiVersion": "serving.kserve.io/v1alpha1", "kind": "TrainedModel",
            "metadata": {"name": name}, "spec": {"inferenceService": isvc,
                                                  "model": {"storageUri": uri}}}


def _run_puller(api_cls, crd_cls, puller_cls, tmp_path, src, tag):
    api = api_cls()
    api.register_crd(crd_cls(group="serving.kserve.io", version="v1alpha1",
                             kind="TrainedModel", plural="trainedmodels"))
    calls = []
    repo = tmp_path / f"repo_{tag}"
    puller = puller_cls(api, "llm", str(repo),
                        add_model=lambda n, p: calls.append(("add", n, os.path.relpath(p, repo))),
                        remove_model=lambda n: calls.append(("remove", n)))
    api.create(_trained_model("m1", "llm", f"file://{src / 'v1'}"))
    api.create(_trained_model("m2", "llm", f"file://{src / 'v1' / 'weights.txt'}"))
    api.create(_trained_model("other", "not-llm", f"file://{src / 'v1'}"))
    changed = [puller.sync(), puller.sync()]
    tm = api.get("TrainedModel", "m1", "default")
    tm["spec"]["model"]["storageUri"] = f"file://{src / 'v2'}"
    api.update(tm)
    changed.append(puller.sync())
    api.try_delete("TrainedModel", "m2", "default")
    changed.append(puller.sync())
    tree = {}
    for root, _, files in os.walk(repo):
        for f in files:
            with open(os.path.join(root, f)) as fh:
                tree[os.path.relpath(os.path.join(root, f), repo)] = fh.read()
    return changed, calls, tree, dict(puller.loaded)


def test_model_puller_matches_jax(tmp_path):
    src = tmp_path / "src"
    for v in ("v1", "v2"):
        (src / v / "sub").mkdir(parents=True)
        (src / v / "weights.txt").write_text(f"weights {v}")
        (src / v / "sub" / "config.json").write_text(json.dumps({"v": v}))
    want = _run_puller(APIServer, CRD, JModelPuller, tmp_path, src, "jax")
    got = _run_puller(APIServer, CRD, ModelPuller, tmp_path, src, "port")
    assert got == want
    changed, calls, tree, loaded = got
    assert changed == [True, False, True, True]
    assert ("remove", "m2") in calls and "other" not in loaded
    assert tree["m1/weights.txt"] == "weights v2" and tree["m2/weights.txt"] == "weights v1"
