"""Port parity: failover re-admission (``resume_token_ids``) in kubeflow_tpu_torch.

The ingress's failover relay re-submits a broken request's original body
with ``parameters.resume_token_ids`` set to the ids it already relayed; the
replica folds them into the prompt and returns or streams only the
continuation.  Held here on weights carried over from the JAX package:
- unary and stream: the continuation equals the unbroken run's tail,
  exactly within the port on the sync loop, tie-aware against the JAX
  package's resumed run;
- a resume that already holds every token (``max_new <= 0``) answers as
  the JAX package does, byte for byte;
- the seam when the resumed ids end inside a UTF-8 sequence slices at the
  stable prefix of the resumed text (``_stable_len``), as in the JAX
  package;
- malformed ``resume_token_ids`` are refused with the JAX package's 400."""

import json
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kubeflow_tpu.serving.engine import Engine as JEngine
from kubeflow_tpu.serving.engine import EngineConfig as JEngineConfig
from kubeflow_tpu.serving.engine import model as JM
from kubeflow_tpu.serving.engine.serve import JetStreamModel as JJetStreamModel
from kubeflow_tpu.serving.server import ModelServer as JModelServer
from kubeflow_tpu_torch.serving.engine import engine as E
from kubeflow_tpu_torch.serving.engine import model as TM
from kubeflow_tpu_torch.serving.engine.serve import JetStreamModel
from kubeflow_tpu_torch.serving.server import ModelServer

CFG_J = JM.DecoderConfig(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
                         n_kv_heads=2, d_ff=128)
CFG_T = TM.DecoderConfig(**{f: getattr(CFG_J, f) for f in TM.DecoderConfig.__dataclass_fields__})
# the sync loop: the exactness oracle within the port
GEO = dict(max_slots=2, num_pages=96, page_size=8, max_pages_per_slot=24, pipeline_depth=0)
ORACLE_LEN = 96
TIE_EPS = 5e-2
PROMPTS = ["hello world", "The quick brown fox", "kubeflow on an H100"]
N, CUT = 16, 6
RESUME = {"X-Stream-Resume": "1"}


@pytest.fixture(scope="module")
def models():
    jp = JM.init(jax.random.PRNGKey(5), CFG_J)
    tp = TM.params_from_jax({k: np.asarray(v) for k, v in jp.items()}, "cpu")
    jm = JJetStreamModel("m", engine=JEngine(jp, CFG_J, JEngineConfig(**GEO)))
    tm = JetStreamModel("m", engine=E.Engine(tp, CFG_T, E.EngineConfig(**GEO), device="cpu"))
    jm.load()
    tm.load()
    yield jp, jm, tm
    tm.engine.stop()
    jm.engine.stop()


def _body(prompt, n=N, **params):
    return {"text_input": prompt, "parameters": {"max_tokens": n, **params}}


def _tie_aware(jp, ids, got):
    toks = list(ids) + list(got)
    padded = np.zeros((1, ORACLE_LEN), np.int32)
    padded[0, :len(toks)] = toks
    rows = np.asarray(JM.forward_full(jp, CFG_J, jnp.asarray(padded)))[0]
    for i, g in enumerate(got):
        row = rows[len(ids) - 1 + i]
        assert row[g] >= row.max() - TIE_EPS, (i, g, int(row.argmax()))


def _streamed(model, body, headers=RESUME):
    events = list(model.generate_stream(body, headers))
    ids = [t for e in events for t in e.get("token_ids", ())]
    return events, ids, "".join(e["text_output"] for e in events)


@pytest.mark.parametrize("surface", ["unary", "stream"])
def test_resume_continues_the_unbroken_run(models, surface):
    jp, jm, tm = models
    for prompt in PROMPTS:
        whole = tm.generate(_body(prompt))
        resume = whole["token_ids"][:CUT]
        body = _body(prompt, resume_token_ids=resume)
        if surface == "unary":
            out = tm.generate(body)
            ref = jm.generate(body)
            cont, text, tokens = out["token_ids"], out["text_output"], out["tokens"]
            assert set(out) == set(ref)
            ref_cont = ref["token_ids"]
        else:
            events, cont, text = _streamed(tm, body)
            tokens = events[-1]["tokens"]
            ref_events, ref_cont, _ = _streamed(jm, body)
            assert set(events[-1]) == set(ref_events[-1])
        # exactly the unbroken run's tail, and the resumed count in "tokens"
        assert cont == whole["token_ids"][CUT:]
        assert tokens == N
        decoded = tm.tokenizer.decode(whole["token_ids"])
        seam = JetStreamModel._stable_len(tm.tokenizer.decode(resume))
        assert text == decoded[seam:]
        # tie-aware against the JAX package's resumed continuation
        _tie_aware(jp, list(prompt.encode()) + resume, cont)
        _tie_aware(jp, list(prompt.encode()) + resume, ref_cont)


def test_resume_with_every_token_already_generated(models):
    """max_new <= 0: nothing is submitted; the answer is the JAX package's."""
    _, jm, tm = models
    before = tm.engine.stats["prefill_dispatches"]
    # a resume ending inside a UTF-8 sequence: the held-back tail comes out
    for resume in ([104, 105, 33, 10], [104, 0xE2, 0x82], [0xF0, 0x9F, 0x98, 0x80]):
        for n in (len(resume), len(resume) - 1):
            body = _body("hello", n, resume_token_ids=resume)
            got, ref = tm.generate(body), jm.generate(body)
            assert got == ref and got["tokens"] == len(resume)
            assert list(tm.generate_stream(body)) == list(jm.generate_stream(body))
    assert tm.engine.stats["prefill_dispatches"] == before


def test_resume_seam_inside_a_utf8_sequence(models):
    """Resumed ids ending mid-sequence decode to U+FFFD placeholders that the
    previous replica held back; the continuation's text starts at the
    stable prefix of the resumed text, in both packages, unary and
    streamed."""
    jp, jm, tm = models
    cases = ["", "a", "ab�", "��", "x���", "����"]
    for s in cases:
        for floor in (0, 1):
            assert (JetStreamModel._stable_len(s, floor)
                    == JJetStreamModel._stable_len(s, floor)), (s, floor)
    for resume in ([0xE2, 0x82], [104, 0xF0, 0x9F]):
        body = _body("hello world", 10, resume_token_ids=resume)
        out, ref = tm.generate(body), jm.generate(body)
        full = tm.tokenizer.decode(resume + out["token_ids"])
        assert out["text_output"] == full[JetStreamModel._stable_len(
            tm.tokenizer.decode(resume)):]
        if out["token_ids"] == ref["token_ids"]:
            assert out["text_output"] == ref["text_output"]
        _tie_aware(jp, list(b"hello world") + resume, out["token_ids"])
        _, ids, text = _streamed(tm, body)
        assert ids == out["token_ids"] and text == out["text_output"]


def _post(port, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/v2/models/m/generate",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_malformed_resume_ids_get_the_jax_packages_400(models):
    _, jm, tm = models
    srv, jsrv = ModelServer([tm], port=0), JModelServer([jm], port=0)
    srv.start()
    jsrv.start()
    try:
        for bad in ("1,2", [-1], [1.5], [True, "x"], {"a": 1}):
            body = _body("hello", 4, resume_token_ids=bad)
            got, ref = _post(srv.port, body), _post(jsrv.port, body)
            assert got[0] == ref[0] == 400
            assert got[1] == ref[1]
        # null counts as absent
        code, out = _post(srv.port, _body("hello", 4, resume_token_ids=None))
        assert code == 200 and out["tokens"] == 4
    finally:
        srv.stop()
        jsrv.stop()
