"""Port parity: sessions on the tiered KV store in kubeflow_tpu_torch's engine.

A session turn pins its finished KV pages in the tiered store (host RAM,
written through to checksummed page files); the next turn restores them
from the host tier, from the disk tier, or from a fresh engine's manifest
replay, and re-prefills only the tail.  Every storage fault class (torn
write, bit flip, ENOSPC, slow disk, a page file deleted behind the store's
back) degrades to a re-prefill and never fails the turn; a diverged prompt
falls back cold; a concurrent turn of the same session raises SessionBusy
(HTTP 409).  Pages pinned by one package's engine restore in the other's.

A warm turn's KV for the previous turn's generated tokens was written by
decode steps, a cold turn's by prefill, so their low bits differ: every
turn is held to the tie-aware oracle and, up to the first near tie, to the
port's and the JAX engine's cold runs of the same context.  Zero leaked
pages and zero store bytes at drain throughout."""

import concurrent.futures
import json
import os
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kubeflow_tpu.serving.engine import Engine as JEngine
from kubeflow_tpu.serving.engine import EngineConfig as JEngineConfig
from kubeflow_tpu.serving.engine import KVStoreConfig as JKVStoreConfig
from kubeflow_tpu.serving.engine import model as JM
from kubeflow_tpu_torch.serving.engine import engine as E
from kubeflow_tpu_torch.serving.engine import model as TM
from kubeflow_tpu_torch.serving.engine.faults import StorageFaultConfig
from kubeflow_tpu_torch.serving.engine.kvstore import KVStoreConfig
from kubeflow_tpu_torch.serving.engine.scheduler import SchedulerConfig
from kubeflow_tpu_torch.serving.errors import RequestError, SessionBusy

CFG_J = JM.DecoderConfig(vocab_size=101, d_model=64, n_layers=2, n_heads=4,
                         n_kv_heads=2, d_ff=128)
CFG_T = TM.DecoderConfig(**{f: getattr(CFG_J, f) for f in TM.DecoderConfig.__dataclass_fields__})
PAGE = 8
GEO = dict(max_slots=2, num_pages=128, page_size=PAGE, max_pages_per_slot=32)
PROMPT = [(i * 13) % (CFG_J.vocab_size - 1) + 1 for i in range(20)]
TURN2_EXTRA = [5, 6, 7, 8, 9]
TURN3_EXTRA = [11, 12, 13]
N = 12
ORACLE_LEN = 96
TIE_EPS = 5e-2
STABLE_GAP = 0.07


@pytest.fixture(scope="module")
def params():
    jp = JM.init(jax.random.PRNGKey(0), CFG_J)
    return jp, TM.params_from_jax({k: np.asarray(v) for k, v in jp.items()}, "cpu")


def _port(params, depth=1, **kw):
    return E.Engine(params[1], CFG_T, E.EngineConfig(pipeline_depth=depth, **GEO, **kw),
                    device="cpu")


def _leaked(eng) -> int:
    s = eng.stats
    return (eng.ec.num_pages - 1) - s["free_pages"] - s["cached_pages"]


def _oracle_rows(jp, prompt, got):
    toks = list(prompt) + list(got)
    padded = np.zeros((1, ORACLE_LEN), np.int32)
    padded[0, :len(toks)] = toks
    logits = np.asarray(JM.forward_full(jp, CFG_J, jnp.asarray(padded)))[0]
    return logits[len(prompt) - 1:len(prompt) - 1 + len(got)]


def assert_parity(jp, prompt, got, *refs):
    """Tie-aware against forward_full along the port's own trajectory, and
    identical to each reference run up to that run's first near tie."""
    rows = _oracle_rows(jp, prompt, got)
    for i, g in enumerate(got):
        assert rows[i, g] >= rows[i].max() - TIE_EPS, (i, g, int(rows[i].argmax()))
    for ref in refs:
        top2 = np.sort(_oracle_rows(jp, prompt, ref), axis=-1)[:, -2:]
        near = np.flatnonzero(top2[:, 1] - top2[:, 0] <= STABLE_GAP)
        n = int(near[0]) if near.size else len(ref)
        assert list(got[:n]) == list(ref[:n])


def _cold_turns(eng):
    r1 = eng.generate(PROMPT, N)
    ctx2 = PROMPT + r1["tokens"] + TURN2_EXTRA
    r2 = eng.generate(ctx2, N)
    ctx3 = ctx2 + r2["tokens"] + TURN3_EXTRA
    r3 = eng.generate(ctx3, N)
    return {"t1": r1["tokens"], "ctx2": ctx2, "t2": r2["tokens"], "ctx3": ctx3,
            "t3": r3["tokens"]}


@pytest.fixture(scope="module")
def cold(params):
    """Each turn's context run cold, without a session: once on the JAX
    engine (its contexts are the conversation every test replays) and once
    on the port's engine over the JAX contexts."""
    jeng = JEngine(params[0], CFG_J, JEngineConfig(**GEO))
    jeng.start()
    try:
        jax_cold = _cold_turns(jeng)
    finally:
        jeng.stop()
    eng = _port(params)
    eng.start()
    try:
        port = {t: eng.generate(p, N)["tokens"] for t, p in
                (("t1", PROMPT), ("t2", jax_cold["ctx2"]), ("t3", jax_cold["ctx3"]))}
    finally:
        eng.stop()
    return {"jax": jax_cold, "port": port}


def _check_turn(params, cold, turn, got):
    prompt = {"t1": PROMPT, "t2": cold["jax"]["ctx2"], "t3": cold["jax"]["ctx3"]}[turn]
    assert_parity(params[0], prompt, got, cold["port"][turn], cold["jax"][turn])


def _turns(eng, cold, n=3, sid="s"):
    out = [eng.generate(PROMPT, N, session_id=sid)]
    for ctx in ("ctx2", "ctx3")[:n - 1]:
        out.append(eng.generate(cold["jax"][ctx], N, session_id=sid))
    return out


def _drained(eng, sid="s"):
    """Drop the session; every tier and the page pool must read zero."""
    assert eng.drop_session(sid)
    s = eng.stats
    return (s["kv_host_used_bytes"], s["kv_disk_used_bytes"], s["swap_used_bytes"],
            _leaked(eng)) == (0, 0, 0, 0)


# ---------------------------------------------------------- tier restores


@pytest.mark.parametrize("depth", [0, 1])
@pytest.mark.parametrize("tier", ["host", "disk", "manifest", "int8-host"])
def test_session_turns_restore(params, cold, tmp_path, tier, depth):
    """Turns 2-3 restore the pinned pages from the host tier, from the disk
    tier (host budget 0), or from a fresh engine's manifest replay, and
    decode within the cold runs; the int8 pool pins and restores its
    {"q", "s"} blobs."""
    kv = KVStoreConfig(host_max_bytes=0 if tier == "disk" else 1 << 30,
                       disk_dir=str(tmp_path / "kv"))
    kw = {"kv_quant": "int8"} if tier == "int8-host" else {}
    eng = _port(params, depth, kv_store=kv, **kw)
    eng.start()
    try:
        if tier == "manifest":
            r1 = eng.generate(PROMPT, N, session_id="s")
            eng.stop()
            eng = _port(params, depth, kv_store=kv)
            assert eng.sessions()["s"]["tiers"] == ["disk"]  # replayed before any touch
            eng.start()
            rest = [eng.generate(cold["jax"][c], N, session_id="s") for c in ("ctx2", "ctx3")]
            results = [r1] + rest
        else:
            results = _turns(eng, cold)
        restores = [r["session"]["restore"] for r in results]
        s = eng.stats
        drained = _drained(eng)
    finally:
        eng.stop()
    want = {"host": "host", "int8-host": "host", "disk": "disk", "manifest": "disk"}[tier]
    # the manifest engine's third turn finds turn 2's pin on its host tier
    assert restores == ["cold", want, "host" if tier == "manifest" else want]
    assert all(r["session"]["pinned"] and r["session"]["durable"] for r in results)
    if tier != "int8-host":
        for turn, r in zip(("t1", "t2", "t3"), results):
            _check_turn(params, cold, turn, r["tokens"])
    assert s["session_restores"][want] >= 1 and s["sessions_pinned"] == 1
    assert drained


@pytest.mark.parametrize("depth", [0, 1])
@pytest.mark.parametrize("fault,expect", [
    (StorageFaultConfig(torn_write_every=1), "degraded"),
    (StorageFaultConfig(bit_flip_every=1), "degraded"),
    (StorageFaultConfig(enospc_every=1), "cold"),
    (StorageFaultConfig(slow_read_s=0.02, slow_write_s=0.02), "disk"),
    ("missing_file", "degraded")],
    ids=["torn", "bit_flip", "enospc", "slow", "missing_file"])
def test_storage_faults_degrade_not_fail(params, cold, tmp_path, fault, expect, depth):
    """Every fault class: the second turn COMPLETES within the cold runs.
    Torn writes, bit flips and a deleted page file fail verification
    (degraded -> re-prefill), ENOSPC means the pin never landed (cold), a
    slow disk still restores."""
    kvdir = str(tmp_path / "kv")
    chaos = fault if isinstance(fault, StorageFaultConfig) else None
    eng = _port(params, depth, kv_store=KVStoreConfig(host_max_bytes=0, disk_dir=kvdir,
                                                      chaos=chaos))
    eng.start()
    try:
        r1 = eng.generate(PROMPT, N, session_id="s")
        if fault == "missing_file":
            for name in os.listdir(kvdir):
                if name.endswith(".kvpg"):
                    os.unlink(os.path.join(kvdir, name))
        r2 = eng.generate(cold["jax"]["ctx2"], N, session_id="s")
        s = eng.stats
        leaked = _leaked(eng)
    finally:
        eng.stop()
    assert r2["session"]["restore"] == expect and r2["num_tokens"] == N
    _check_turn(params, cold, "t1", r1["tokens"])
    _check_turn(params, cold, "t2", r2["tokens"])
    if expect == "degraded":
        assert s["kv_verify_failures"] >= 1
    if expect == "cold":
        assert s["storage_chaos"]["injected_enospc"] >= 1 and not r1["session"]["durable"]
    assert leaked == 0


@pytest.mark.parametrize("depth", [0, 1])
def test_diverged_prompt_falls_back_cold(params, tmp_path, depth):
    """A turn whose prompt does NOT extend the pinned context adopts no
    mismatched KV: it runs cold, with the tokens of a session-less run."""
    eng = _port(params, depth, kv_store=KVStoreConfig(disk_dir=str(tmp_path / "kv")))
    eng.start()
    try:
        eng.generate(PROMPT, N, session_id="s")
        other = [(i * 7) % (CFG_J.vocab_size - 1) + 1 for i in range(40)]
        plain = eng.generate(other, N)
        diverged = eng.generate(other, N, session_id="s")
        assert diverged["tokens"] == plain["tokens"]
        assert diverged["session"]["restore"] in ("cold", "cache")
        assert _leaked(eng) == 0
    finally:
        eng.stop()


@pytest.mark.parametrize("depth", [0, 1])
def test_concurrent_turn_raises_session_busy(params, tmp_path, depth):
    eng = _port(params, depth, kv_store=KVStoreConfig(disk_dir=str(tmp_path / "kv")))
    eng.start()
    try:
        fut = eng.generate_async(PROMPT, 30, session_id="s")
        with pytest.raises(SessionBusy):
            eng.generate_async(PROMPT + [1], 4, session_id="s")
        fut.result(timeout=120)
        r = eng.generate(PROMPT + [1, 2], 4, session_id="s")  # resolved: accepted again
        assert r["session"]["id"] == "s"
        for bad in ("", 7, "x" * 300, "evil\r\nSet-Cookie: a=b", "sp ace"):
            with pytest.raises(RequestError):
                eng.generate_async(PROMPT, 2, session_id=bad)
        assert eng.stats["queue_depth"] == 0
    finally:
        eng.stop()


def test_short_context_and_ephemeral_store(params):
    """A turn shorter than one full page has nothing to pin: reported, not
    failed.  The default store's private directory goes at stop()."""
    eng = _port(params)
    eng.start()
    try:
        r = eng.generate(PROMPT[:3], 2, session_id="tiny")
        assert not r["session"]["pinned"] and "page" in r["session"]["error"]
        eng.generate(PROMPT, N, session_id="s")
        d = eng._kv.disk_dir
        assert d and os.path.isdir(d) and _leaked(eng) == 0
    finally:
        eng.stop()
    assert not os.path.exists(d)


def test_session_turn_survives_preemption(params, cold, tmp_path):
    """Sessions and preemption share the tiered store: a batch-class session
    turn swapped out for an interactive request resumes, pins, and the next
    turn restores from the host tier; the swap bytes drain to zero."""
    eng = E.Engine(params[1], CFG_T, E.EngineConfig(
        **{**GEO, "max_slots": 1}, kv_store=KVStoreConfig(disk_dir=str(tmp_path / "kv")),
        scheduler=SchedulerConfig(swap_policy="swap")), device="cpu")
    eng.start()
    try:
        t1 = eng.generate_async(PROMPT, N, session_id="s", priority="batch")
        deadline = time.monotonic() + 60
        while eng.stats["decode_steps"] < 4 and time.monotonic() < deadline:
            time.sleep(0.001)
        inter = eng.generate(PROMPT[:9], 20, priority="interactive")
        r1 = t1.result(timeout=120)
        r2 = eng.generate(cold["jax"]["ctx2"], N, session_id="s")
        s = eng.stats
        assert inter["num_tokens"] == 20
        assert r1["preemptions"] == 1 and s["swapped_in"] == 1
        assert r1["session"]["pinned"] and r2["session"]["restore"] == "host"
        _check_turn(params, cold, "t1", r1["tokens"])
        _check_turn(params, cold, "t2", r2["tokens"])
        assert _drained(eng)
    finally:
        eng.stop()


# ------------------------------------------------- across the two packages


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_session_pinned_by_one_package_restores_in_the_other(params, cold, tmp_path, writer):
    """Turn 1 on one package's engine pins to a disk_dir; a fresh engine of
    the other package replays the manifest and restores turn 2 from disk."""
    kvdir = str(tmp_path / "kv")

    def make(which):
        if which == "jax":
            return JEngine(params[0], CFG_J, JEngineConfig(
                **GEO, kv_store=JKVStoreConfig(disk_dir=kvdir)))
        return _port(params, kv_store=KVStoreConfig(disk_dir=kvdir))

    first = make(writer)
    first.start()
    try:
        r1 = first.generate(PROMPT, N, session_id="s")
    finally:
        first.stop()
    assert r1["session"]["durable"]
    second = make("port" if writer == "jax" else "jax")
    assert second.sessions()["s"]["pages"] == (len(PROMPT) + N - 1) // PAGE
    second.start()
    try:
        r2 = second.generate(cold["jax"]["ctx2"], N, session_id="s")
    finally:
        second.stop()
    assert r2["session"]["restore"] == "disk"
    _check_turn(params, cold, "t1", r1["tokens"])
    _check_turn(params, cold, "t2", r2["tokens"])


# ----------------------------------------------------------------- HTTP


def test_http_session_api(params, cold, tmp_path):
    """session_id as a parameter and as an X-Session-Id header, the response
    session block and X-Session-* headers, 409 on a concurrent turn, 400 on
    a bad id."""
    from kubeflow_tpu_torch.serving.engine.serve import JetStreamModel
    from kubeflow_tpu_torch.serving.server import ModelServer

    eng = _port(params, kv_store=KVStoreConfig(disk_dir=str(tmp_path / "kv")))
    model = JetStreamModel("llm", engine=eng)
    srv = ModelServer([model], port=0)
    srv.start()
    tok = model.tokenizer

    def gen(ids, extra=None, headers=None):
        body = {"text_input": tok.decode(ids), "parameters": {"max_tokens": N, **(extra or {})}}
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/v2/models/llm/generate",
            data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json", **(headers or {})})
        with urllib.request.urlopen(req, timeout=120) as r:
            return json.loads(r.read()), dict(r.headers)

    try:
        out, hdrs = gen(PROMPT, {"session_id": "web"})
        assert out["session"]["id"] == "web" and out["session"]["pinned"]
        assert (hdrs["X-Session-Id"], hdrs["X-Session-Restore"],
                hdrs["X-Session-Pinned"]) == ("web", "cold", "true")
        assert "X-Session-Evicted" not in hdrs
        ctx2 = PROMPT + out["token_ids"] + TURN2_EXTRA
        out2, hdrs2 = gen(ctx2, headers={"X-Session-Id": "web"})
        assert hdrs2["X-Session-Restore"] == out2["session"]["restore"] == "host"
        _check_turn(params, cold, "t1", out["token_ids"])
        with concurrent.futures.ThreadPoolExecutor(1) as ex:
            slow = ex.submit(gen, ctx2 + out2["token_ids"] + [1],
                             {"session_id": "web", "max_tokens": 150})
            deadline = time.time() + 30
            while time.time() < deadline and "web" not in eng._session_active:
                time.sleep(0.001)
            with pytest.raises(urllib.error.HTTPError) as err:
                gen(PROMPT, {"session_id": "web"})
            assert err.value.code == 409
            assert "session" in json.loads(err.value.read())["error"].lower()
            slow.result(timeout=120)
        with pytest.raises(urllib.error.HTTPError) as err:
            gen(PROMPT, {"session_id": ""})
        assert err.value.code == 400
        assert eng.sessions()["web"]["pages"] > 0 and _leaked(eng) == 0
    finally:
        srv.stop()
        eng.stop()
