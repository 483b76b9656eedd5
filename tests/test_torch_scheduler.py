"""Port parity: QoS scheduling and preemption in kubeflow_tpu_torch's engine.

The port's ``QosScheduler`` must make the JAX package's decisions on the
same seeded script (class order, EDF within a class, stride fair share with
its newcomer floor, the ``fifo`` policy).  The engine admits per tick in
policy order, sheds expired queued requests eagerly, preempts a lower-class
decode slot by swap or by recompute, and resumes it: a swapped victim
byte-identical to its uncontended run (the same KV bytes come back), a
recomputed one too on the CPU at this size and preemption point.  Each scenario runs at both
pipeline depths; its tokens are held against the JAX engine's on the same
script (tie-aware against ``forward_full``, and identical up to the JAX
run's first near tie).  Zero leaked pages throughout."""

import json
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kubeflow_tpu.serving.engine import Engine as JEngine
from kubeflow_tpu.serving.engine import EngineConfig as JEngineConfig
from kubeflow_tpu.serving.engine import model as JM
from kubeflow_tpu.serving.engine import scheduler as JS
from kubeflow_tpu.serving.errors import RequestError as JRequestError
from kubeflow_tpu_torch.serving.engine import engine as E
from kubeflow_tpu_torch.serving.engine import model as TM
from kubeflow_tpu_torch.serving.engine import scheduler as TS
from kubeflow_tpu_torch.serving.errors import (DeadlineExceeded, EngineOverloaded,
                                               RequestError)

CFG_J = JM.DecoderConfig(vocab_size=101, d_model=64, n_layers=2, n_heads=4,
                         n_kv_heads=2, d_ff=128)
CFG_T = TM.DecoderConfig(**{f: getattr(CFG_J, f) for f in TM.DecoderConfig.__dataclass_fields__})
GEO = dict(num_pages=128, page_size=8, max_pages_per_slot=32)
ORACLE_LEN = 128
TIE_EPS = 5e-2
STABLE_GAP = 0.07
PROMPTS = [[(i * 13 + j * 7) % (CFG_J.vocab_size - 1) + 1 for j in range(5 + i % 3)]
           for i in range(8)]
HOG_TOKENS = 60


@pytest.fixture(scope="module")
def params():
    jp = JM.init(jax.random.PRNGKey(0), CFG_J)
    return jp, TM.params_from_jax({k: np.asarray(v) for k, v in jp.items()}, "cpu")


def _engine(which, params, depth=1, max_slots=1, quant=None, **sched):
    """The same engine config in either package ('jax' or 'port')."""
    jp, tp = params
    if which == "jax":
        return JEngine(jp, CFG_J, JEngineConfig(
            max_slots=max_slots, pipeline_depth=depth, kv_quant=quant,
            scheduler=JS.SchedulerConfig(**sched), **GEO))
    return E.Engine(tp, CFG_T, E.EngineConfig(
        max_slots=max_slots, pipeline_depth=depth, kv_quant=quant,
        scheduler=TS.SchedulerConfig(**sched), **GEO), device="cpu")


def _wait(pred, timeout=60.0, msg="condition"):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if pred():
            return
        time.sleep(0.002)
    raise TimeoutError(f"timed out waiting for {msg}")


def _leaked(eng) -> int:
    s = eng.stats
    return (eng.ec.num_pages - 1) - s["free_pages"] - s["cached_pages"]


def _oracle_rows(jp, prompt, got):
    toks = list(prompt) + list(got)
    padded = np.zeros((1, ORACLE_LEN), np.int32)
    padded[0, :len(toks)] = toks
    logits = np.asarray(JM.forward_full(jp, CFG_J, jnp.asarray(padded)))[0]
    return logits[len(prompt) - 1:len(prompt) - 1 + len(got)]


def assert_jax_parity(jp, prompt, got, ref):
    """Tie-aware against forward_full along the port's own trajectory, and
    byte-identical to the JAX engine's tokens ``ref`` up to ref's first near
    tie."""
    rows = _oracle_rows(jp, prompt, got)
    for i, g in enumerate(got):
        assert rows[i, g] >= rows[i].max() - TIE_EPS, (i, g, int(rows[i].argmax()))
    top2 = np.sort(_oracle_rows(jp, prompt, ref), axis=-1)[:, -2:]
    near = np.flatnonzero(top2[:, 1] - top2[:, 0] <= STABLE_GAP)
    n = int(near[0]) if near.size else len(ref)
    assert list(got[:n]) == list(ref[:n])


# --------------------------------------------------- scheduler decisions


def _decision_script(seed, n=300):
    rng = np.random.default_rng(seed)
    ops, rid = [], 0
    for _ in range(n):
        r = rng.random()
        if r < 0.45:
            deadline = None if rng.random() < 0.3 else float(rng.random() * 10)
            ops.append(("push", rid, int(rng.integers(0, 3)), deadline,
                        int(rng.integers(0, 3)), int(rng.integers(1, 9))))
            rid += 1
        elif r < 0.75:
            ops.append(("pop",))
        elif r < 0.83:
            ops.append(("peek",))
        elif r < 0.93:
            ops.append(("remove", int(rng.integers(0, rid + 1))))
        else:
            ops.append(("expired", float(rng.random() * 10)))
    return ops


def _run_decisions(mod, config, weights, ops):
    s = mod.QosScheduler(config, weights)
    out = []
    for op in ops:
        if op[0] == "push":
            _, rid, rank, deadline, aid, pages = op
            s.push(mod.QueueEntry(rid=rid, rank=rank, deadline=deadline,
                                  submitted_at=float(rid), adapter_id=aid, pages=pages))
        elif op[0] in ("peek", "pop"):
            e = s.peek()
            out.append(None if e is None else e.rid)
            if e is not None and op[0] == "pop":
                s.pop(e)
        elif op[0] == "remove":
            out.append(s.remove(op[1]))
        else:
            out.append(sorted(e.rid for e in s.expired(op[1])))
    out.append((len(s), s.snapshot()))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("policy,weights", [("priority", None), ("priority", {1: 2.0, 2: 0.5}),
                                            ("fifo", None)], ids=["priority", "weighted", "fifo"])
def test_scheduler_decisions_match_jax(policy, weights, seed):
    """A seeded script of push/peek/pop/remove/expired over three classes,
    deadlines and three adapters (the newcomer floor included: adapters
    join while others have work queued, and after queues drain) gives the
    same decision sequence from both QosSchedulers."""
    ops = _decision_script(seed)
    want = _run_decisions(JS, JS.SchedulerConfig(policy=policy), weights, ops)
    got = _run_decisions(TS, TS.SchedulerConfig(policy=policy), weights, ops)
    assert got == want
    assert sum(isinstance(x, int) for x in got[:-1]) > 50  # the script decided things


def test_normalize_priority_and_config_validation_match_jax():
    assert TS.PRIORITY_CLASSES == JS.PRIORITY_CLASSES
    for p in (None,) + TS.PRIORITY_CLASSES:
        assert TS.normalize_priority(p) == JS.normalize_priority(p)
    for bad in ("urgent", 3, "", "INTERACTIVE"):
        with pytest.raises(RequestError):
            TS.normalize_priority(bad)
        with pytest.raises(JRequestError):
            JS.normalize_priority(bad)
    for kw in ({"policy": "lottery"}, {"swap_policy": "teleport"}):
        with pytest.raises(ValueError):
            TS.QosScheduler(TS.SchedulerConfig(**kw))
        with pytest.raises(ValueError):
            JS.QosScheduler(JS.SchedulerConfig(**kw))


def test_engine_refuses_adapter_weights_and_bad_requests(params):
    """An engine without adapters: a non-empty adapter_weights names an
    adapter it has not loaded and raises, as the JAX engine does.  A bad
    priority is refused before
    anything is queued; a full queue raises EngineOverloaded."""
    with pytest.raises(ValueError, match="unknown adapter"):
        _engine("port", params, adapter_weights=(("tenant-a", 2.0),))
    eng = E.Engine(params[1], CFG_T, E.EngineConfig(max_slots=1, max_queue_depth=1, **GEO),
                   device="cpu")
    with pytest.raises(RequestError):
        eng.generate_async(PROMPTS[0], 4, priority="urgent")
    assert eng.stats["queue_depth"] == 0
    eng.generate_async(PROMPTS[0], 4)  # not started: stays queued
    with pytest.raises(EngineOverloaded) as exc:
        eng.generate_async(PROMPTS[1], 4)
    assert exc.value.retry_after_s > 0 and eng.stats["requests_rejected"] == 1
    eng.stop()


# ------------------------------------------------------ engine scenarios


def _overtake(eng):
    """One slot held by a batch blocker; two batch requests and one
    interactive (submitted LAST) queue behind it."""
    blocker = eng.generate_async(PROMPTS[0], 30, priority="batch")
    _wait(lambda: eng.stats["active_slots"] == 1, msg="blocker admitted")
    done, futs = [], {}
    for name, prompt, prio in (("b1", PROMPTS[1], "batch"), ("b2", PROMPTS[2], "batch"),
                               ("i1", PROMPTS[3], "interactive")):
        f = eng.generate_async(prompt, 4, priority=prio)
        f.add_done_callback(lambda _, n=name: done.append(n))
        futs[name] = f
    out = {n: f.result(timeout=120)["tokens"] for n, f in futs.items()}
    out["blocker"] = blocker.result(timeout=120)["tokens"]
    return done, out


def _edf(eng):
    blocker = eng.generate_async(PROMPTS[0], 25, priority="batch")
    _wait(lambda: eng.stats["active_slots"] == 1, msg="blocker admitted")
    done = []
    late = eng.generate_async(PROMPTS[1], 4, priority="batch", deadline=300.0)
    soon = eng.generate_async(PROMPTS[2], 4, priority="batch", deadline=120.0)
    late.add_done_callback(lambda _: done.append("late"))
    soon.add_done_callback(lambda _: done.append("soon"))
    out = {"soon": soon.result(timeout=120)["tokens"], "late": late.result(timeout=120)["tokens"],
           "blocker": blocker.result(timeout=120)["tokens"]}
    return done, out


PREEMPT_AT_STEP = 22


def _hog_and_interactive(eng, inter_tokens=4):
    """A batch hog holding the only slot, then an interactive request: the
    hog is preempted, the interactive request served, the hog resumed.

    The interactive request is submitted from the loop thread, before the
    first tick after the hog's ``PREEMPT_AT_STEP``-th decode step, so the
    preemption lands at the same position in every run.  (A recompute
    re-prefills the hog's last partial page; prefill-written KV differs
    from decode-written KV in its last bits, which flips a near tie of this
    model at some positions, 21 among them, and not at this one.)"""
    inter = []
    tick = eng._tick

    def tick_then_submit():
        if not inter and eng._decode_steps >= PREEMPT_AT_STEP:
            inter.append(eng.generate_async(PROMPTS[1], inter_tokens,
                                            priority="interactive"))
        return tick()

    eng._tick = tick_then_submit
    hog = eng.generate_async(PROMPTS[0], HOG_TOKENS, priority="batch")
    rh = hog.result(timeout=120)
    return inter[0].result(timeout=120), rh


SCENARIOS = {"overtake": (dict(preemption=False), _overtake),
             "edf": (dict(preemption=False), _edf)}


@pytest.fixture(scope="module")
def jax_runs(params):
    """The JAX engine through every scenario of this file, once: the
    ordering scripts, the uncontended hog (bf16 and int8 pools) and the
    preempted hog."""
    out = {}
    for name, (sched, fn) in SCENARIOS.items():
        eng = _engine("jax", params, **sched)
        eng.start()
        try:
            out[name] = fn(eng)
        finally:
            eng.stop()
    for quant in (None, "int8"):
        eng = _engine("jax", params, quant=quant)
        eng.start()
        try:
            out[("hog", quant)] = eng.generate(PROMPTS[0], HOG_TOKENS)["tokens"]
            out[("inter", quant)] = eng.generate(PROMPTS[1], 4)["tokens"]
        finally:
            eng.stop()
    return out


@pytest.mark.parametrize("depth", [0, 1])
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_admission_order_matches_jax(params, jax_runs, name, depth):
    """Interactive overtakes queued batch work (class outranks submission
    order); within a class the earlier deadline admits first (EDF).  Same
    completion order as the JAX engine, and the same tokens."""
    sched, fn = SCENARIOS[name]
    eng = _engine("port", params, depth=depth, **sched)
    eng.start()
    try:
        done, out = fn(eng)
        leaked = _leaked(eng)
        preempted = eng.stats["preemptions"]
    finally:
        eng.stop()
    jdone, jout = jax_runs[name]
    assert done[0] == jdone[0] == ("i1" if name == "overtake" else "soon")
    assert done == jdone
    prompts = {"blocker": PROMPTS[0], "b1": PROMPTS[1], "b2": PROMPTS[2], "i1": PROMPTS[3],
               "late": PROMPTS[1], "soon": PROMPTS[2]}
    for key, toks in out.items():
        assert_jax_parity(params[0], prompts[key], toks, jout[key])
    assert leaked == 0 and preempted == 0


@pytest.mark.parametrize("depth", [0, 1])
def test_eager_queue_reaping(params, depth):
    """A deadline-expired queued request sheds within ticks of expiry —
    while the blocker still runs — and stops holding queue budget."""
    eng = _engine("port", params, depth=depth, preemption=False)
    eng.start()
    try:
        blocker = eng.generate_async(PROMPTS[0], 200, priority="batch")
        _wait(lambda: eng.stats["active_slots"] == 1, msg="blocker admitted")
        doomed = eng.generate_async(PROMPTS[1], 4, deadline=0.05)
        t0 = time.perf_counter()
        with pytest.raises(DeadlineExceeded, match="reaped"):
            doomed.result(timeout=60)
        assert time.perf_counter() - t0 < 5.0
        assert not blocker.done()
        s = eng.stats
        assert s["queue_depth"] == 0 and s["requests_shed"] == 1
        assert s["scheduler"]["reaped"] == 1
        follow = eng.generate_async(PROMPTS[2], 4)
        assert eng.cancel(blocker)
        assert blocker.result(timeout=60)["cancelled"]
        assert follow.result(timeout=60)["num_tokens"] == 4
        _wait(lambda: _leaked(eng) == 0, msg="pages released")
    finally:
        eng.stop()


@pytest.mark.parametrize("depth", [0, 1])
@pytest.mark.parametrize("quant,mode", [(None, "swap"), (None, "recompute"), (None, "auto"),
                                        ("int8", "swap")],
                         ids=["swap", "recompute", "auto", "int8-swap"])
def test_preempt_resume_byte_identical(params, jax_runs, quant, mode, depth):
    """The batch hog is preempted for the interactive request and resumes to
    the same bytes as its uncontended run on the same engine config (swap
    restores the exact KV; recompute re-prefills the committed context from
    its cached pages), and within the JAX engine's tokens."""
    eng = _engine("port", params, depth=depth, quant=quant)
    eng.start()
    try:
        base = eng.generate(PROMPTS[0], HOG_TOKENS)["tokens"]
    finally:
        eng.stop()
    eng = _engine("port", params, depth=depth, quant=quant, swap_policy=mode,
                  swap_min_tokens=8)
    eng.start()
    try:
        ri, rh = _hog_and_interactive(eng)
        s = eng.stats
        leaked = _leaked(eng)
    finally:
        eng.stop()
    assert rh["tokens"] == base and rh["num_tokens"] == HOG_TOKENS
    assert rh["preemptions"] == s["preemptions"] >= 1 and ri["preemptions"] == 0
    want = "recompute" if mode == "recompute" else "swap"
    assert s["preemption_modes"][want] == s["preemptions"]
    assert s["preemption_reasons"] == {"priority": s["preemptions"]}
    if want == "swap":
        assert s["swapped_out"] == s["swapped_in"] >= 1 and s["swap_bytes_out"] > 0
    else:
        assert s["swapped_out"] == 0 and s["page_hits"] > 0  # re-adopted its pages
    assert s["swap_used_bytes"] == 0 and leaked == 0
    assert_jax_parity(params[0], PROMPTS[0], rh["tokens"], jax_runs[("hog", quant)])
    assert_jax_parity(params[0], PROMPTS[1], ri["tokens"], jax_runs[("inter", quant)])


@pytest.mark.parametrize("depth", [0, 1])
def test_pool_pressure_watermark_evicts_without_thrash(params, depth):
    """min_free_pages: with the pool below the watermark and a batch slot
    decoding next to an interactive one, the batch slot is evicted for pool
    pressure, and the admission reserve keeps it queued until the pressure
    clears instead of swap-thrashing every tick."""
    jp, tp = params
    eng = E.Engine(tp, CFG_T, E.EngineConfig(
        max_slots=2, num_pages=32, page_size=8, max_pages_per_slot=16, pipeline_depth=depth,
        scheduler=TS.SchedulerConfig(min_free_pages=8, swap_policy="swap",
                                     swap_min_tokens=0)), device="cpu")
    eng.start()
    try:
        inter = eng.generate_async(PROMPTS[0], 90, priority="interactive")
        batch = eng.generate_async(PROMPTS[1], 90, priority="batch")
        ri, rb = inter.result(timeout=300), batch.result(timeout=300)
        s = eng.stats
        leaked = (eng.ec.num_pages - 1) - s["free_pages"] - s["cached_pages"]
    finally:
        eng.stop()
    assert ri["num_tokens"] == rb["num_tokens"] == 90
    assert 1 <= s["preemptions"] <= 10, s["preemptions"]
    assert s["preemption_reasons"].get("pool", 0) >= 1
    assert rb["preemptions"] >= 1 and ri["preemptions"] == 0
    assert leaked == 0


@pytest.mark.parametrize("depth", [0, 1])
def test_preemption_disabled_keeps_slots(params, depth):
    eng = _engine("port", params, depth=depth, preemption=False)
    eng.start()
    try:
        hog = eng.generate_async(PROMPTS[0], 40, priority="best_effort")
        _wait(lambda: eng.stats["active_slots"] == 1, msg="hog admitted")
        inter = eng.generate_async(PROMPTS[1], 4, priority="interactive")
        assert inter.result(timeout=120)["num_tokens"] == 4
        assert hog.done()  # it waited behind the hog
        assert hog.result()["num_tokens"] == 40 and eng.stats["preemptions"] == 0
    finally:
        eng.stop()


@pytest.mark.parametrize("depth", [0, 1])
def test_cancel_of_preempted_request(params, depth):
    """A request cancelled WHILE preempted (queued, its KV swapped out)
    resolves at once with its pre-preemption tokens and releases its
    swap-store bytes and pages."""
    eng = _engine("port", params, depth=depth, swap_policy="swap")
    eng.start()
    try:
        hog = eng.generate_async(PROMPTS[0], 150, priority="batch")
        _wait(lambda: eng.stats["active_slots"] == 1 and not eng._prefilling,
              msg="hog decoding")
        inter = eng.generate_async(PROMPTS[1], 100, priority="interactive")
        _wait(lambda: eng.stats["preemptions"] >= 1, msg="hog preempted")
        assert eng.stats["swap_used_bytes"] > 0
        assert eng.cancel(hog)
        r = hog.result(timeout=5)
        assert r["cancelled"] and r["preemptions"] == 1 and 0 < r["num_tokens"] < 150
        assert eng.stats["swap_used_bytes"] == 0
        assert not eng.cancel(hog)  # already resolved
        assert inter.result(timeout=120)["num_tokens"] == 100
        _wait(lambda: _leaked(eng) == 0, msg="pages released")
    finally:
        eng.stop()


def test_http_priority_and_deadline(params):
    """priority as a parameter and as an X-Priority header; 400 on a bad
    class (parameter, header, predict instance) or deadline before anything
    is submitted; 504 when a queued request's deadline sheds it."""
    from kubeflow_tpu_torch.serving.engine.serve import JetStreamModel
    from kubeflow_tpu_torch.serving.server import ModelServer

    eng = _engine("port", params, max_slots=1, preemption=False)
    model = JetStreamModel("llm", engine=eng)
    srv = ModelServer([model], port=0)
    srv.start()

    def post(path, body, headers=None):
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}{path}", data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json", **(headers or {})})
        try:
            with urllib.request.urlopen(req, timeout=120) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    gen = "/v2/models/llm/generate"
    try:
        code, out = post(gen, {"text_input": "ab", "parameters": {"max_tokens": 4,
                                                                   "priority": "batch"}})
        assert code == 200 and out["tokens"] == 4
        code, out = post(gen, {"text_input": "ab", "parameters": {"max_tokens": 4}},
                         {"X-Priority": "best_effort"})
        assert code == 200 and out["tokens"] == 4
        for body, hdrs in (({"priority": "urgent"}, None), ({}, {"X-Priority": "urgent"}),
                           ({"deadline_s": "soon"}, None)):
            code, out = post(gen, {"text_input": "ab",
                                   "parameters": {"max_tokens": 4, **body}}, hdrs)
            assert code == 400, out
        code, out = post("/v1/models/llm:predict", {"instances": [
            {"prompt": "a", "max_tokens": 2, "priority": "nope"}]})
        assert code == 400
        code, out = post("/v1/models/llm:predict", {"instances": [
            {"prompt": "a", "max_tokens": 2, "priority": "batch"},
            {"prompt": "b", "max_tokens": 2}]}, {"X-Priority": "best_effort"})
        assert code == 200 and [o["tokens"] for o in out["predictions"]] == [2, 2]
        assert eng.stats["ticks"] > 0 and _leaked(eng) == 0
        # a doomed request queued behind a long blocker is shed with 504
        hold = threading.Thread(target=post, args=(gen, {
            "text_input": "HOLD", "parameters": {"max_tokens": 150, "priority": "batch"}}))
        hold.start()
        _wait(lambda: eng.stats["active_slots"] == 1, msg="blocker admitted")
        code, out = post(gen, {"text_input": "LATE", "parameters": {
            "max_tokens": 4, "deadline_s": 0.05}})
        assert code == 504 and out["reason"] == "deadline"
        hold.join(timeout=120)
        assert not hold.is_alive()
    finally:
        srv.stop()
        eng.stop()
