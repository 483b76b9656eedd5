"""Port parity: the watchdog, its restart and hang detection, on the CPU.

Both engines take the same chaos on the same weights:
  * ``die_on_tick`` kills the loop thread mid-decode.  The in-flight
    requests fail with TickFailure (the same message in both), ``health()``
    comes back SERVING with ``restarts`` 1, a ``watchdog_restart`` flight
    dump is written with the same header and event fields, and a request
    after the restart gives the JAX engine's tokens.  The revived loop
    runs in inference mode on its own thread, rebuilds its pipeline from
    empty committed state, and leaks no page.
  * ``slow_tick_on`` with a short ``hang_timeout_s`` reads DEGRADED while
    the tick hangs, then the watchdog fences the epoch and restarts; the
    superseded thread wakes, sees the new epoch and exits without
    committing anything.
  * ``watchdog_restart=False`` leaves the engine DEAD with a
    ``watchdog_halt`` dump; ``drain_timeout_s`` bounds ``stop()``'s drain.
Every poll has a deadline; nothing sleeps and then asserts."""

import glob
import json
import threading
import time

import jax
import numpy as np
import pytest
import torch

from kubeflow_tpu.serving.engine import Engine as JEngine
from kubeflow_tpu.serving.engine import EngineConfig as JEngineConfig
from kubeflow_tpu.serving.engine import model as JM
from kubeflow_tpu.serving.engine.faults import FaultConfig as JFaultConfig
from kubeflow_tpu_torch.serving.engine import engine as E
from kubeflow_tpu_torch.serving.engine import model as TM
from kubeflow_tpu_torch.serving.engine.engine import Engine, EngineConfig
from kubeflow_tpu_torch.serving.engine.faults import FaultConfig
from kubeflow_tpu_torch.serving.errors import EngineShutdown, TickFailure

CFG_J = JM.DecoderConfig(vocab_size=13, d_model=64, n_layers=2, n_heads=4,
                         n_kv_heads=2, d_ff=128)
CFG_T = TM.DecoderConfig(**{f: getattr(CFG_J, f) for f in TM.DecoderConfig.__dataclass_fields__})
GEO = dict(max_slots=4, num_pages=64, page_size=8, max_pages_per_slot=12,
           watchdog_interval_s=0.02)
PROMPTS = [[1, 2, 3, 4] * 3, [5, 6, 7, 8, 9, 10, 11], [3, 1, 4, 1, 5, 9, 2, 6] * 2]
AFTER = [2, 7, 1, 8, 2, 8]
MAX_NEW = 24


@pytest.fixture(scope="module")
def params():
    jp = JM.init(jax.random.PRNGKey(0), CFG_J)
    return jp, TM.params_from_jax({k: np.asarray(v) for k, v in jp.items()}, "cpu")


def _wait(pred, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.005)
    return False


def _leaked(engine, ec) -> int:
    s = engine.stats
    return ec.num_pages - 1 - s["free_pages"] - s["cached_pages"]


def _die_run(engine, ec):
    """Submit PROMPTS, start (the loop dies at its chaos tick), collect the
    failures, wait for the restart, serve AFTER; -> a record of it all."""
    futs = [engine.generate_async(list(p), MAX_NEW) for p in PROMPTS]
    engine.start()
    try:
        errs = []
        for f in futs:
            try:
                f.result(timeout=60)
                errs.append(None)
            except Exception as e:  # noqa: BLE001 — the typed failure
                errs.append(e)
        assert _wait(lambda: engine.health()["restarts"] == 1)
        assert _wait(lambda: engine.health()["state"] == "SERVING")
        after = engine.generate(list(AFTER), 12, timeout=60)
        return {"errors": errs, "health": engine.health(), "after": after["tokens"],
                "leaked": _leaked(engine, ec), "stats": engine.stats}
    finally:
        engine.stop()


@pytest.mark.parametrize("depth", [0, 1])
def test_die_on_tick_restarts_like_the_jax_engine(params, depth, tmp_path, monkeypatch):
    jp, tp = params
    kw = dict(GEO, pipeline_depth=depth)
    jec = JEngineConfig(**kw, chaos=JFaultConfig(die_on_tick=5),
                        flight_dir=str(tmp_path / "jax"))
    tec = EngineConfig(**kw, chaos=FaultConfig(die_on_tick=5), flight_dir=str(tmp_path / "port"))
    # every decode dispatch of the port records whether it ran in inference
    # mode and on which thread
    seen = []
    for name in ("decode_step", "decode_step_sample"):
        real = getattr(E, name)

        def spy(*a, _real=real, **k):
            # the Thread object itself: a dead thread's ident can be reused
            seen.append((threading.current_thread(), torch.is_inference_mode_enabled()))
            return _real(*a, **k)

        monkeypatch.setattr(E, name, spy)
    ref = _die_run(JEngine(jp, CFG_J, jec), jec)
    got = _die_run(Engine(tp, CFG_T, tec, device="cpu"), tec)
    assert all(isinstance(e, TickFailure) for e in got["errors"])
    assert [str(e) for e in got["errors"]] == [str(e) for e in ref["errors"]]
    assert got["health"]["restarts"] == ref["health"]["restarts"] == 1
    assert got["after"] == ref["after"] and len(got["after"]) == 12
    assert got["leaked"] == ref["leaked"] == 0
    assert got["stats"]["requests_failed"] == ref["stats"]["requests_failed"] == 3
    # two loop threads dispatched, both in inference mode
    assert len({id(t) for t, _ in seen}) == 2 and all(mode for _, mode in seen)
    (tpath,) = glob.glob(str(tmp_path / "port" / "*.jsonl"))
    (jpath,) = glob.glob(str(tmp_path / "jax" / "*.jsonl"))
    th, *tev = [json.loads(line) for line in open(tpath)]
    jh, *jev = [json.loads(line) for line in open(jpath)]
    assert th["reason"] == jh["reason"] == "watchdog_restart"
    assert th.keys() == jh.keys()
    assert (th["detail"], th["epoch"], th["restarts"]) == (jh["detail"], jh["epoch"],
                                                             jh["restarts"])
    assert len(th["trace_ids"]) == len(jh["trace_ids"]) == 3
    assert tev[-1]["phase"] == jev[-1]["phase"] == "watchdog"
    assert tev[-1].keys() == jev[-1].keys()
    assert [e["phase"] for e in tev] == [e["phase"] for e in jev]


def _hang_run(engine, ec):
    # health as the watchdog finds it when it steps in: the moment the hang
    # is detected, deterministically (a poller could miss the window)
    seen = []
    real = engine._supervise

    def supervise(reason):
        seen.append(engine.health()["state"])
        real(reason)

    engine._supervise = supervise
    fut = engine.generate_async(list(PROMPTS[0]), MAX_NEW)
    engine.start()
    try:
        old = engine._thread
        assert _wait(lambda: seen)
        assert seen == ["DEGRADED"]
        with pytest.raises(Exception) as err:  # each package's own TickFailure
            fut.result(timeout=60)
        assert type(err.value).__name__ == "TickFailure"
        assert _wait(lambda: engine.health()["restarts"] == 1)
        # the superseded thread wakes from its stalled tick and exits
        assert _wait(lambda: not old.is_alive())
        after = engine.generate(list(AFTER), 8, timeout=60)
        return {"error": str(err.value), "after": after["tokens"],
                "leaked": _leaked(engine, ec), "ticks_failed": engine.stats["ticks_failed"]}
    finally:
        engine.stop()


def test_hang_reads_degraded_then_restarts(params):
    jp, tp = params
    # tick 3 stalls 1.5 s (mid-decode); the watchdog's hang bound is 0.4 s
    ckw = dict(slow_tick_on=3, slow_tick_s=1.5)
    kw = dict(GEO, hang_timeout_s=0.4)
    jec = JEngineConfig(**kw, chaos=JFaultConfig(**ckw))
    tec = EngineConfig(**kw, chaos=FaultConfig(**ckw))
    ref = _hang_run(JEngine(jp, CFG_J, jec), jec)
    got = _hang_run(Engine(tp, CFG_T, tec, device="cpu"), tec)
    assert got["error"] == ref["error"]
    assert "hung > 0.4s" in got["error"]
    assert got["after"] == ref["after"]
    assert got["leaked"] == ref["leaked"] == 0
    assert got["ticks_failed"] == ref["ticks_failed"] == 0


def test_restart_disabled_leaves_the_engine_dead(params, tmp_path):
    _, tp = params
    ec = EngineConfig(**GEO, chaos=FaultConfig(die_on_tick=3), watchdog_restart=False,
                      flight_dir=str(tmp_path))
    eng = Engine(tp, CFG_T, ec, device="cpu")
    fut = eng.generate_async(list(PROMPTS[0]), MAX_NEW)
    eng.start()
    try:
        with pytest.raises(TickFailure):
            fut.result(timeout=60)
        assert _wait(lambda: eng.health()["state"] == "DEAD")
        assert eng.health()["restarts"] == 0
        (path,) = glob.glob(str(tmp_path / "*.jsonl"))
        assert json.loads(open(path).readline())["reason"] == "watchdog_halt"
    finally:
        eng.stop()


def test_drain_timeout_bounds_stop(params):
    """``drain_timeout_s`` is a config field: a long generation still in
    flight when it runs out is failed with EngineShutdown."""
    _, tp = params
    eng = Engine(tp, CFG_T, EngineConfig(**GEO, drain_timeout_s=0.05,
                                         chaos=FaultConfig(slow_tick_every=1,
                                                           slow_tick_s=0.02)),
                 device="cpu")
    eng.start()
    fut = eng.generate_async(list(PROMPTS[0]), 80)
    assert _wait(lambda: eng.stats["decode_steps"] > 0)
    t0 = time.monotonic()
    eng.stop()
    assert time.monotonic() - t0 < 5
    with pytest.raises(EngineShutdown):
        fut.result(timeout=5)
