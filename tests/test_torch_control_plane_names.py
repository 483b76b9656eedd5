"""Port parity: the public names the port's twins lacked, against the JAX
package.

* ``Engine.begin_drain`` / ``cancel_drain``: the drain handshake of
  ``tests/test_fleet.py``'s health test on both engines — health reads
  DRAINING (503 over HTTP), new submissions are refused, the in-flight
  request finishes, ``cancel_drain`` reopens admission, ``stop`` reads DEAD.
* ``CheckpointManager.close``: an async save then ``close`` leaves the step
  on disk for a fresh manager, in both packages.
* ``paged_decode_attention`` (K = 1) against the JAX function in interpret
  mode at ``tests/test_engine.py``'s shapes, 1e-5 in f32.
* ``FleetFaultConfig`` / ``FleetChaos``: the same relayed-event sequence
  fires the same kill/hang callbacks at the same events, cuts the same
  streams and hands each replica the same engine fault plan."""

import dataclasses
import json
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.serving.engine import Engine as JEngine
from kubeflow_tpu.serving.engine import EngineConfig as JEngineConfig
from kubeflow_tpu.serving.engine import faults as jfaults
from kubeflow_tpu.serving.engine import model as JM
from kubeflow_tpu.serving.engine.paged_attention import (
    paged_decode_attention as jax_paged_decode_attention)
from kubeflow_tpu.serving.engine.serve import JetStreamModel as JJetStreamModel
from kubeflow_tpu.serving.errors import EngineShutdown as JEngineShutdown
from kubeflow_tpu.serving.server import ModelServer as JModelServer
from kubeflow_tpu_torch.serving.engine import faults as tfaults
from kubeflow_tpu_torch.serving.engine import model as TM
from kubeflow_tpu_torch.serving.engine.engine import Engine, EngineConfig
from kubeflow_tpu_torch.serving.engine.paged_attention import paged_decode_attention
from kubeflow_tpu_torch.serving.engine.serve import JetStreamModel
from kubeflow_tpu_torch.serving.errors import EngineShutdown
from kubeflow_tpu_torch.serving.server import ModelServer
from kubeflow_tpu_torch.train.checkpoint import CheckpointManager

CFG_J = JM.DecoderConfig(vocab_size=288, d_model=32, n_layers=1, n_heads=2,
                         n_kv_heads=1, d_ff=64)


def _health(port: int) -> tuple:
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/engine/health", timeout=5) as r:
            return r.status, json.loads(r.read())["state"]
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())["state"]


def _drain_script(eng, srv, shutdown_error) -> list:
    """The fleet drain handshake on ``eng`` served by ``srv``: what a
    caller observes at each step."""
    seen = [("start", _health(srv.port))]
    fut = eng.generate_async([1, 2, 3], 12)
    eng.begin_drain()
    seen.append(("begin_drain", _health(srv.port), eng.health()["state"]))
    try:
        eng.generate_async([4, 5], 4)
        seen.append(("submit_while_draining", "accepted"))
    except shutdown_error:
        seen.append(("submit_while_draining", "EngineShutdown"))
    seen.append(("in_flight", fut.result(timeout=120)["num_tokens"]))
    eng.cancel_drain()
    seen.append(("cancel_drain", eng.health()["state"], eng.generate([1, 2], 2)["num_tokens"]))
    eng.stop()
    eng.cancel_drain()  # a no-op after stop
    seen.append(("stop", _health(srv.port), eng.health()["state"]))
    return seen


def test_begin_and_cancel_drain_match_the_jax_engine():
    jp = JM.init(jax.random.PRNGKey(0), CFG_J)
    tp = TM.params_from_jax({k: np.asarray(v) for k, v in jp.items()}, "cpu")
    tcfg = TM.DecoderConfig(**{f: getattr(CFG_J, f) for f in TM.DecoderConfig.__dataclass_fields__})
    kw = dict(max_slots=2, page_size=8, num_pages=64, max_pages_per_slot=16)
    runs = {}
    for name, eng, model_cls, server_cls, err in (
            ("jax", JEngine(jp, CFG_J, JEngineConfig(**kw)), JJetStreamModel, JModelServer,
             JEngineShutdown),
            ("port", Engine(tp, tcfg, EngineConfig(**kw), device="cpu"), JetStreamModel,
             ModelServer, EngineShutdown)):
        srv = server_cls([model_cls("m", "", engine=eng)], port=0)
        srv.start()
        try:
            runs[name] = _drain_script(eng, srv, err)
        finally:
            srv.stop()
            eng.stop(drain=False)
    assert runs["port"] == runs["jax"]
    assert runs["port"][1] == ("begin_drain", (503, "DRAINING"), "DRAINING")
    assert runs["port"][2] == ("submit_while_draining", "EngineShutdown")
    assert runs["port"][3] == ("in_flight", 12)
    assert runs["port"][-1] == ("stop", (503, "DEAD"), "DEAD")


def test_checkpoint_manager_close_leaves_the_step_on_disk(tmp_path):
    from kubeflow_tpu.train.checkpoint import CheckpointManager as JCheckpointManager

    rng = np.random.default_rng(0)
    state = {"w": rng.standard_normal((4, 3)).astype(np.float32),
             "b": rng.standard_normal((3,)).astype(np.float32)}
    got = {}
    for name, mgr_cls, to, back in (
            ("jax", JCheckpointManager, jnp.asarray, np.asarray),
            ("port", CheckpointManager, torch.from_numpy, lambda t: t.numpy())):
        d = tmp_path / name
        mgr = mgr_cls(str(d), async_save=True)
        mgr.save(3, {k: to(v) for k, v in state.items()})
        mgr.close()
        mgr.close()  # twice is safe
        fresh = mgr_cls(str(d), async_save=True)
        r = fresh.restore_latest({k: to(v) for k, v in state.items()})
        got[name] = (r["step"], {k: back(v) for k, v in r["state"].items()})
        fresh.close()
    assert got["port"][0] == got["jax"][0] == 3
    for k in state:
        np.testing.assert_array_equal(got["port"][1][k], got["jax"][1][k])
        np.testing.assert_array_equal(got["port"][1][k], state[k])


@jax.jit
def _jax_decode(q, k_pool, v_pool, page_table, seq_lens):
    return jax_paged_decode_attention(q, k_pool, v_pool, page_table, seq_lens, 8,
                                      interpret=True)


def test_paged_decode_attention_matches_the_jax_kernel():
    rng = np.random.default_rng(0)
    B, Hq, Hkv, hd, ps, P = 3, 4, 2, 16, 8, 12
    q = rng.standard_normal((B, Hq, hd)).astype(np.float32)
    k_pool = rng.standard_normal((P, Hkv, ps, hd)).astype(np.float32)
    v_pool = rng.standard_normal((P, Hkv, ps, hd)).astype(np.float32)
    table = np.asarray([[3, 5, 7], [1, 2, 0], [0, 0, 0]], np.int32)
    lens = np.asarray([20, 9, 0], np.int32)  # partial pages; slot 2 idle
    ref = np.asarray(_jax_decode(*map(jnp.asarray, (q, k_pool, v_pool, table, lens))))
    got = paged_decode_attention(*map(torch.from_numpy, (q, k_pool, v_pool, table, lens)), ps)
    assert got.shape == (B, Hq, hd)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got[2].numpy(), 0.0)


def _chaos_run(faults, plan: dict, events: list) -> dict:
    fired = []
    chaos = faults.FleetChaos(faults.FleetFaultConfig(**plan))
    for idx, port in enumerate((9001, 9002, 9003)):
        chaos.register_replica(idx, port,
                               kill_cb=lambda i=idx: fired.append(("kill", i)),
                               hang_cb=lambda i=idx: fired.append(("hang", i)))
    acts = [chaos.on_relay_event(port, key) for port, key in events]
    return {"fired": fired, "acts": acts, "stats": chaos.stats(),
            "engine_faults": [dataclasses.asdict(chaos.engine_faults(i)) for i in range(3)]}


@pytest.mark.parametrize("plan", [
    {},
    {"seed": 7, "kill": (1,), "kill_after_tokens": 4},
    {"seed": 3, "hang": (0, 2), "hang_after_tokens": 5, "hang_s": 1.5},
    {"seed": 11, "kill": (2,), "hang": (0,), "slow": (1,), "slow_tick_s": 0.05,
     "cut_stream_every": 2, "cut_after_events": 3},
], ids=["inert", "kill", "hang", "mixed"])
def test_fleet_chaos_schedule_matches_the_jax_plan(plan):
    rng = np.random.default_rng(len(plan))
    events = [(int(rng.choice([9001, 9002, 9003])), f"s{int(rng.integers(0, 6))}")
              for _ in range(60)]
    got, ref = _chaos_run(tfaults, plan, events), _chaos_run(jfaults, plan, events)
    assert got == ref
    if plan.get("kill"):
        assert got["stats"]["kills_fired"] == len(plan["kill"])
    if plan.get("cut_stream_every"):
        assert got["stats"]["streams_cut"] > 0
