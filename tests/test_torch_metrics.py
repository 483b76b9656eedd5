"""Port parity: the metrics registry, trace context and SLO tracker copies.

``kubeflow_tpu_torch.core.metrics``, ``core.tracing``, ``serving.slo`` and
the engine's ``EngineTelemetry`` are copies of the JAX package's modules:
the same observations (numpy-seeded values, label values that need
escaping) render byte-identical Prometheus text in both, ``traceparent``
headers parse to the same contexts and format back to the same strings,
and the same ``engine.json`` ``slo`` block builds the same ``SloConfig``,
whose tracker then reports the same attainment and burn rates."""

import dataclasses

import numpy as np
import pytest

from kubeflow_tpu.core import metrics as JMx
from kubeflow_tpu.core import tracing as JTr
from kubeflow_tpu.serving import slo as JSlo
from kubeflow_tpu.serving.engine import telemetry as JTel
from kubeflow_tpu_torch.core import metrics as TMx
from kubeflow_tpu_torch.core import tracing as TTr
from kubeflow_tpu_torch.serving import slo as TSlo
from kubeflow_tpu_torch.serving.engine import telemetry as TTel

LABELS = ("plain", 'quo"te', "back\\slash", "new\nline")


def _drive_registry(mod, seed: int) -> str:
    """One numpy-seeded sequence of counter, gauge and histogram updates."""
    rng = np.random.default_rng(seed)
    reg = mod.Registry()
    c = reg.counter("requests_total", "requests by outcome")
    g = reg.gauge("queue_depth", "queued requests")
    h = reg.histogram("latency_seconds", "request latency",
                      buckets=(0.001, 0.01, 0.1, 1.0))
    for _ in range(40):
        lab = LABELS[int(rng.integers(len(LABELS)))]
        c.inc(float(rng.integers(1, 4)), outcome=lab)
        g.set(float(rng.random() * 10), shard=lab)
        h.observe(float(rng.exponential(0.05)), cls=lab)
    h.observe(2.5)  # past the last bucket, unlabelled
    return reg.render()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_registry_text_is_byte_identical(seed):
    assert _drive_registry(TMx, seed) == _drive_registry(JMx, seed)


def test_const_labels_and_escaping_are_identical():
    text = _drive_registry(JMx, 3)
    labels = {"model": 'llama"3\n8b'}
    assert TMx.add_const_labels(text, labels) == JMx.add_const_labels(text, labels)
    for v in LABELS:
        assert TMx.escape_label_value(v) == JMx.escape_label_value(v)


def _drive_telemetry(mod, seed: int) -> str:
    """The engine registry under a numpy-seeded observation sequence that
    touches every family the port's engine feeds."""
    rng = np.random.default_rng(seed)
    slo_mod = JSlo if mod is JTel else TSlo
    tel = mod.EngineTelemetry(enabled=True, slo=slo_mod.SloTracker(slo_mod.SloConfig()))
    for i in range(30):
        cls = ("interactive", "batch", "best_effort")[i % 3]
        tel.observe_ttft(float(rng.exponential(0.2)), cls)
        tel.observe_tpot(float(rng.exponential(0.02)), cls)
        tel.observe_queue_wait(float(rng.exponential(0.05)), cls)
        tel.observe_tick(float(rng.exponential(0.01)))
        tel.observe_dispatch_gap(float(rng.exponential(0.001)))
        tel.observe_prefill_batch(int(rng.integers(1, 9)))
        tel.observe_spec(4, int(rng.integers(0, 5)))
        tel.count_outcome(("done", "failed", "shed", "cancelled")[i % 4])
        tel.count_fence(("admit", "finish", "nan", "restart")[i % 4])
        tel.count_flops(("prefill", "decode", "verify")[i % 3], float(rng.random() * 1e9),
                        (None, "spec_reject", "pipeline_drop")[i % 3])
        tel.count_cache_pages(4, int(rng.integers(0, 5)))
        tel.count_preemption(("priority", "pages", "chaos")[i % 3], ("swap", "recompute")[i % 2])
        tel.count_swap(("in", "out")[i % 2], int(rng.integers(1, 1 << 20)))
        tel.count_kv_event(("host", "disk")[i % 2], ("put", "evict", "verify_fail")[i % 3])
        tel.count_session_restore(("host", "disk", "cold", "degraded")[i % 4])
        tel.count_session_pin(("pinned", "durable", "rejected")[i % 3])
    tel.count_trace_evictions(3)
    tel.set_kv_pages(100, 20, 511)
    tel.set_kv_store_bytes(1 << 20, 1 << 22)
    tel.set_health("DEGRADED")
    tel.set_incidents_open(2)
    tel.set_perf(0.0012, 0.93, 0.25, "cuda-h100-sxm")
    tel.count_incident_firing("watchdog")
    tel.count_incident("replica_death")
    tel.refresh_slo()
    return tel.render()


@pytest.mark.parametrize("seed", [0, 7])
def test_engine_telemetry_renders_identically(seed, monkeypatch):
    # the SLO windows read time.monotonic: pin it so both trackers see the
    # same sample ages
    for mod in (JSlo, TSlo):
        monkeypatch.setattr(mod.time, "monotonic", lambda: 1000.0)
    assert _drive_telemetry(TTel, seed) == _drive_telemetry(JTel, seed)


TRACEPARENTS = [
    "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01",
    "00-4BF92F3577B34DA6A3CE929D0E0E4736-00F067AA0BA902B7-01",
    " 00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-00 ",
    "00-00000000000000000000000000000000-00f067aa0ba902b7-01",
    "00-4bf92f3577b34da6a3ce929d0e0e4736-0000000000000000-01",
    "ff-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01",
    "00-4bf92f3577b34da6a3ce929d0e0e473-00f067aa0ba902b7-01",
    "garbage", "", None, 17,
]


@pytest.mark.parametrize("header", TRACEPARENTS, ids=range(len(TRACEPARENTS)))
def test_traceparent_parse_is_identical(header):
    a, b = TTr.parse_traceparent(header), JTr.parse_traceparent(header)
    assert (a is None) == (b is None)
    if a is not None:
        assert (a.trace_id, a.span_id, a.parent_id) == (b.trace_id, b.span_id, b.parent_id)
        assert a.traceparent() == b.traceparent()


def test_mint_and_child_follow_the_same_format():
    for mod_a, mod_b in ((TTr, JTr), (JTr, TTr)):
        ctx = mod_a.TraceContext.mint()
        # a context minted by one package parses in the other, and its
        # child keeps the trace id with the parent link
        back = mod_b.parse_traceparent(ctx.traceparent())
        assert (back.trace_id, back.span_id) == (ctx.trace_id, ctx.span_id)
        kid = back.child()
        assert kid.trace_id == ctx.trace_id and kid.parent_id == ctx.span_id
        assert len(kid.trace_id) == 32 and mod_a.SPAN_ID_RE.match(kid.span_id)
    fixed = (TTr.TraceContext("ab" * 16, "cd" * 8), JTr.TraceContext("ab" * 16, "cd" * 8))
    assert fixed[0].traceparent() == fixed[1].traceparent()


SLO_BLOCKS = [
    {},
    {"targets": {"interactive": {"ttft": 0.5, "tpot": None}, "batch": {"queue_wait": 5}},
     "objective": 0.95, "windows": [30, 300]},
    {"windows": [30, 300], "burn_threshold": {"interactive": 4.0},
     "burn_window": {"interactive": 30}, "burn_min_samples": 3},
]


@pytest.mark.parametrize("block", range(len(SLO_BLOCKS)))
def test_slo_config_and_tracker_match(block, monkeypatch):
    raw = SLO_BLOCKS[block]
    ta, tb = TSlo.SloConfig.from_json(dict(raw)), JSlo.SloConfig.from_json(dict(raw))
    assert dataclasses.asdict(ta) == dataclasses.asdict(tb)
    now = [500.0]
    for mod in (JSlo, TSlo):
        monkeypatch.setattr(mod.time, "monotonic", lambda: now[0])
    rng = np.random.default_rng(block)
    ka, kb = TSlo.SloTracker(ta), JSlo.SloTracker(tb)
    for _ in range(50):
        now[0] += float(rng.random())
        cls = ("interactive", "batch")[int(rng.integers(2))]
        v = float(rng.exponential(0.5))
        for k in (ka, kb):
            k.observe(cls, "ttft", v)
            k.observe(cls, "queue_wait", v / 10)
    assert ka.snapshot() == kb.snapshot()


def test_slo_rejects_the_same_bad_blocks():
    for bad in ({"targets": {"nosuchclass": {"ttft": 1}}},
                {"burn_threshold": {"nosuchclass": 2.0}}):
        with pytest.raises(ValueError) as a:
            TSlo.SloConfig.from_json(bad)
        with pytest.raises(ValueError) as b:
            JSlo.SloConfig.from_json(bad)
        assert str(a.value) == str(b.value)
