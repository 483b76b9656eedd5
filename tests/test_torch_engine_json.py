"""Port parity: ``engine.json`` in a model dir, read by ``JetStreamModel.load``.

The same files go through both packages' loaders: the ``scheduler`` block
(``adapter_weights`` as a JSON list of pairs), the ``kv_store`` block with
its storage ``chaos``, the dispatch ``chaos`` and ``slo`` blocks, the
watchdog, telemetry, perf and incident keys off their defaults, the
disaggregation and fabric keys (``role``, ``fabric``, ``handoff_ttl_s``,
the ``handoff_chaos`` and ``fabric_chaos`` blocks), a bad ``role``, bad
``speculative`` compositions and ``tensor_parallel: 0``.  Both
build the same config values, or both raise the same ValueError (naming the
file where the JAX package names it).  A key whose feature the port lacks
is accepted at the JAX package's default and refused otherwise, naming the
file, the key and the ROADMAP item; the port's literal map of those keys
equals the JAX EngineConfig's fields and defaults minus the port's own.  A
chaos block that arms a sharded-frame (``shard_*``) injector is refused
the same way, naming item 1.8."""

import dataclasses
import json

import pytest

from kubeflow_tpu.serving.engine.engine import EngineConfig as JEngineConfig
from kubeflow_tpu.serving.engine.serve import JetStreamModel as JJetStreamModel
from kubeflow_tpu_torch.serving.engine import serve as S
from kubeflow_tpu_torch.serving.engine.engine import EngineConfig

CONFIG = {"vocab_size": 64, "d_model": 32, "n_layers": 1, "n_heads": 2,
          "n_kv_heads": 1, "d_ff": 64}
GEO = {"max_slots": 2, "num_pages": 16, "page_size": 8, "max_pages_per_slot": 4}
SCHED = {"policy": "fifo", "preemption": False, "swap_policy": "recompute",
         "swap_min_tokens": 64, "min_free_pages": 2, "adapter_weights": []}

# name -> engine.json body; "{dir}" is the model dir
SAME = {
    "scheduler": {"scheduler": SCHED},
    "kv_store_chaos": {"kv_store": {"host_max_bytes": 4096, "disk_dir": "{dir}/kv",
                                    "chaos": {"bit_flip_every": 1, "seed": 7}}},
    "defaults_of_unported_keys": {"role": "unified", "tensor_parallel": 1,
                                  "weight_quant": None, "max_consecutive_failures": 3,
                                  "drain_timeout_s": 10, "chaos": None, "fabric": False},
    "unknown_key_dropped": {"not_a_field": 1, "eos_ids": [3, 4]},
    "speculative": {"speculative": "prompt_lookup", "spec_max_draft": 2, "spec_ngram": 1},
    # every key of the observability and supervision slice, off its default
    "observability": {
        "max_consecutive_failures": 5, "watchdog_interval_s": 0.1,
        "hang_timeout_s": 30.0, "watchdog_restart": False, "drain_timeout_s": 2.0,
        "telemetry": False, "flight_recorder_capacity": 64, "flight_dir": "{dir}/flight",
        "trace_history": 10, "trace_history_bytes": 5000, "perf": True,
        "perf_window_s": 10.0, "perf_timeline_capacity": 32, "profile_dir": "{dir}/prof",
        "profile_max_runs": 2, "profile_max_bytes": 1000000, "incidents": True,
        "incident_dir": "{dir}/inc", "incident_debounce_s": 1.0,
        "incident_resolve_s": 2.0, "incident_poll_s": 0.5,
        "incident_tick_overrun_s": 1.0},
    "chaos": {"chaos": {"seed": 3, "nan_logit_rate": 0.5, "target_rids": [1, 2],
                        "nan_phase": "decode", "slow_tick_on": 4, "slow_tick_s": 0.01,
                        "preempt_every": 7}},
    "slo": {"slo": {"targets": {"interactive": {"ttft": 0.5, "tpot": None},
                                "batch": {"queue_wait": 5}},
                    "objective": 0.95, "windows": [30, 300],
                    "burn_threshold": {"interactive": 4.0},
                    "burn_window": {"interactive": 30}}},
    # the disaggregation and fabric keys
    "role": {"role": "decode"},
    "fabric": {"fabric": True, "fabric_ttl_s": 30.0, "fabric_max_bytes": 1 << 20,
               "fabric_min_pages": 2},
    "handoff_ttl_s": {"handoff_ttl_s": 5.0, "handoff_max_bytes": 1 << 20},
    "handoff_chaos": {"role": "prefill",
                      "handoff_chaos": {"seed": 2, "torn_pull_on": 1, "slow_pull_s": 0.1,
                                        "slow_pull_every": 3, "dead_link_every": 5,
                                        "expire_export_on": 2}},
    "fabric_chaos": {"fabric": True,
                     "fabric_chaos": {"flip_pull_every": 2, "dead_link_on": 3,
                                      "expire_publish_every": 4}},
}
BOTH_RAISE = {
    "adapter_weights": {"scheduler": {"adapter_weights": [["a1", 2.0]]}},
    "bad_role": {"role": "bogus"},
    "bad_speculative": {"speculative": "medusa"},
    "speculative_temperature": {"speculative": "prompt_lookup", "temperature": 0.5},
    "speculative_draft": {"speculative": "prompt_lookup", "spec_max_draft": 0},
    "tensor_parallel_zero": {"tensor_parallel": 0},
}
# unported features off their default: refused by the port
PORT_REFUSES = {
    "tensor_parallel": ({"tensor_parallel": 4}, "1.8"),
    "weight_quant": ({"weight_quant": "int8"}, "1.6"),
    "constrain_chaos": ({"constrain_chaos": {"stall_on": 1}}, "1.4"),
    # a sharded-frame injector: the port reads no version 2 frame
    "handoff_chaos": ({"handoff_chaos": {"shard_torn_pull_on": 1}}, "1.8"),
    "fabric_chaos": ({"fabric_chaos": {"shard_flip_pull_every": 2}}, "1.8"),
}


def _model_dir(tmp_path, body) -> str:
    d = tmp_path / "m"
    d.mkdir()
    (d / "config.json").write_text(json.dumps(CONFIG))
    text = json.dumps({**GEO, **body}).replace("{dir}", str(d))
    (d / "engine.json").write_text(text)
    return str(d)


def _load(model_cls, d, **kw):
    m = model_cls("m", d, **kw)
    m.load()
    m.engine.stop()
    return m.engine.ec


def _port(d):
    return _load(S.JetStreamModel, d, device="cpu")


def _jax(d):
    return _load(JJetStreamModel, d)


@pytest.mark.parametrize("case", sorted(SAME))
def test_both_packages_build_the_same_config(tmp_path, case):
    d = _model_dir(tmp_path, SAME[case])
    port, ref = _port(d), _jax(d)
    for f in dataclasses.fields(EngineConfig):
        a, b = getattr(port, f.name), getattr(ref, f.name)
        if f.name == "paged_kernel":
            continue  # the port's kernel switch defaults on; the JAX one auto
        if dataclasses.is_dataclass(a):
            assert dataclasses.asdict(a) == dataclasses.asdict(b), f.name
        else:
            assert a == b, f.name
    if case == "scheduler":
        assert port.scheduler.policy == "fifo" and port.scheduler.adapter_weights == ()
    if case == "kv_store_chaos":
        assert port.kv_store.chaos.bit_flip_every == 1
    if case == "chaos":
        assert port.chaos.target_rids == (1, 2) and port.chaos.preempt_every == 7
    if case == "slo":
        assert port.slo.objective == 0.95 and port.slo.windows == (30.0, 300.0)
        assert ("interactive", "ttft", 0.5) in port.slo.targets
    if case == "observability":
        assert port.incidents and not port.telemetry and port.hang_timeout_s == 30.0
    if case == "handoff_chaos":
        assert port.role == "prefill" and port.handoff_chaos.expire_export_on == 2
    if case == "fabric_chaos":
        assert port.fabric and port.fabric_chaos.flip_pull_every == 2


@pytest.mark.parametrize("case", sorted(BOTH_RAISE))
def test_both_packages_refuse_the_same_file(tmp_path, case):
    d = _model_dir(tmp_path, BOTH_RAISE[case])
    with pytest.raises(ValueError) as ref:
        _jax(d)
    with pytest.raises(ValueError) as port:
        _port(d)
    assert str(port.value) == str(ref.value)
    if case != "adapter_weights":  # the engine's own check names no file
        assert str(port.value).startswith(f"{d}/engine.json: ")


@pytest.mark.parametrize("key", sorted(PORT_REFUSES))
def test_port_refuses_an_unported_key_off_its_default(tmp_path, key):
    body, item = PORT_REFUSES[key]
    d = _model_dir(tmp_path, body)
    with pytest.raises(ValueError) as e:
        _port(d)
    msg = str(e.value)
    assert msg.startswith(f"{d}/engine.json: {key}=") and f"ROADMAP item {item}" in msg


def test_unported_key_map_is_the_jax_fields_minus_the_ports():
    ours = {f.name for f in dataclasses.fields(EngineConfig)}
    want = {}
    for f in dataclasses.fields(JEngineConfig):
        if f.name not in ours:
            assert f.default_factory is dataclasses.MISSING, f.name
            want[f.name] = f.default
    assert {k: v[0] for k, v in S._UNPORTED_ENGINE_KEYS.items()} == want
    assert len(want) == 3
    assert {v[1] for v in S._UNPORTED_ENGINE_KEYS.values()} <= {"1.3", "1.4", "1.6", "1.8"}
