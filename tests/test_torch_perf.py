"""Port parity: the perf plane (FLOPs model, goodput ledger, timeline, cache
analytics) against the JAX package's on the CPU.

``FlopsModel`` prices Llama-3-8B and the tiny test config identically in
both packages.  ``platform_peak_flops`` resolves CUDA device kinds (the
H100 SXM and PCIe figures, an unknown kind at the SXM figure with a label
that says so) and keeps the JAX package's CPU estimate and
``ENGINE_PEAK_FLOPS`` override.  Then both engines take the same greedy
drive on the same weights — every request submitted before the loop
starts, so both loops tick the same schedule — on the sync and the
pipelined loop, plain and speculative: their tokens agree and their
ledgers charge the same FLOPs and positions per dispatch kind and the same
waste per reason (``pipeline_drop``, ``spec_reject``,
``preempt_recompute``).  Their tick timelines name the same phases and
their cache analytics count the same hits."""

import jax
import numpy as np
import pytest

from kubeflow_tpu.serving.engine import Engine as JEngine
from kubeflow_tpu.serving.engine import EngineConfig as JEngineConfig
from kubeflow_tpu.serving.engine import model as JM
from kubeflow_tpu.serving.engine import perf as JP
from kubeflow_tpu.serving.engine.faults import FaultConfig as JFaultConfig
from kubeflow_tpu.serving.engine.scheduler import SchedulerConfig as JSchedulerConfig
from kubeflow_tpu_torch.serving.engine import model as TM
from kubeflow_tpu_torch.serving.engine import perf as TP
from kubeflow_tpu_torch.serving.engine.engine import Engine, EngineConfig
from kubeflow_tpu_torch.serving.engine.faults import FaultConfig
from kubeflow_tpu_torch.serving.engine.scheduler import SchedulerConfig

CFG_J = JM.DecoderConfig(vocab_size=13, d_model=64, n_layers=2, n_heads=4,
                         n_kv_heads=2, d_ff=128)
GEO = dict(max_slots=4, num_pages=64, page_size=8, max_pages_per_slot=12,
           prefill_chunk=16)
# two short prompts, a chunked one, and one that shares the first's pages
PROMPTS = [[1, 2, 3, 4] * 4, [5, 6, 7, 8, 9, 10, 11, 12, 1, 2], [3, 1, 4, 1, 5, 9, 2, 6] * 4,
           [1, 2, 3, 4] * 4 + [7, 7]]
MAX_NEW = 14


def _port_cfg(cfg):
    return TM.DecoderConfig(**{f: getattr(cfg, f) for f in TM.DecoderConfig.__dataclass_fields__})


@pytest.fixture(scope="module")
def params():
    jp = JM.init(jax.random.PRNGKey(0), CFG_J)
    return jp, TM.params_from_jax({k: np.asarray(v) for k, v in jp.items()}, "cpu")


@pytest.mark.parametrize("which", ["tiny", "llama3_8b"])
def test_flops_model_matches(which):
    jc = CFG_J if which == "tiny" else JM.DecoderConfig.llama3_8b()
    a, b = TP.FlopsModel(_port_cfg(jc)), JP.FlopsModel(jc)
    assert (a.lin, a.attn_slope, a.per_token) == (b.lin, b.attn_slope, b.per_token)
    for toks, hist in ((1, 0), (17, 0), (256, 512), (1000, 24)):
        assert a.prefill_row(toks, hist) == b.prefill_row(toks, hist)
    for ctx in (0, 1, 100, 2048):
        assert a.decode_row(ctx) == b.decode_row(ctx)
        assert a.verify_row(ctx, 5) == b.verify_row(ctx, 5)


def test_platform_peak_flops(monkeypatch):
    monkeypatch.delenv("ENGINE_PEAK_FLOPS", raising=False)
    assert TP.platform_peak_flops("cuda", "NVIDIA H100 80GB HBM3") == ("cuda-h100-sxm", 989.4e12)
    assert TP.platform_peak_flops("cuda", "NVIDIA H100 PCIe") == ("cuda-h100-pcie", 756e12)
    label, peak = TP.platform_peak_flops("cuda", "Some Future GPU")
    assert label == "cuda-h100-sxm?" and peak == 989.4e12
    assert TP.platform_peak_flops("cuda", "NVIDIA H100 80GB HBM3", 4) == (
        "cuda-h100-sxmx4", 4 * 989.4e12)
    assert TP.platform_peak_flops("cpu") == JP.platform_peak_flops("cpu")
    monkeypatch.setenv("ENGINE_PEAK_FLOPS", "1e15")
    assert TP.platform_peak_flops("cpu") == JP.platform_peak_flops("cpu") == ("cpu!", 1e15)
    assert TP.platform_peak_flops("cuda", "NVIDIA H100 PCIe") == ("cuda-h100-pcie!", 1e15)


def _drive(engine, prompts=PROMPTS, max_new=MAX_NEW):
    futs = [engine.generate_async(list(p), max_new) for p in prompts]
    engine.start()
    try:
        toks = [f.result(timeout=120)["tokens"] for f in futs]
        return toks, engine.perf_snapshot()
    finally:
        engine.stop()


def _ledger(snap):
    keys = ("dispatched_flops", "flops_by_kind", "positions_by_kind", "goodput_flops",
            "goodput_positions", "waste_flops", "waste_positions", "accounted_flops")
    return {k: snap[k] for k in keys}


def _assert_ledgers_equal(a, b):
    la, lb = _ledger(a), _ledger(b)
    assert la.keys() == lb.keys()
    for k in la:
        if isinstance(la[k], dict):
            assert la[k].keys() == lb[k].keys(), k
            for r in la[k]:
                assert la[k][r] == pytest.approx(lb[k][r], rel=1e-12), (k, r)
        else:
            assert la[k] == pytest.approx(lb[k], rel=1e-12), k


MODES = {
    "sync": dict(pipeline_depth=0),
    "pipelined": dict(pipeline_depth=1),
    "sync_spec": dict(pipeline_depth=0, speculative="prompt_lookup", spec_ngram=1),
    "pipelined_spec": dict(pipeline_depth=1, speculative="prompt_lookup", spec_ngram=1),
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_ledger_charges_match_jax(params, mode):
    jp, tp = params
    kw = {**GEO, **MODES[mode]}
    jtoks, jsnap = _drive(JEngine(jp, CFG_J, JEngineConfig(**kw)))
    ttoks, tsnap = _drive(Engine(tp, _port_cfg(CFG_J), EngineConfig(**kw), device="cpu"))
    # the same schedule of the same lengths: the ledgers can only differ
    # if the tokens (which decide acceptance) differ
    assert ttoks == jtoks
    _assert_ledgers_equal(tsnap, jsnap)
    assert tsnap["accounted_flops"] == pytest.approx(tsnap["dispatched_flops"], rel=1e-12)
    assert tsnap["platform"] == "cpu" and 0 < tsnap["goodput_ratio"] <= 1
    if mode.endswith("spec"):
        assert tsnap["waste_flops"].get("spec_reject", 0) > 0
        assert tsnap["spec"] == jsnap["spec"]
    if mode == "pipelined":
        assert tsnap["waste_flops"].get("pipeline_drop", 0) > 0
    # the tick timeline names the same phases; cache analytics agree
    phases = lambda snap: {p for r in snap["timeline"] for p in r["segments"]}  # noqa: E731
    assert phases(tsnap) == phases(jsnap) and phases(tsnap) <= set(TP.TIMELINE_PHASES)
    assert tsnap["cache"]["lookups"] == jsnap["cache"]["lookups"]
    assert tsnap["cache"]["hit_pages"] == jsnap["cache"]["hit_pages"]
    assert tsnap.keys() == jsnap.keys()
    assert tsnap["cache"].keys() == jsnap["cache"].keys()
    assert tsnap["profiler"].keys() == jsnap["profiler"].keys()


def test_preempt_recompute_is_charged_as_waste(params):
    """A chaos preemption storm under the recompute policy: both ledgers
    charge the re-prefill of the victims' context to preempt_recompute."""
    jp, tp = params
    kw = dict(GEO, pipeline_depth=0)
    jtoks, jsnap = _drive(JEngine(jp, CFG_J, JEngineConfig(
        **kw, chaos=JFaultConfig(preempt_every=5),
        scheduler=JSchedulerConfig(swap_policy="recompute"))))
    ttoks, tsnap = _drive(Engine(tp, _port_cfg(CFG_J), EngineConfig(
        **kw, chaos=FaultConfig(preempt_every=5),
        scheduler=SchedulerConfig(swap_policy="recompute")), device="cpu"))
    assert ttoks == jtoks
    assert tsnap["waste_flops"].get("preempt_recompute", 0) > 0
    _assert_ledgers_equal(tsnap, jsnap)


def test_perf_off_charges_nothing(params):
    _, tp = params
    toks, snap = _drive(Engine(tp, _port_cfg(CFG_J),
                               EngineConfig(**GEO, perf=False), device="cpu"))
    assert all(len(t) == MAX_NEW for t in toks)
    assert snap["enabled"] is False and snap["dispatched_flops"] == 0
    assert snap["timeline"] == []
