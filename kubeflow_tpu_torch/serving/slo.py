"""Per-class SLO attainment tracking.

A copy of ``kubeflow_tpu/serving/slo.py``: the rolling-window view of the
serving latency objectives that the cumulative histograms cannot give.

  * ``SloConfig`` — per-(class, metric) latency targets, the attainment
    objective (the SLO itself, e.g. 0.99 = "99% of interactive requests
    get first token under target"), and the observation windows.  It is
    the ``engine.json`` ``"slo"`` block (``SloConfig.from_json``).
  * ``SloTracker`` — per-series rolling windows of (timestamp, met?)
    samples.  ``attainment(cls, metric, window)`` is the fraction of
    in-window requests that met their target; ``burn_rate`` is the
    Google-SRE multi-window form: (1 - attainment) / (1 - objective), so
    1.0 means burning error budget exactly at the sustainable rate and
    >>1 means paging territory.  Both export as gauges —
    ``slo_attainment_ratio{class,metric}`` (longest window) and
    ``slo_burn_rate{class,metric,window}`` (every window) — refreshed at
    scrape time by the serving surface.

The engine feeds the tracker from its telemetry hooks (TTFT at first
token, TPOT per commit, queue wait at admission), all host-side and O(1)
per observation.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Optional

# metrics a target can govern (the names double as the `metric` label)
SLO_METRICS = ("ttft", "tpot", "queue_wait")

# Default targets (seconds) per (class, metric): generous enough that a
# healthy engine attains ~1.0 even on the CPU test box, tight enough that
# saturation/preemption storms visibly burn budget.  Operators override
# via the engine.json ``slo`` block.
DEFAULT_TARGETS = (
    ("interactive", "ttft", 1.0),
    ("interactive", "tpot", 0.25),
    ("interactive", "queue_wait", 0.5),
    ("batch", "ttft", 10.0),
    ("batch", "tpot", 1.0),
    ("batch", "queue_wait", 30.0),
    ("best_effort", "ttft", 30.0),
    ("best_effort", "tpot", 2.5),
    ("best_effort", "queue_wait", 120.0),
)

# Burn-rate level above which the incident plane's slo_burn detector
# fires for a class with no explicit ``burn_threshold`` (README "Incident
# plane").  10x the sustainable rate means ~10% of requests are missing
# their target at a 0.99 objective — paging territory, not a blip; a
# healthy engine burns ~0 so clean runs never cross it.
DEFAULT_BURN_THRESHOLD = 10.0


@dataclasses.dataclass(frozen=True)
class SloConfig:
    """Immutable (hashable, like every other EngineConfig sub-config) SLO
    definition.  ``targets``: (class, metric, target_seconds) triples;
    ``objective``: the attainment the SLO promises; ``windows``: rolling
    windows in seconds, shortest first — burn rate exports one gauge per
    window (multi-window burn is what separates a blip from a trend)."""

    targets: tuple = DEFAULT_TARGETS
    objective: float = 0.99
    windows: tuple = (60.0, 600.0)
    # incident-plane burn detection (README "Incident plane"): per-class
    # (class, threshold) / (class, window_seconds) pairs — the burn level
    # that opens an incident and the rolling window it is read over.
    # Classes absent here use DEFAULT_BURN_THRESHOLD over the SHORTEST
    # configured window (fast detection; the multi-window gauges still
    # export every window for dashboards).
    burn_thresholds: tuple = ()
    burn_windows: tuple = ()
    # minimum in-window samples before the burn detector may fire: burn
    # computed over a handful of requests is statistically meaningless
    # (one cold-compile TTFT miss out of 5 reads as burn 20) and must
    # not page anyone
    burn_min_samples: int = 10
    # per-series sample cap: bounds memory on QPS spikes; attainment over a
    # window whose samples overflowed the cap is computed over what's kept
    # (the newest), which biases toward recent behavior — the right bias
    # for an SLO signal
    max_samples: int = 2048

    @classmethod
    def from_json(cls, raw: dict) -> "SloConfig":
        """Build from an engine.json ``slo`` block:
        ``{"targets": {"interactive": {"ttft": 0.5, ...}, ...},
           "objective": 0.99, "windows": [60, 600],
           "burn_threshold": {"interactive": 4.0, ...},
           "burn_window": {"interactive": 60, ...}}``.
        Classes/metrics omitted from ``targets`` keep their defaults;
        a target of null/<=0 drops that series entirely.
        ``burn_threshold``/``burn_window`` configure the incident plane's
        per-class burn detector (README "Incident plane") with the same
        unknown-class validation as ``targets`` — a typo'd class would
        otherwise leave the default threshold silently in force."""
        # deferred: engine.engine imports this module at load time, so
        # a top-level scheduler import would be circular
        from .engine.scheduler import PRIORITY_CLASSES
        kw: dict = {}
        tgt = raw.get("targets")
        if isinstance(tgt, dict):
            merged = {(c, m): t for c, m, t in DEFAULT_TARGETS}
            for cls_name, metrics in tgt.items():
                if cls_name not in PRIORITY_CLASSES:
                    # a typo'd class would otherwise leave the default
                    # target silently in force — no observation ever
                    # matches a class the scheduler never produces
                    raise ValueError(
                        f"unknown SLO priority class {cls_name!r} "
                        f"(known: {PRIORITY_CLASSES})")
                if not isinstance(metrics, dict):
                    continue
                for metric, target in metrics.items():
                    if metric not in SLO_METRICS:
                        raise ValueError(
                            f"unknown SLO metric {metric!r} "
                            f"(known: {SLO_METRICS})")
                    if target is None or float(target) <= 0:
                        merged.pop((cls_name, metric), None)
                    else:
                        merged[(cls_name, metric)] = float(target)
            kw["targets"] = tuple((c, m, t) for (c, m), t
                                  in sorted(merged.items()))
        if "objective" in raw:
            obj = float(raw["objective"])
            if not 0.0 < obj < 1.0:
                raise ValueError("slo objective must be in (0, 1), "
                                 f"got {obj}")
            kw["objective"] = obj
        if "windows" in raw:
            ws = tuple(sorted(float(w) for w in raw["windows"]))
            if not ws or any(w <= 0 for w in ws):
                raise ValueError(f"slo windows must be positive, got {ws}")
            kw["windows"] = ws
        if "max_samples" in raw:
            ms = int(raw["max_samples"])
            if ms < 1:
                # deque(maxlen=-1) would raise at FIRST OBSERVATION on the
                # engine loop thread; 0 would silently drop every sample
                raise ValueError(f"slo max_samples must be >= 1, got {ms}")
            kw["max_samples"] = ms
        bt = raw.get("burn_threshold")
        if isinstance(bt, dict):
            pairs = []
            for cls_name, thr in bt.items():
                if cls_name not in PRIORITY_CLASSES:
                    raise ValueError(
                        f"unknown burn_threshold priority class "
                        f"{cls_name!r} (known: {PRIORITY_CLASSES})")
                if float(thr) <= 0:
                    raise ValueError(
                        f"burn_threshold for {cls_name!r} must be > 0, "
                        f"got {thr}")
                pairs.append((cls_name, float(thr)))
            kw["burn_thresholds"] = tuple(sorted(pairs))
        bw = raw.get("burn_window")
        if isinstance(bw, dict):
            windows = kw.get("windows", cls.windows)
            pairs = []
            for cls_name, w in bw.items():
                if cls_name not in PRIORITY_CLASSES:
                    raise ValueError(
                        f"unknown burn_window priority class "
                        f"{cls_name!r} (known: {PRIORITY_CLASSES})")
                if float(w) not in windows:
                    # burn is only computed over the configured rolling
                    # windows; a detector window nothing computes would
                    # silently never fire
                    raise ValueError(
                        f"burn_window {w} for {cls_name!r} is not one of "
                        f"the configured windows {tuple(windows)}")
                pairs.append((cls_name, float(w)))
            kw["burn_windows"] = tuple(sorted(pairs))
        if "burn_min_samples" in raw:
            bms = int(raw["burn_min_samples"])
            if bms < 1:
                raise ValueError(
                    f"burn_min_samples must be >= 1, got {bms}")
            kw["burn_min_samples"] = bms
        return cls(**kw)


class RollingLatency:
    """Rolling (timestamp, value) window with cheap quantile/floor reads —
    the latency-VALUE companion to SloTracker's met/missed booleans.

    The overload controller (serving/overload.py) uses it two ways: the
    per-class p50 of observed queue+TTFT is the deadline early-reject
    estimator, and p50-vs-rolling-floor is the queue-wait gradient in the
    AIMD overload signal.  O(1) amortized observe (append + stale trim);
    reads are O(in-window samples), called at the controller's amortized
    adjust cadence, not per request.  NOT thread-safe — callers hold
    their own lock (the controller's admission lock already serializes
    every touch)."""

    __slots__ = ("window_s", "max_samples", "_dq")

    def __init__(self, window_s: float = 30.0, max_samples: int = 1024):
        self.window_s = float(window_s)
        self.max_samples = max_samples
        self._dq: collections.deque = collections.deque(maxlen=max_samples)

    def observe(self, value: float, now: float) -> None:
        self._dq.append((now, float(value)))
        cutoff = now - self.window_s
        while self._dq and self._dq[0][0] < cutoff:
            self._dq.popleft()

    def _in_window(self, now: float, window: Optional[float]) -> list:
        cutoff = now - (self.window_s if window is None else float(window))
        return [v for t, v in self._dq if t >= cutoff]

    def count(self, now: float, window: Optional[float] = None) -> int:
        return len(self._in_window(now, window))

    def quantile(self, q: float, now: float,
                 window: Optional[float] = None) -> Optional[float]:
        """The q-quantile of in-window values (None when empty)."""
        vals = sorted(self._in_window(now, window))
        if not vals:
            return None
        i = min(len(vals) - 1, max(0, int(q * len(vals))))
        return vals[i]

    def minimum(self, now: float,
                window: Optional[float] = None) -> Optional[float]:
        """The in-window floor — the gradient baseline: what this series
        looks like when nothing is queueing."""
        vals = self._in_window(now, window)
        return min(vals) if vals else None


class SloTracker:
    """Rolling per-(class, metric) attainment over the configured windows.

    ``observe`` is the hot-path entry (one deque append + stale-trim under
    a lock — O(1) amortized); ``attainment``/``burn_rate``/``export`` are
    scrape-time reads.  Timestamps default to time.monotonic(); tests pass
    explicit ``now`` for determinism."""

    def __init__(self, config: Optional[SloConfig] = None):
        self.config = config or SloConfig()
        self._targets = {(c, m): float(t) for c, m, t in self.config.targets}
        self._burn_thresholds = dict(self.config.burn_thresholds)
        self._burn_windows = dict(self.config.burn_windows)
        self._series: dict[tuple, collections.deque] = {}
        self._lock = threading.Lock()
        self._max_window = max(self.config.windows)

    def target(self, cls: str, metric: str) -> Optional[float]:
        return self._targets.get((cls, metric))

    def burn_threshold(self, cls: str) -> float:
        """The burn level above which the incident plane's slo_burn
        detector fires for this class (README "Incident plane")."""
        return self._burn_thresholds.get(cls, DEFAULT_BURN_THRESHOLD)

    def burn_window(self, cls: str) -> float:
        """The rolling window the burn detector reads for this class —
        the SHORTEST configured window unless overridden (detection wants
        the fast window; dashboards still get every window's gauge)."""
        return self._burn_windows.get(cls, min(self.config.windows))

    def observe(self, cls: str, metric: str, value: float,
                now: Optional[float] = None) -> None:
        target = self._targets.get((cls, metric))
        if target is None:
            return  # unconfigured series: free
        t = time.monotonic() if now is None else now
        key = (cls, metric)
        with self._lock:
            dq = self._series.get(key)
            if dq is None:
                dq = self._series[key] = collections.deque(
                    maxlen=self.config.max_samples)
            dq.append((t, value <= target))
            # amortized trim: drop samples older than the longest window so
            # a quiet series doesn't pin max_samples of dead history
            cutoff = t - self._max_window
            while dq and dq[0][0] < cutoff:
                dq.popleft()

    def attainment(self, cls: str, metric: str,
                   window: Optional[float] = None,
                   now: Optional[float] = None) -> Optional[float]:
        """Fraction of in-window observations that met the target; None
        when the series has no in-window samples (no data is not 1.0 and
        not 0.0 — exporters skip the sample entirely)."""
        window = self._max_window if window is None else float(window)
        t = time.monotonic() if now is None else now
        cutoff = t - window
        with self._lock:
            dq = self._series.get((cls, metric))
            if not dq:
                return None
            n = met = 0
            for ts, ok in reversed(dq):
                if ts < cutoff:
                    break
                n += 1
                met += ok
        return met / n if n else None

    def window_samples(self, cls: str, metric: str,
                       window: Optional[float] = None,
                       now: Optional[float] = None) -> int:
        """In-window observation count — the burn detector's evidence
        floor (``burn_min_samples``)."""
        window = self._max_window if window is None else float(window)
        t = time.monotonic() if now is None else now
        cutoff = t - window
        with self._lock:
            dq = self._series.get((cls, metric))
            if not dq:
                return 0
            n = 0
            for ts, _ok in reversed(dq):
                if ts < cutoff:
                    break
                n += 1
        return n

    def burn_rate(self, cls: str, metric: str, window: float,
                  now: Optional[float] = None) -> Optional[float]:
        """(1 - attainment) / (1 - objective): 0 = no errors, 1 = burning
        budget exactly at the sustainable rate, >1 = on track to violate
        the SLO before the budget period ends."""
        att = self.attainment(cls, metric, window, now)
        if att is None:
            return None
        return (1.0 - att) / max(1e-9, 1.0 - self.config.objective)

    def export(self, attainment_gauge, burn_gauge,
               now: Optional[float] = None) -> None:
        """Refresh the exported gauges (called at scrape time): attainment
        over the LONGEST window per series, burn rate per window.  A
        series whose samples aged out of every window is REMOVED from the
        gauges — freezing the last value would report a long-resolved SLO
        burn forever (and the autoscaler would eventually scale on it)."""
        with self._lock:
            keys = list(self._series)
        for cls, metric in keys:
            labels = {"class": cls, "metric": metric}
            att = self.attainment(cls, metric, now=now)
            if att is None:
                attainment_gauge.remove(**labels)
                for w in self.config.windows:
                    burn_gauge.remove(**{**labels, "window": f"{w:g}s"})
                continue
            attainment_gauge.set(att, **labels)
            for w in self.config.windows:
                br = self.burn_rate(cls, metric, w, now=now)
                wl = {**labels, "window": f"{w:g}s"}
                if br is not None:
                    burn_gauge.set(br, **wl)
                else:
                    burn_gauge.remove(**wl)

    def snapshot(self, now: Optional[float] = None) -> dict:
        """Nested read-only view for Engine.stats, the autoscaler, and
        the incident plane's burn detector + ``/fleet/incidents``
        evidence view (README "Incident plane" — one source of truth:
        the detector fires on exactly the burn values and thresholds
        this snapshot reports): {class: {metric: {"attainment": x,
        "target_s": t, "burn": {window: rate}, "burn_threshold": thr,
        "burn_window": "60s"}}}."""
        with self._lock:
            keys = list(self._series)
        out: dict = {}
        for cls, metric in keys:
            att = self.attainment(cls, metric, now=now)
            if att is None:
                continue
            rec = {"attainment": round(att, 4),
                   "target_s": self._targets[(cls, metric)],
                   "burn_threshold": self.burn_threshold(cls),
                   "burn_window": f"{self.burn_window(cls):g}s",
                   "burn_samples": self.window_samples(
                       cls, metric, self.burn_window(cls), now=now),
                   "burn_min_samples": self.config.burn_min_samples,
                   "burn": {}}
            for w in self.config.windows:
                br = self.burn_rate(cls, metric, w, now=now)
                if br is not None:
                    rec["burn"][f"{w:g}s"] = round(br, 3)
            out.setdefault(cls, {})[metric] = rec
        return out
