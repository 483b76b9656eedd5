"""Prometheus-style metrics registry + /metrics endpoint.

A copy of ``kubeflow_tpu/core/metrics.py`` (the port imports nothing of the
JAX package): ``Registry``, ``Counter``, ``Gauge``, ``Histogram``, label
escaping and ``add_const_labels``.  The same observations render the same
exposition text, byte for byte, in both packages.
"""

from __future__ import annotations

import math
import threading
from typing import Optional, Sequence

# Prometheus client-library default latency buckets (seconds).
DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                   1.0, 2.5, 5.0, 10.0)


def escape_label_value(v) -> str:
    """Prometheus text-format label-value escaping: backslash, double
    quote, and newline must be escaped or the exposition is unparseable."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt_labels(key: tuple) -> str:
    return ",".join(f'{k}="{escape_label_value(val)}"' for k, val in key)


def add_const_labels(text: str, labels: dict) -> str:
    """Rewrite rendered exposition so every sample carries extra constant
    labels.  The multi-registry merge case: two engines in one server each
    render ``engine_ttft_seconds`` — without a distinguishing label the
    combined scrape has duplicate series and Prometheus rejects it whole.
    Comment/blank lines pass through; labels are appended after existing
    ones (label order is not significant to scrapers)."""
    if not labels:
        return text
    import re

    extra = ",".join(f'{k}="{escape_label_value(v)}"'
                     for k, v in sorted(labels.items()))
    sample = re.compile(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})? (.*)$')
    out = []
    for line in text.splitlines():
        if not line.strip() or line.startswith("#"):
            out.append(line)
            continue
        m = sample.match(line)
        if m is None:  # not a sample line: leave untouched
            out.append(line)
            continue
        name, labs, value = m.group(1), m.group(2), m.group(3)
        merged = f"{labs},{extra}" if labs else extra
        out.append(f"{name}{{{merged}}} {value}")
    return "\n".join(out) + ("\n" if text.endswith("\n") else "")


def _fmt_value(v: float) -> str:
    """Exact sample rendering: %g keeps 6 significant digits, which would
    round counters/sums past ~1e6 at the SOURCE exposition and break the
    fleet merge's sum-exact contract before merging even starts.  Integral
    values render as ints, everything else at full precision."""
    if math.isfinite(v) and v == int(v):
        return str(int(v))
    return repr(v)


class _Metric:
    def __init__(self, name: str, help_: str, kind: str):
        self.name = name
        self.help = help_
        self.kind = kind
        self._values: dict[tuple, float] = {}
        self._lock = threading.Lock()

    def labels_key(self, labels: dict) -> tuple:
        return tuple(sorted(labels.items()))

    def series(self) -> dict:
        """Snapshot of every label set's current value, keyed by the sorted
        (label, value) tuple — counter/gauge introspection for tests and
        benches without parsing the text exposition (the fleet bench reads
        retry/ejection counters this way)."""
        with self._lock:
            return dict(self._values)

    def remove(self, **labels) -> None:
        """Drop one label set's sample entirely.  A gauge whose underlying
        signal has no data must STOP exporting, not freeze at its last
        value (the SLO exporter uses this when a series' samples age out
        of every window)."""
        with self._lock:
            self._values.pop(self.labels_key(labels), None)

    def render(self) -> str:
        lines = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} {self.kind}"]
        with self._lock:
            for key, v in sorted(self._values.items()):
                label_s = _fmt_labels(key)
                v_s = _fmt_value(v)
                lines.append(f"{self.name}{{{label_s}}} {v_s}" if label_s else f"{self.name} {v_s}")
        return "\n".join(lines)


class Counter(_Metric):
    def __init__(self, name: str, help_: str):
        super().__init__(name, help_, "counter")

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = self.labels_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        return self._values.get(self.labels_key(labels), 0.0)


class Gauge(_Metric):
    def __init__(self, name: str, help_: str):
        super().__init__(name, help_, "gauge")

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._values[self.labels_key(labels)] = float(value)

    def value(self, **labels) -> float:
        return self._values.get(self.labels_key(labels), 0.0)


class Histogram(_Metric):
    """Prometheus histogram: cumulative ``_bucket{le=...}`` counts plus
    ``_sum``/``_count``, per label set.  Buckets are fixed at construction
    (upper bounds, seconds by convention); ``+Inf`` is implicit."""

    def __init__(self, name: str, help_: str,
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(name, help_, "histogram")
        self.buckets = tuple(sorted(set(float(b) for b in buckets)))
        if not self.buckets:
            raise ValueError("histogram needs at least one bucket bound")
        # label key -> [per-bucket counts (non-cumulative), sum, count]
        self._series: dict[tuple, list] = {}

    def observe(self, value: float, **labels) -> None:
        value = float(value)
        key = self.labels_key(labels)
        with self._lock:
            s = self._series.get(key)
            if s is None:
                s = self._series[key] = [[0] * (len(self.buckets) + 1), 0.0, 0]
            counts, _, _ = s
            # first bucket whose upper bound holds the value; the trailing
            # slot is +Inf
            for i, b in enumerate(self.buckets):
                if value <= b:
                    counts[i] += 1
                    break
            else:
                counts[-1] += 1
            s[1] += value
            s[2] += 1

    def remove(self, **labels) -> None:
        # histogram samples live in _series, not the base class's _values —
        # without this override remove() would silently no-op
        with self._lock:
            self._series.pop(self.labels_key(labels), None)

    def snapshot(self, **labels) -> dict:
        """(cumulative bucket counts, sum, count) for one label set —
        test/bench introspection without parsing the text format."""
        key = self.labels_key(labels)
        with self._lock:
            s = self._series.get(key)
            if s is None:
                return {"buckets": {}, "sum": 0.0, "count": 0}
            cum, acc = {}, 0
            for b, c in zip(self.buckets, s[0]):
                acc += c
                cum[b] = acc
            return {"buckets": cum, "sum": s[1], "count": s[2]}

    def quantile(self, q: float, **labels) -> float:
        """Estimate the q-quantile (0..1) by linear interpolation inside the
        owning bucket — the PromQL histogram_quantile estimator."""
        snap = self.snapshot(**labels)
        n = snap["count"]
        if n == 0:
            return 0.0
        rank = q * n
        lo = 0.0
        prev_c = 0
        for b, c in snap["buckets"].items():
            if c >= rank:
                width = b - lo
                frac = (rank - prev_c) / max(1, c - prev_c)
                return lo + width * frac
            lo, prev_c = b, c
        return self.buckets[-1]

    def render(self) -> str:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} histogram"]
        with self._lock:
            for key, (counts, sum_, count) in sorted(self._series.items()):
                base = _fmt_labels(key)
                acc = 0
                for b, c in zip(self.buckets, counts):
                    acc += c
                    lab = (base + "," if base else "") + f'le="{b:g}"'
                    lines.append(f"{self.name}_bucket{{{lab}}} {acc}")
                lab = (base + "," if base else "") + 'le="+Inf"'
                lines.append(f"{self.name}_bucket{{{lab}}} {count}")
                sfx = f"{{{base}}}" if base else ""
                lines.append(f"{self.name}_sum{sfx} {_fmt_value(sum_)}")
                lines.append(f"{self.name}_count{sfx} {count}")
        return "\n".join(lines)


class Registry:
    def __init__(self):
        self._metrics: dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def counter(self, name: str, help_: str = "") -> Counter:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = Counter(name, help_)
            return m  # type: ignore[return-value]

    def gauge(self, name: str, help_: str = "") -> Gauge:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = Gauge(name, help_)
            return m  # type: ignore[return-value]

    def histogram(self, name: str, help_: str = "",
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = Histogram(name, help_, buckets)
            return m  # type: ignore[return-value]

    def names(self) -> list[str]:
        """Registered metric names — the metrics-conformance test walks
        these against the README metric table."""
        with self._lock:
            return sorted(self._metrics)

    def render(self) -> str:
        with self._lock:
            metrics = list(self._metrics.values())
        return "\n".join(m.render() for m in metrics) + "\n"


# ------------------------------------------------ fleet-scrape merge helpers

_EXPO_SAMPLE = None  # compiled lazily (merge is a debug/scrape-time path)


def parse_exposition(text: str) -> dict:
    """Parse Prometheus text exposition into
    ``{name: {"type": kind|None, "help": str|None, "samples":
    [(labels_dict, value)]}}``.  Histogram component series
    (``_bucket``/``_sum``/``_count``) are grouped under their base name's
    entry when a ``# TYPE <base> histogram`` line declared them."""
    global _EXPO_SAMPLE
    if _EXPO_SAMPLE is None:
        import re
        _EXPO_SAMPLE = (
            re.compile(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})? (\S+)$'),
            re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"'),
            re.compile(r'\\(.)'))
    sample_re, label_re, esc_re = _EXPO_SAMPLE
    # single-pass unescape: chained str.replace would decode the \\ of a
    # literal backslash FIRST or LAST and either way corrupt sequences
    # like backslash-then-n (escaped as \\n, which must NOT become \n)
    unescape = lambda v: esc_re.sub(  # noqa: E731
        lambda m: {"n": "\n"}.get(m.group(1), m.group(1)), v)
    out: dict = {}

    def entry(name: str) -> dict:
        return out.setdefault(name, {"type": None, "help": None,
                                     "samples": []})

    hist_bases: set = set()
    for line in text.splitlines():
        if not line.strip():
            continue
        if line.startswith("# TYPE "):
            parts = line.split(" ", 3)
            if len(parts) >= 4:
                entry(parts[2])["type"] = parts[3].strip()
                if parts[3].strip() == "histogram":
                    hist_bases.add(parts[2])
            continue
        if line.startswith("# HELP "):
            parts = line.split(" ", 3)
            if len(parts) >= 3:
                entry(parts[2])["help"] = parts[3] if len(parts) > 3 else ""
            continue
        if line.startswith("#"):
            continue
        m = sample_re.match(line)
        if m is None:
            continue
        name, labs, val = m.group(1), m.group(2) or "", m.group(3)
        try:
            value = float(val)
        except ValueError:
            continue
        labels = {k: unescape(v) for k, v in label_re.findall(labs)}
        # histogram component samples file under the BASE name so merge
        # logic sees one histogram, not three pseudo-metrics
        base = name
        for sfx in ("_bucket", "_sum", "_count"):
            if name.endswith(sfx) and name[:-len(sfx)] in hist_bases:
                base = name[:-len(sfx)]
                labels["__series__"] = sfx
                break
        entry(base)["samples"].append((labels, value))
    return out


def merge_expositions(replica_texts: dict) -> str:
    """Merge per-replica /metrics expositions into one fleet view
    (``GET /fleet/metrics`` on the service proxy).

    Counters and histograms are ADDITIVE across replicas: series with the
    same label set sum sample-by-sample — histogram buckets, ``_sum`` and
    ``_count`` are all plain sums, so the merged histogram is exactly the
    histogram of the union of observations (sum-exact, tested).  Gauges
    are NOT additive (two replicas' occupancy ratios don't add): each
    gauge sample instead keeps its replica as a ``replica`` label.
    Untyped samples (the model server's flat extra_metrics gauges) are
    treated as gauges.  ``replica_texts``: {replica_label: exposition}."""
    merged: dict = {}
    for replica in sorted(replica_texts):
        parsed = parse_exposition(replica_texts[replica])
        for name, rec in parsed.items():
            m = merged.setdefault(name, {"type": rec["type"],
                                         "help": rec["help"],
                                         "series": {}})
            if m["type"] is None:
                m["type"] = rec["type"]
            if m["help"] is None:
                m["help"] = rec["help"]
            kind = rec["type"] or "gauge"
            additive = kind in ("counter", "histogram")
            for labels, value in rec["samples"]:
                labels = dict(labels)
                if not additive:
                    labels["replica"] = replica
                key = tuple(sorted(labels.items()))
                if additive:
                    m["series"][key] = m["series"].get(key, 0.0) + value
                else:
                    m["series"][key] = value
    lines = []
    for name in sorted(merged):
        m = merged[name]
        kind = m["type"] or "gauge"
        if m["help"] is not None:
            lines.append(f"# HELP {name} {m['help']}")
        lines.append(f"# TYPE {name} {kind}")
        for key in sorted(m["series"], key=_series_sort_key):
            labels = dict(key)
            sfx = labels.pop("__series__", "")
            label_s = _fmt_labels(tuple(sorted(labels.items())))
            sample_name = name + sfx
            body = f"{sample_name}{{{label_s}}}" if label_s else sample_name
            lines.append(f"{body} {_fmt_value(m['series'][key])}")
    return "\n".join(lines) + "\n"


def _series_sort_key(key: tuple) -> tuple:
    """Stable series ordering for the merged exposition: histogram
    component (_bucket < _sum < _count), then bucket bound numerically,
    then the remaining labels lexically — so merged buckets render in
    ascending-le order like a native histogram."""
    labels = dict(key)
    sfx = labels.pop("__series__", "")
    sfx_rank = {"": 0, "_bucket": 0, "_sum": 1, "_count": 2}.get(sfx, 3)
    le = labels.pop("le", None)
    if le == "+Inf":
        le_rank = float("inf")
    else:
        try:
            le_rank = float(le) if le is not None else float("-inf")
        except ValueError:
            le_rank = float("inf")
    return (tuple(sorted(labels.items())), sfx_rank, le_rank)


REGISTRY = Registry()

# the controller-runtime-equivalent core metrics
RECONCILE_TOTAL = REGISTRY.counter(
    "controller_runtime_reconcile_total", "reconciles per controller kind and result"
)
RECONCILE_ERRORS = REGISTRY.counter(
    "controller_runtime_reconcile_errors_total", "reconcile panics/errors per kind"
)
JOBS_CREATED = REGISTRY.counter("training_operator_jobs_created_total", "jobs accepted")
JOBS_SUCCESSFUL = REGISTRY.counter("training_operator_jobs_successful_total", "jobs succeeded")
JOBS_FAILED = REGISTRY.counter("training_operator_jobs_failed_total", "jobs failed")
JOBS_RESTARTED = REGISTRY.counter("training_operator_jobs_restarted_total", "job pod restarts")


def serve(port: int = 0) -> tuple[int, object]:
    """Expose /metrics over HTTP; returns (bound_port, server). port=0 picks
    a free port.  Runs in a daemon thread (shutdown() the server to stop)."""
    from http.server import BaseHTTPRequestHandler, HTTPServer

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 (stdlib API)
            if self.path.rstrip("/") not in ("", "/metrics"):
                self.send_response(404)
                self.end_headers()
                return
            body = REGISTRY.render().encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):  # pragma: no cover - silence stdlib
            pass

    server = HTTPServer(("127.0.0.1", port), Handler)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    return server.server_address[1], server
