"""Performance introspection plane: FLOPs/MFU accounting, goodput
attribution, tick-phase timelines, cache analytics.

A copy of ``kubeflow_tpu/serving/engine/perf.py`` whose peak-FLOPs table
knows CUDA device kinds in place of TPU variants.  Four parts:

  * ``FlopsModel`` — analytical per-dispatch FLOPs derived from the model
    config (model.DecoderConfig.matmul_flops_per_token /
    attn_flops_per_token): prefill ``[B, L]`` charged per ROW at the
    row's real length (padding is not work the model asked for), decode
    ``[B]`` at the row's context length, fused verify ``[B, K]`` at the
    row's real draft count.  Matmul FLOPs only, mirroring the training
    side's accounting so serving and training MFU rows compare.

  * ``PerfLedger`` — the goodput ledger.  ONE charge API:
    ``charge(kind, flops, positions, reason)`` where ``reason=None``
    means useful (goodput) work and any other reason is waste —
    ``goodput + sum(waste) == dispatched`` holds BY CONSTRUCTION, not by
    reconciliation.  Waste reasons: ``spec_reject`` (verify positions
    whose drafts greedy rejected), ``preempt_recompute`` (re-prefill of a
    drop-preempted victim's already-computed context),
    ``handoff_degraded`` / ``fabric_degraded`` (imports that fell back to
    re-prefill), ``failover_reprefill`` (an ingress failover re-admission
    re-prefilling tokens a dead replica already produced), ``tick_retry``
    (a failed/NaN dispatch whose work was discarded), ``pipeline_drop``
    (rows dispatched behind a finish/preempt and discarded by the
    commit-behind rid guard).  A rolling window over the charges derives
    ``engine_mfu_ratio`` (against the platform peak-FLOPs table) and
    ``engine_goodput_ratio`` at scrape time.

  * ``TickTimeline`` — per-tick phase segments (admit / prefill_dispatch /
    decode_dispatch / readback / commit_behind / drain) on the loop
    thread, kept in a bounded ring like the FlightRecorder: the "where
    did this tick's time go" answer a flat tick-duration histogram
    cannot give.

  * ``CacheStats`` + ``ProfileStore`` — prefix-cache hit/miss-by-reason
    counters with bounded per-prefix reuse counts, and the managed
    ``torch.profiler`` artifact store: capture dirs are capped in count
    AND bytes with oldest-first eviction and removed on ``Engine.stop()``.

Served as ``GET /engine/perf`` (JSON snapshot) and /metrics gauges.
"""

from __future__ import annotations

import collections
import os
import shutil
import threading
import time
from typing import Optional

# canonical waste-attribution reasons (README "Performance introspection")
WASTE_REASONS = ("spec_reject", "preempt_recompute", "handoff_degraded",
                 "fabric_degraded", "failover_reprefill", "tick_retry",
                 "pipeline_drop")

# dispatch kinds the ledger buckets by
DISPATCH_KINDS = ("prefill", "decode", "verify")

# tick-phase segment names (TickTimeline)
TIMELINE_PHASES = ("admit", "prefill_dispatch", "decode_dispatch",
                   "readback", "commit_behind", "drain")


# --------------------------------------------------- platform peak-FLOPs table

def _cpu_peak_estimate() -> float:
    """Order-of-magnitude peak for the CPU fallback: cores x ~3GHz x 16
    f32 FLOPs/cycle (one 256-bit FMA pipe).  Deliberately coarse — a CPU
    MFU row exists so the accounting path is exercised end to end, not as
    a benchmark claim; the README says so."""
    return max(1, os.cpu_count() or 1) * 3.0e9 * 16


# dense bf16 tensor-core peak per card, by CUDA device-kind substring
# (NVIDIA's H100 data sheet; the training MFU rows divide by the same SXM
# figure).  The first match wins, so the PCIe entry precedes the generic one.
CUDA_PEAKS = (("H100 PCIe", "cuda-h100-pcie", 756e12),
              ("H100", "cuda-h100-sxm", 989.4e12))


def platform_peak_flops(backend: str, device_kind: str = "",
                        n_devices: int = 1) -> tuple:
    """-> (platform_label, peak_flops) for MFU math.

    CUDA backends resolve ``device_kind`` (``torch.cuda.get_device_name``)
    through ``CUDA_PEAKS``: "NVIDIA H100 80GB HBM3" (SXM) -> 989.4e12,
    "NVIDIA H100 PCIe" -> 756e12.  An unknown kind takes the SXM figure
    rather than refusing to serve, and its label says so
    (``cuda-h100-sxm?``).  A multi-card engine passes its degree as
    ``n_devices``: the peak multiplies per card and the label gains an
    ``xN`` suffix.  The CPU fallback keeps the HOST-wide estimate
    un-multiplied but still annotates the degree.  ``ENGINE_PEAK_FLOPS``
    overrides the value (label gains a ``!`` so a doctored denominator is
    visible in every snapshot)."""
    env = os.environ.get("ENGINE_PEAK_FLOPS")
    if backend == "cuda":
        label, peak = CUDA_PEAKS[-1][1] + "?", CUDA_PEAKS[-1][2]
        for needle, name, flops in CUDA_PEAKS:
            if needle in (device_kind or ""):
                label, peak = name, flops
                break
        peak *= max(1, n_devices)
    else:
        label = backend or "cpu"
        peak = _cpu_peak_estimate()
    if n_devices > 1:
        label += f"x{n_devices}"
    if env:
        try:
            peak = float(env)
            label += "!"
        except ValueError:
            pass
    return label, peak


# ------------------------------------------------------------------ FLOPs model

class FlopsModel:
    """Analytical per-dispatch FLOPs from the decoder config.

    All methods return FLOPs for ONE batch row; the engine sums rows per
    dispatch (mask-aware: a padded [B, bucket] prefill charges each row
    at its real prompt length — padding lanes are machine work but not
    work the request asked for, and charging them would let bucket
    geometry inflate goodput)."""

    def __init__(self, config, lora=None):
        self.lin = config.matmul_flops_per_token()
        # attention flops per token = slope * context
        self.attn_slope = config.attn_flops_per_token(1)
        # LoRA delta matmuls (lora.py fused path): per adapted projection
        # per layer per token, x@A (2*d_in*r) + (xA)@B (2*r*d_out).  The
        # fused decode computes the delta for EVERY row when a table is
        # loaded (row 0 is the zero adapter), so the per-token constant
        # applies to all rows of an adapter-enabled engine.
        extra = 0
        if lora:
            for proj in lora.values():
                A, B = proj["A"], proj["B"]
                n_layers, d_in, r = A.shape[1], A.shape[2], A.shape[3]
                d_out = B.shape[3]
                extra += n_layers * 2 * r * (d_in + d_out)
        self.lora = extra
        self.per_token = self.lin + self.lora

    def prefill_row(self, tokens: int, history: int = 0) -> float:
        """One row advancing ``tokens`` prompt positions that attend over
        ``history`` prior positions (chunked prefill passes the chunk
        offset); causal attention inside the new span."""
        if tokens <= 0:
            return 0.0
        # sum_{p=history+1..history+tokens} attn(p)
        attn = self.attn_slope * (tokens * history
                                  + tokens * (tokens + 1) // 2)
        return tokens * self.per_token + attn

    def decode_row(self, context: int) -> float:
        """One decode position attending over ``context`` positions."""
        return self.per_token + self.attn_slope * max(0, context)

    def verify_row(self, context: int, k: int) -> float:
        """One fused-verify row: ``k`` positions (committed token + k-1
        drafts) each attending ~``context`` (the per-position growth
        inside one pass is noise)."""
        return k * self.decode_row(context)


# --------------------------------------------------------------- goodput ledger

class PerfLedger:
    """FLOPs ledger with exact waste attribution.

    ``charge(kind, flops, positions, reason)`` is the only mutation:
    reason None -> goodput, else the named waste bucket — so
    ``dispatched == goodput + sum(waste)`` is an identity, never a
    reconciliation.  A bounded rolling window of charges derives MFU and
    goodput ratios at read time (scrape-time math, O(window))."""

    def __init__(self, peak_flops: float, platform: str,
                 window_s: float = 60.0, on_charge=None):
        self.peak_flops = max(1.0, float(peak_flops))
        self.platform = platform
        self.window_s = float(window_s)
        self._on_charge = on_charge  # telemetry hook (counter exposition)
        self._lock = threading.Lock()
        self.flops_by_kind = {k: 0.0 for k in DISPATCH_KINDS}
        self.positions_by_kind = {k: 0 for k in DISPATCH_KINDS}
        self.goodput_flops = 0.0
        self.goodput_positions = 0
        self.waste_flops = {}
        self.waste_positions = {}
        # (t, flops, goodput_flops) — bounded by count as well as age so a
        # charge storm cannot grow the deque faster than reads trim it
        self._window: collections.deque = collections.deque(maxlen=4096)

    def charge(self, kind: str, flops: float, positions: int = 0,  # graftlint: hot-path
               reason: Optional[str] = None) -> None:
        if flops <= 0:
            return
        with self._lock:
            self.flops_by_kind[kind] = self.flops_by_kind.get(kind, 0.0) + flops
            self.positions_by_kind[kind] = (
                self.positions_by_kind.get(kind, 0) + positions)
            if reason is None:
                self.goodput_flops += flops
                self.goodput_positions += positions
                good = flops
            else:
                self.waste_flops[reason] = (
                    self.waste_flops.get(reason, 0.0) + flops)
                self.waste_positions[reason] = (
                    self.waste_positions.get(reason, 0) + positions)
                good = 0.0
            self._window.append((time.perf_counter(), flops, good))
        if self._on_charge is not None:
            self._on_charge(kind, flops, reason)

    def _window_sums(self, now: float) -> tuple:
        """(dispatched, goodput, span_s) over the rolling window; caller
        holds the lock."""
        horizon = now - self.window_s
        w = self._window
        while w and w[0][0] < horizon:
            w.popleft()
        if not w:
            return 0.0, 0.0, 0.0
        disp = sum(f for _, f, _ in w)
        good = sum(g for _, _, g in w)
        span = max(now - w[0][0], 1e-9)
        return disp, good, span

    def mfu(self) -> float:
        """Windowed model FLOPs utilization vs the platform peak."""
        with self._lock:
            disp, _, span = self._window_sums(time.perf_counter())
        if span <= 0:
            return 0.0
        return disp / span / self.peak_flops

    def goodput_ratio(self) -> float:
        """Windowed goodput / dispatched (1.0 when nothing dispatched —
        an idle engine wastes nothing)."""
        with self._lock:
            disp, good, _ = self._window_sums(time.perf_counter())
        return good / disp if disp > 0 else 1.0

    def snapshot(self) -> dict:
        with self._lock:
            dispatched = sum(self.flops_by_kind.values())
            waste = dict(self.waste_flops)
            out = {
                "platform": self.platform,
                "peak_flops": self.peak_flops,
                "window_s": self.window_s,
                "dispatched_flops": dispatched,
                "flops_by_kind": dict(self.flops_by_kind),
                "positions_by_kind": dict(self.positions_by_kind),
                "goodput_flops": self.goodput_flops,
                "goodput_positions": self.goodput_positions,
                "waste_flops": waste,
                "waste_positions": dict(self.waste_positions),
                # identity by construction; exported so every consumer
                # (tests, benches, dashboards) can assert it for free
                "accounted_flops": self.goodput_flops + sum(waste.values()),
            }
        out["mfu"] = round(self.mfu(), 6)
        out["goodput_ratio"] = round(self.goodput_ratio(), 6)
        return out


# ----------------------------------------------------------------tick timeline

class TickTimeline:
    """Bounded ring of per-tick phase segments.

    ``note(tick, phase, dur_s)`` is called from the engine loop only
    (same single-writer discipline as the host mirrors); ``snapshot``
    copies under the lock.  A tick's record accumulates segment time by
    phase — repeated segments (several prefill groups in one tick) sum."""

    def __init__(self, capacity: int = 256):
        self._ring: collections.deque = collections.deque(
            maxlen=max(1, capacity))
        self._lock = threading.Lock()
        self._cur_tick = -1
        self._cur: Optional[dict] = None

    def note(self, tick: int, phase: str, dur_s: float) -> None:
        with self._lock:
            if tick != self._cur_tick or self._cur is None:
                self._cur = {"tick": tick, "t_s": round(time.perf_counter(), 6),
                             "segments": {}}
                self._cur_tick = tick
                self._ring.append(self._cur)
            seg = self._cur["segments"]
            seg[phase] = round(seg.get(phase, 0.0) + dur_s, 9)

    def snapshot(self, last: int = 32) -> list:
        with self._lock:
            items = list(self._ring)[-max(0, last):]
            return [{"tick": r["tick"], "t_s": r["t_s"],
                     "segments": dict(r["segments"])} for r in items]

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)


# --------------------------------------------------------------- cache analytics

class CacheStats:
    """Prefix-cache lookup outcomes + bounded per-prefix reuse counts.

    Fed at admission (the one point where requested-vs-granted cache
    pages are both known): ``hit`` pages counted per lookup, misses
    attributed ``cold`` (no page matched) or ``partial`` (the chain
    diverged / aged out mid-prefix).  Reuse counts key on the deepest
    matched chain hash — chain hashing makes that a unique identity for
    the whole reused prefix (a popular system prompt shows up as one hot
    key), bounded LRU so a high-cardinality workload cannot grow it.
    Each entry also keeps the prefix's PAGE COUNT (the deepest hit depth
    seen under that key): the fleet KV fabric's placement scorer weighs
    bytes saved per reuse, not just hit counts — two prefixes with equal
    reuse but 2 vs 20 pages are very different placement prizes."""

    _REUSE_CAP = 512

    def __init__(self):
        self._lock = threading.Lock()
        self.lookups = 0
        self.hit_pages = 0
        self.miss_pages = {"cold": 0, "partial": 0}
        # key -> [reuses, pages]; insertion order is the LRU order
        self._reuse: "collections.OrderedDict[str, list]" = \
            collections.OrderedDict()

    def note_lookup(self, requested: int, hit: int,
                    key: Optional[int]) -> None:
        if requested <= 0:
            return
        hit = max(0, min(hit, requested))
        with self._lock:
            self.lookups += 1
            self.hit_pages += hit
            if hit < requested:
                reason = "partial" if hit > 0 else "cold"
                self.miss_pages[reason] += requested - hit
            if hit > 0 and key is not None:
                k = f"{int(key):016x}"
                rec = self._reuse.pop(k, None) or [0, 0]
                rec[0] += 1
                rec[1] = max(rec[1], hit)
                self._reuse[k] = rec
                while len(self._reuse) > self._REUSE_CAP:
                    self._reuse.popitem(last=False)

    def snapshot(self, top: int = 16) -> dict:
        with self._lock:
            hot = sorted(self._reuse.items(), key=lambda kv: -kv[1][0])[:top]
            return {
                "lookups": self.lookups,
                "hit_pages": self.hit_pages,
                "miss_pages": dict(self.miss_pages),
                "tracked_prefixes": len(self._reuse),
                "top_reused_prefixes": [
                    {"prefix": k, "reuses": v[0], "pages": v[1]}
                    for k, v in hot],
            }


# ------------------------------------------------------- profiler artifact store

def _dir_nbytes(path: str) -> int:
    total = 0
    for root, _, files in os.walk(path):
        for f in files:
            try:
                total += os.path.getsize(os.path.join(root, f))
            except OSError:
                pass
    return total


class ProfileStore:
    """Managed torch.profiler capture dirs: capped in count AND bytes with
    oldest-first eviction, removed on ``Engine.stop()``, so a profiling
    soak (or a restart loop that re-profiles on every incident) cannot
    grow artifact dirs without bound across engine lifecycles.  Mirrors the FlightRecorder dump cap: the
    store only deletes dirs IT created (``new_dir``); explicit
    caller-owned dirs are recorded in the run history (entry-capped) but
    never deleted out from under their owner."""

    def __init__(self, parent: Optional[str] = None, max_runs: int = 8,
                 max_bytes: int = 256 << 20):
        import secrets
        import tempfile

        self.parent = (parent or os.environ.get("ENGINE_PROFILE_DIR")
                       or os.path.join(tempfile.gettempdir(),
                                       f"engine_profiles-{os.getpid()}"))
        self.max_runs = max(1, max_runs)
        self.max_bytes = max(1, max_bytes)
        self._lock = threading.Lock()
        self._seq = 0
        # per-STORE token in every capture dir name: several engines in
        # one process share the per-pid parent, and a bare pid+seq name
        # would collide — one engine's eviction/stop would then rmtree a
        # directory another engine is still capturing into
        self._token = secrets.token_hex(4)
        # run records, oldest first: {dir, managed, ticks, requested_at,
        # nbytes (filled at completion), state}
        self.runs: list = []

    def new_dir(self) -> str:
        with self._lock:
            self._seq += 1
            d = os.path.join(
                self.parent,
                f"capture-{os.getpid()}-{self._token}-{self._seq:03d}")
        os.makedirs(d, exist_ok=True)
        return d

    def begin(self, trace_dir: str, ticks: int, managed: bool) -> dict:
        rec = {"dir": trace_dir, "managed": managed, "ticks": ticks,
               "requested_at": time.time(), "nbytes": 0,
               "state": "capturing"}
        with self._lock:
            self.runs.append(rec)
        return rec

    def discard(self, rec: dict) -> None:
        """Un-register a run whose capture never armed (the profiler
        refused it): the record leaves the history and a managed dir is
        removed — no orphan 'capturing' entries."""
        with self._lock:
            if rec in self.runs:
                self.runs.remove(rec)
        if rec["managed"]:
            shutil.rmtree(rec["dir"], ignore_errors=True)

    def complete(self, rec: dict, error: Optional[str] = None) -> None:
        """Capture finished (engine loop thread): size the artifacts and
        evict past the count/byte caps, oldest managed run first."""
        rec["nbytes"] = _dir_nbytes(rec["dir"])
        rec["state"] = "error" if error else "complete"
        if error:
            rec["error"] = error
        with self._lock:
            self._evict_locked()

    def _evict_locked(self) -> None:
        def total() -> int:
            return sum(r["nbytes"] for r in self.runs)

        while self.runs and (len(self.runs) > self.max_runs
                             or total() > self.max_bytes):
            # oldest first; never evict a capture still in flight
            victim = next((r for r in self.runs
                           if r["state"] != "capturing"), None)
            if victim is None:
                break
            self.runs.remove(victim)
            if victim["managed"]:
                shutil.rmtree(victim["dir"], ignore_errors=True)

    def close(self) -> None:
        """Engine.stop(): managed capture dirs die with the engine —
        profiles are scratch diagnostics, and nothing would ever reap
        them once the process moves on (explicit caller dirs survive)."""
        with self._lock:
            for r in self.runs:
                if r["managed"]:
                    shutil.rmtree(r["dir"], ignore_errors=True)
            self.runs.clear()
        try:
            # several engines in one process share the parent: remove it
            # only once the LAST one's captures are gone
            os.rmdir(self.parent)
        except OSError:
            pass

    def snapshot(self) -> list:
        with self._lock:
            return [dict(r) for r in self.runs]
