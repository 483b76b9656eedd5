"""The inference engine: C++ batcher + PyTorch paged prefill/decode loop.

Counterpart of ``kubeflow_tpu/serving/engine/engine.py`` at the JAX
engine's defaults: the pipelined decode loop, the prefix cache and the QoS
scheduler, with prompt-lookup speculative decoding, sessions and an int8
KV pool on request.  Slot lifecycle and KV page accounting live in the C++
core (core.cc via native.py); this module runs the loop on the device:

    loop:
      reap deadline-expired queued requests (DeadlineExceeded)
      relieve pool pressure below SchedulerConfig.min_free_pages by
        preempting a lower-class decode slot
      admit from the host QosScheduler in policy order (class, then EDF,
        then fair share; or FIFO), submit-then-admit one request at a time
        through the core (which decides whether the prompt's pages fit,
        all-or-nothing, and adopts the longest cached chain of full prompt
        pages); when the head is blocked, preempt a strictly lower-class
        decode slot by swap (its KV pages to the tiered store) or
        recompute (its pages to the prefix cache); an admitted request
        resumes from its swap blob, restores its session's pinned pages,
        or prefills past the cached prefix
      group prefilling slots (short prompts by bucket, long or cache-resumed
        ones by chunk offset) -> ONE prefill per group -> one KV-page
        scatter -> one batched first-token sample per group
      one decode step over ALL slots (pipelined or sync, plain or
        speculative), the NaN guard, the commits (C++ grows pages; reports
        finish/OOM), finish and release pages into the prefix cache

``pipeline_depth=1`` (the default) makes the steady-state decode loop a
one-deep pipeline.  Sampling and the guard run inside the decode call
(``model.decode_step_sample``), whose [B] int32 output feeds the next
dispatch on the device; seq_lens ride a host shadow advanced by
arithmetic.  Each tick uploads its lengths and page table from pinned host
buffers without blocking, starts a non-blocking copy of its tokens into a
pinned buffer, records an event, and commits the PREVIOUS tick's tokens to
the batcher while this one runs (commit-behind): the event wait there is
the only place the loop waits on the device.  Page accounting lags one
tick, covered by a lookahead ``reserve_page`` before each dispatch.  Any
roster change (admit, finish, NaN row) drains the pipeline to a fence
before the host mirrors are read again.  ``pipeline_depth=0`` keeps the
synchronous loop, the parity oracle: greedy outputs are byte-identical
between the two on the CPU.

``speculative="prompt_lookup"`` drafts the continuation of the last
n-gram's earlier occurrence in the context and verifies up to
``spec_max_draft`` drafts in one K-row pass (``model.decode_step_k``,
sync; ``model.decode_step_verify_sample`` with accept/reject on the
device, pipelined), committing 1..K tokens per slot per tick.  Greedy only:
accepted tokens are what token-by-token argmax would have produced.

With ``paged_kernel=True`` (the default here) decode and verify attention
run through ``paged_attention``: the hand-written Hopper kernel on a CUDA
pool (K = 1 plain, K = ``spec_max_draft`` + 1 verify; bf16 or, with
``kv_quant="int8"``, the int8 pool), its plain version on a CPU pool.
``paged_kernel=False`` keeps the gather path that the JAX engine runs by
default.

Sessions: a request with a ``session_id`` pins its finished turn's
complete KV pages in the tiered store (kvstore.py: host RAM, written
through to checksummed page files), and the session's next turn scatters
them back into its fresh page row instead of re-prefilling.  The pools are
written in place, so every snapshot (device -> host) and scatter (host ->
device) runs on the loop thread at admission, preemption or finish, after
the pipeline fence where one is due; stream order keeps a scatter behind
any dispatched tick.

Streaming: ``generate_stream`` yields each token as the loop commits it.
Every committed token passes through the one funnel ``_commit``, which
pushes it onto the request's stream queue; every terminal path (finish,
cancel, failure, shed) resolves the future and pushes the final result or
the typed exception through ``_resolve``.  Tokens a preemption's recompute
re-prefills, rows the pipelined commit-behind drops and speculative tokens
staged but never committed never reach a stream, and a swapped-out request
continues its stream where it stopped.

Observability and supervision, as the JAX engine has them: a lifecycle
``RequestSpan`` per request (``trace``, ``trace_by_id``, ``waterfall``,
``latency_budget``), the TTFT/TPOT/queue-wait/tick histograms of
``EngineTelemetry``, the perf plane (FLOPs charged per row with waste
attributed, the per-tick phase timeline, cache analytics, on-demand
``torch.profiler`` captures: ``perf_snapshot``, ``trace_n_ticks``), the
flight recorder, seeded dispatch chaos (``EngineConfig.chaos``), the
incident plane (``incidents=True``) and the watchdog: a loop that dies or
hangs past ``hang_timeout_s`` has its requests failed with TickFailure and
is restarted behind an epoch fence, so a superseded thread that wakes up
exits (``_StaleThread``) before it mutates anything.  A thread blocked
inside a CUDA call cannot be killed; it stays blocked until the call
returns, as a thread blocked in a device call does in the JAX package.

Disaggregation and the fleet KV fabric, as the JAX engine has them: a
``handoff`` request (the prefill phase) exports its committed KV pages at
finish as one KVPG frame into a one-shot, TTL'd ``HandoffStore``
(``pull_handoff``); a ``kv_import`` (the decode phase) parks the pulled
frame in the tiered store and is admitted through the swap-resume scatter,
straight to decode with no prefill of its own.  With ``fabric=True`` every
finishing request publishes its committed full-page prefix into a
multi-reader ``FabricStore`` (``pull_fabric``, ``fabric_view``), and a
``fabric_import`` is matched by chain hash at admission and scattered past
what the prefix cache and any session restore cover.  Every failure
degrades to a re-prefill, attributed ``handoff_degraded`` or
``fabric_degraded``.  The frames are the JAX package's bytes, so either
package imports the other's.

Structured output, brownout, int8 weights and multi-LoRA, as the JAX
engine has them: a ``constrain`` request (a ``serving.constrain``
automaton) gates every token it samples through a ``[max_slots, V]``
grammar mask built on the host after the "constrain" pipeline fence (a
mask is valid only against the automaton state after the last committed
token) and applied inside the fused step at the finite -1e30; its
automaton advances once per committed token in ``_commit``, rides a
preemption as a snapshot, truncates prompt-lookup drafts at the first
illegal token, and a zero-legal mask fails only its slot with
ConstraintStall.  A request's ingress ``brownout`` stage >= 2 drops its
drafts and >= 3 defers its fabric publish.  ``weight_quant="int8"``
quantizes the weights at construction on their device; ``lora`` (from
lora.load_adapters) gives every slot its adapter id, which rides every
prefill and decode call and seeds the prefix-cache chain hashes.

Tensor parallelism, as the JAX engine has it: ``tensor_parallel = N``
splits the params and the KV pool over a 1-D mesh of N shards
(sharding.py; the Megatron split, the pools on the KV-head axis), N
shards possibly on one card.  One loop drives every shard; each decode or
verify step launches the paged kernel once per shard and layer, and the
row-parallel partials meet in ``sharding.all_reduce_sum``.  Every KV
movement (swap, session pin and restore, handoff, fabric) snapshots and
scatters shard by shard, its frames are sharded (version 2) KVPG frames
with a CRC per shard, and a blob of another degree is resharded on the
host, counted under ``engine_kv_reshard_total``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import queue
import threading
import time
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FutureTimeoutError
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from ...utils.device import resolve_device
from .. import waterfall as waterfall_mod
from ..errors import (DeadlineExceeded, EngineOverloaded, EngineShutdown,
                      NonFiniteLogits, RequestError, SessionBusy,
                      TickFailure)
from ..incidents import IncidentConfig, IncidentManager, engine_detectors
from ..slo import SloConfig, SloTracker
from ..disagg import HandoffStore, normalize_role
from ..kvfabric import FabricStore, fabric_key
from ..constrain import ConstraintStall
from .faults import (ChaosInjector, ConstrainChaos, ConstrainFaultConfig,
                     FabricChaos, FabricFaultConfig, FaultConfig, HandoffChaos,
                     HandoffFaultConfig)
from .kvstore import (KVStoreConfig, TieredKVStore, blob_degree,
                      normalize_session_id, pack_frame, pack_sharded_frame,
                      reshard_blob)
from .perf import (CacheStats, FlopsModel, PerfLedger, ProfileStore,
                   TickTimeline, WASTE_REASONS, platform_peak_flops)
from .model import (DecoderConfig, decode_step, decode_step_k,
                    decode_step_sample, decode_step_sample_packed,
                    decode_step_verify_sample, make_kv_pool, param_leaves,
                    prefill, prefill_chunk, quantize_weights_int8,
                    sample_tokens, write_pages)
from .native import NativeBatcher
from .sharding import (alloc_pool, leaf_to_host, leaf_to_tensor, scatter_shards,
                       shard_lora, shard_params, snapshot_shards, tensor_mesh,
                       validate_config)
from .scheduler import (PRIORITY_RANK, QosScheduler, QueueEntry,
                        SchedulerConfig, normalize_priority)
from .telemetry import (EngineTelemetry, FlightRecorder, RequestSpan,
                        TickProfiler)

PREFILL_BUCKETS = (32, 64, 128, 256, 512, 1024)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    max_slots: int = 8
    num_pages: int = 512
    page_size: int = 32
    max_pages_per_slot: int = 64
    eos_id: int = -1           # -1: never stop early
    # additional stop ids (multi-EOS checkouts stop on ANY of eos_id +
    # eos_ids); a tuple so the frozen config stays hashable
    eos_ids: Tuple[int, ...] = ()
    temperature: float = 0.0   # 0 = greedy
    seed: int = 0
    # prompts longer than this are prefilled in page-aligned chunks of this
    # size, one chunk per engine tick, so decode steps for active slots
    # interleave with a long prefill instead of stalling behind it
    prefill_chunk: int = 256
    # decode attention through paged_attention (the Hopper kernel on a
    # CUDA pool); False = the gather path, the JAX engine's default
    paged_kernel: bool = True
    # verify per-row logit finiteness before committing sampled tokens (a
    # NaN row fails only its own slot with NonFiniteLogits)
    logit_guard: bool = True
    # decode-loop pipelining: 1 (default) overlaps host orchestration with
    # the device step (sampling inside the decode call, async token
    # readback, commit-behind with lookahead page reservation); 0 is the
    # synchronous loop, the greedy-parity oracle.  Composes with
    # ``speculative``.
    pipeline_depth: int = 1
    # speculative decoding: "prompt_lookup" drafts from the context's
    # earlier n-gram occurrences and verifies up to spec_max_draft tokens in
    # one pass (lossless under greedy); requires temperature 0
    speculative: Optional[str] = None
    spec_max_draft: int = 4
    spec_ngram: int = 2
    # KV-cache quantization: "int8" stores pool entries as int8 + per-token
    # bf16 scales (the paged kernel dequantizes in registers); None = bf16
    kv_quant: Optional[str] = None
    # weight-only quantization: "int8" halves the weights' bytes on the
    # card (per-output-channel scales; each use dequantizes); None = bf16
    weight_quant: Optional[str] = None
    # tensor-parallel degree (sharding.py): >1 splits the params and the KV
    # pool over a 1-D ``tensor`` mesh of that many shards (the Megatron
    # split), each shard's attention through its own kernel launch
    tensor_parallel: int = 1
    # admission control: submissions past this many queued-unadmitted
    # requests fail fast with EngineOverloaded (0 = unbounded)
    max_queue_depth: int = 0
    # deadline for requests that pass none (seconds from submit; None =
    # none).  Expired requests are shed before their first token with
    # DeadlineExceeded.
    default_deadline_s: Optional[float] = None
    # per-tick admission policy + preemption knobs (scheduler.py).  None =
    # SchedulerConfig(): priority classes / EDF / fair share, preemption on
    scheduler: Optional[SchedulerConfig] = None
    # host-RAM + disk tier budgets and placement for preemption swap and
    # pinned session KV (kvstore.py).  None = KVStoreConfig with the
    # scheduler's swap_max_bytes as the host budget and a private temporary
    # disk dir, deleted at stop()
    kv_store: Optional[KVStoreConfig] = None
    # ---- disaggregated serving (disagg.py) ------------------------------
    # the replica's declared role: "prefill" | "decode" | "unified".
    # Advisory at engine level (any engine can export or import handoffs);
    # the service proxy reads the matching pod annotation for placement
    role: str = "unified"
    # exported-KV handle lifetime + byte budget (disagg.HandoffStore): an
    # orphaned export expires instead of pinning pool-sized blobs in host
    # RAM; budget overruns evict oldest-first and that export degrades
    handoff_ttl_s: float = 60.0
    handoff_max_bytes: int = 256 << 20
    # deterministic handoff-fault injection (faults.HandoffFaultConfig):
    # torn/slow/dead-link pulls, pre-expired exports
    handoff_chaos: Optional[HandoffFaultConfig] = None
    # ---- fleet KV fabric (kvfabric.py) ----------------------------------
    # when on, every finishing request's committed full-page prefix is
    # published (keyed by its context chain hashes) into a fleet-
    # addressable FabricStore other replicas pull from.  Off by default:
    # publishing snapshots device pages to host per finish.
    # fabric_min_pages gates tiny prefixes out; fabric_max_bytes is also
    # the budget of pulled frames parked on queued requests
    fabric: bool = False
    fabric_ttl_s: float = 120.0
    fabric_max_bytes: int = 256 << 20
    fabric_min_pages: int = 1
    # deterministic fabric-fault injection (faults.FabricFaultConfig):
    # torn/flipped/slow/dead-link pulls, pre-expired publishes
    fabric_chaos: Optional[FabricFaultConfig] = None
    # ---- structured output (serving/constrain.py) -----------------------
    # deterministic constrained-decoding fault injection
    # (faults.ConstrainFaultConfig): corrupted token-map cache reads must
    # degrade to a counted re-compile; forced zero-legal-token masks must
    # fail ONLY the stalled slot and feed the constraint_stall detector
    constrain_chaos: Optional[ConstrainFaultConfig] = None
    # ---- fault tolerance ------------------------------------------------
    # a request whose tick phase (prefill group / decode step) raises is
    # retried in place; after this many CONSECUTIVE failures it is failed
    # with TickFailure (a successful commit resets the count)
    max_consecutive_failures: int = 3
    # watchdog supervisor: checks the loop thread every interval; a loop
    # that died (escaped exception) has its in-flight futures failed and —
    # when watchdog_restart — is restarted with a fresh decode state.  A
    # loop stuck inside one tick longer than hang_timeout_s is DEGRADED,
    # then epoch-fenced and restarted the same way.  hang_timeout_s must
    # dwarf the slowest legitimate tick (a first call that builds a kernel)
    watchdog_interval_s: float = 0.5
    hang_timeout_s: float = 300.0
    watchdog_restart: bool = True
    # stop(): how long the graceful drain waits for in-flight slots to
    # finish before failing them with EngineShutdown
    drain_timeout_s: float = 10.0
    # ---- observability --------------------------------------------------
    # master switch for lifecycle spans, latency histograms and the flight
    # recorder.  Off = the loop pays one boolean check per hook
    telemetry: bool = True
    # flight recorder: ring capacity and where JSONL dumps land (None:
    # ENGINE_FLIGHT_DIR env, else <tmpdir>/engine_flightrec)
    flight_recorder_capacity: int = 256
    flight_dir: Optional[str] = None
    # completed request spans kept for trace(rid), budgeted in entries and
    # approximate bytes (evictions count in engine_trace_evictions_total)
    trace_history: int = 512
    trace_history_bytes: int = 1_000_000
    # per-class SLO targets/windows (serving/slo.py; engine.json "slo"
    # block).  None = SloConfig() defaults; tracked whenever telemetry is on
    slo: Optional[SloConfig] = None
    # ---- performance introspection (perf.py) -----------------------------
    # FLOPs/MFU accounting, goodput attribution, tick-phase timeline and
    # cache analytics.  None = follows ``telemetry``
    perf: Optional[bool] = None
    # rolling window the MFU / goodput gauges derive over
    perf_window_s: float = 60.0
    # per-tick phase-timeline ring capacity
    perf_timeline_capacity: int = 256
    # managed torch.profiler artifact store (POST /engine/profile): capture
    # dirs live under profile_dir (None: ENGINE_PROFILE_DIR env, else a
    # per-pid tempdir), capped in count AND bytes, removed on stop()
    profile_dir: Optional[str] = None
    profile_max_runs: int = 8
    profile_max_bytes: int = 256 << 20
    # deterministic dispatch chaos (faults.FaultConfig)
    chaos: Optional[FaultConfig] = None
    # ---- incident plane (serving/incidents.py) ---------------------------
    # background fault detection + evidence correlation, served as GET
    # /engine/incidents.  Off by default: the manager runs a polling thread
    incidents: bool = False
    # where postmortem bundles land (None: <tmpdir>/engine_incidents)
    incident_dir: Optional[str] = None
    # symptoms within this window of an open incident's LAST symptom
    # coalesce into its causal chain
    incident_debounce_s: float = 5.0
    # this much symptom-free quiet resolves an open incident
    incident_resolve_s: float = 15.0
    # incident-manager processing/polling cadence
    incident_poll_s: float = 0.25
    # a WORK tick slower than this feeds a tick_overrun signal (0 = off)
    incident_tick_overrun_s: float = 0.0


@dataclasses.dataclass
class _Pending:
    tokens: list          # prompt token ids
    max_new_tokens: int
    future: Future
    generated: list = dataclasses.field(default_factory=list)
    submitted_at: float = 0.0
    first_token_at: float = 0.0
    # consecutive tick failures while this request was in the offending
    # group; reset on every successful commit or prefill chunk
    failures: int = 0
    # prefix-cache chain hashes of the prompt's full pages
    page_hashes: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0,), np.uint64))
    # prompt + committed (and, pipelined speculative, staged) tokens: what
    # prompt-lookup drafts from; its n-gram index grows incrementally
    context: list = dataclasses.field(default_factory=list)
    ngram_index: dict = dataclasses.field(default_factory=dict)
    ngram_p: int = 0
    # own request id (set at submit; the session-busy release key)
    rid: int = -1
    # absolute perf_counter deadline (None = none); an expired request is
    # shed with DeadlineExceeded before its first token
    deadline: Optional[float] = None
    # priority class + its admission rank (interactive=0 < batch <
    # best_effort); preemption only evicts strictly larger ranks
    priority: str = "interactive"
    rank: int = 0
    # set by Engine.cancel(); the loop finishes the request at its next tick
    cancelled: bool = False
    # times this request was preempted out of its decode slot
    preemptions: int = 0
    # swap-preempted: KV pages live in the tiered store under this rid;
    # resume_len is the committed context length to restore
    swapped: bool = False
    resume_len: int = 0
    # conversation pin: the finished turn's KV pages park in the tiered
    # store under this id, and the next turn restores them
    session_id: Optional[str] = None
    # how this turn's prefix was recovered — None until the first
    # admission, then host|disk|cache|cold|degraded (degraded = the store
    # had the session but verification failed; fell back to re-prefill)
    session_restore: Optional[str] = None
    # disaggregated prefill phase: export this request's committed KV pages
    # into the handoff store at finish (the decode replica pulls them)
    handoff: bool = False
    # disaggregated decode phase: the prompt's KV arrived as a verified
    # handoff frame (parked in the tiered store under this rid, scattered
    # at admission via the swap-resume path); any import failure degrades
    # to a plain re-prefill instead of failing the slot
    handoff_import: bool = False
    # a verified remote prefix frame awaiting admission: (blob, frame chain
    # hashes, nbytes), held on the record (freed with it) and scattered
    # past the locally covered pages at admission
    fabric_import: Optional[tuple] = None
    # how the fabric import resolved: None (no import), then
    # hit|local|degraded — the result dict's "fabric" block
    fabric_restore: Optional[str] = None
    # streaming: every committed token is also pushed here, then a final
    # (None, result) or (None, exception) sentinel (generate_stream reads it)
    stream: Optional[queue.Queue] = None
    # lifecycle span (telemetry.RequestSpan; None when telemetry is off)
    span: Optional[RequestSpan] = None
    # perf_counter of the most recent committed token (TPOT numerator)
    last_token_at: float = 0.0
    # when set, this request's NEXT prefill recomputes work already done
    # (preempt_recompute / failover_reprefill): the perf ledger charges
    # those prefill FLOPs as waste under this reason instead of goodput
    waste_reason: Optional[str] = None
    # LoRA adapter id (0 = base model), resolved from the name at submit
    adapter_id: int = 0
    # ingress brownout stage this request was admitted under: >= 2 drops
    # its speculation drafts, >= 3 also defers its fabric publish
    brownout: int = 0
    # grammar constraint (serving.constrain.GrammarConstraint) gating every
    # token this request samples; None = unconstrained.  It advances once
    # per committed token (in _commit); a preemption snapshots it
    constrain: Optional[object] = None
    # the automaton snapshot taken at preemption, restored and cleared at
    # re-admission
    constrain_snap: Optional[dict] = None


def _page_hashes(tokens: list, page_size: int, adapter_id: int = 0) -> np.ndarray:
    """Chain hashes for each FULL prompt page, byte for byte the JAX
    engine's ``Engine._page_hashes``: hash(page i) is the 8-byte blake2b of
    hash(page i-1) + the page's int32 tokens, so a match means an identical
    token prefix at identical positions; 0 is reserved as the no-parent
    sentinel.  A nonzero LoRA ``adapter_id`` seeds the chain (its 4
    little-endian bytes): an adapter changes the KV a prompt produces, so
    identical prompts under different adapters never share a page."""
    n = len(tokens) // page_size
    out = np.zeros((n,), np.uint64)
    prev = adapter_id.to_bytes(4, "little") if adapter_id else b""
    for i in range(n):
        page = np.asarray(tokens[i * page_size:(i + 1) * page_size], np.int32).tobytes()
        digest = hashlib.blake2b(prev + page, digest_size=8).digest()
        out[i] = max(1, int.from_bytes(digest, "little"))
        prev = digest
    return out


def _pool_map(fn, pool, *blobs):
    """``fn`` over a pool's leaves (one tensor, or the int8 pool's
    ``{"q", "s"}``) and the matching leaves of ``blobs``."""
    if isinstance(pool, dict):
        return {k: fn(pool[k], *(b[k] for b in blobs)) for k in sorted(pool)}
    return fn(pool, *blobs)


def _blob_leaves(blob) -> list:
    """The numpy leaves of a KV blob: a ``(k, v)`` tuple (each part an array
    or the int8 pool's ``{"q", "s"}`` dict), or a per-shard list of them."""
    if isinstance(blob, np.ndarray):
        return [blob]
    if isinstance(blob, dict):
        return [a for k in sorted(blob) for a in _blob_leaves(blob[k])]
    return [a for part in blob for a in _blob_leaves(part)]


class _Staging:
    """Host side of one pipelined dispatch: pinned buffers that its uploads
    copy from and its token readback copies into, and an event recorded
    after the last copy it enqueued.  Two sets alternate, so a set is
    written again only after the commit-behind has waited on its event: the
    wait in ``wait`` at reuse is then already satisfied.  On the CPU,
    copies are synchronous and no buffer is kept."""

    def __init__(self, device: torch.device, shapes: dict):
        self.device = device
        self.cuda = device.type == "cuda"
        self.buf = ({name: torch.zeros(shape, dtype=torch.int32, pin_memory=True)
                     for name, shape in shapes.items()} if self.cuda else {})
        self.event = torch.cuda.Event() if self.cuda else None
        self.armed = False

    def wait(self) -> None:
        """Block until every copy this set enqueued has run."""
        if self.armed:
            self.event.synchronize()
            self.armed = False

    def upload(self, name: str, arr: np.ndarray) -> torch.Tensor:
        """``arr`` as a tensor on the device (int32, or bool for a bool
        array: the grammar mask), copied without blocking the host.  A
        buffer not set up front (the mask, the adapter ids) is pinned at its
        first use."""
        dtype = np.bool_ if arr.dtype == np.bool_ else np.int32
        if not self.cuda:
            return torch.from_numpy(np.array(arr, dtype=dtype))
        host = self.buf.get(name)
        if host is None:
            host = self.buf[name] = torch.zeros(
                arr.shape, dtype=torch.from_numpy(np.zeros(0, dtype)).dtype,
                pin_memory=True)
        host.numpy()[...] = arr
        out = host.to(self.device, non_blocking=True)
        self.event.record()
        self.armed = True
        return out

    def read_back(self, name: str, dev: torch.Tensor) -> torch.Tensor:
        """Start copying ``dev`` into this set's pinned buffer ``name``; the
        returned host tensor holds it once ``wait`` returns."""
        if not self.cuda:
            return dev
        host = self.buf[name]
        host.copy_(dev, non_blocking=True)
        self.event.record()
        self.armed = True
        return host


class _StaleThread(BaseException):
    """Raised inside a superseded loop thread at its first state-mutation
    attempt after an epoch-fenced restart.  BaseException so the isolation
    boundaries (which catch Exception) can't contain it: the stale thread
    exits instead of committing tokens into a slot the restarted loop may
    have reassigned."""


class _StreamHandle:
    """Iterator over streamed tokens + the request's ``future`` (the handle
    ``Engine.cancel`` takes when a streaming client disconnects)."""

    def __init__(self, it, future: Future):
        self._it = it
        self.future = future

    def __iter__(self):
        return self

    def __next__(self):
        return next(self._it)


class Engine:
    """Continuous-batching generation engine over one model, on ``device``
    (default ``"cuda"``; raises without a card — pass ``device="cpu"``).
    ``lora``: ``(adapter table, {name: id})`` from ``lora.load_adapters``,
    or None.

    ``tensor_parallel = N > 1`` serves over a mesh of N shards: ``device``
    may then be a list of N devices, one per shard (a device may repeat, so
    N shards may share one card); a single ``"cpu"`` puts every shard on the
    CPU; a single CUDA device asks for the first N cards and refuses with
    fewer.  The params may then lie on any device: each shard gets its own
    slice.  One controller thread drives every shard (``self.device`` is
    the first shard's, where tokens are sampled)."""

    def __init__(self, params, config: DecoderConfig,
                 engine_config: EngineConfig = EngineConfig(), device=None,
                 lora=None):
        ec = engine_config
        self._mesh = self._build_mesh(ec.tensor_parallel, device)
        self._tp = 1 if self._mesh is None else self._mesh.size
        if self._mesh is None:
            self.device = resolve_device(device[0] if isinstance(device, (list, tuple))
                                         else device)
            for name, v in params.items():
                for t in param_leaves({name: v}):
                    if t.device != self.device:
                        raise ValueError(f"param {name!r} is on {t.device}, the "
                                         f"engine runs on {self.device}")
        else:
            validate_config(config, self._mesh)
            self.device = self._mesh.devices[0]
        if ec.prefill_chunk % ec.page_size != 0:
            raise ValueError("prefill_chunk must be a multiple of page_size")
        if ec.pipeline_depth not in (0, 1):
            raise ValueError("pipeline_depth must be 0 (sync) or 1")
        if ec.speculative not in (None, "prompt_lookup"):
            raise ValueError(f"unsupported speculative mode {ec.speculative!r}")
        if ec.speculative and ec.temperature > 0:
            raise ValueError("speculative decoding requires temperature 0 "
                             "(greedy acceptance is what makes it lossless)")
        if ec.speculative and (ec.spec_max_draft < 1 or ec.spec_ngram < 1):
            raise ValueError("spec_max_draft and spec_ngram must be >= 1")
        if ec.weight_quant not in (None, "int8"):
            raise ValueError(f"unsupported weight_quant {ec.weight_quant!r}")
        if ec.weight_quant == "int8":
            # on the weights' own device, in column blocks: no dense f32
            # copy of the model ever exists
            params = quantize_weights_int8(params)
        # multi-LoRA: id 0 is the reserved zero adapter, so the per-slot id
        # table below lets every decode row pick its own adapter with no
        # branching (lora.py)
        self._lora = lora[0] if lora else None
        # the FLOPs model counts the whole adapter table's matmuls
        self._fm = FlopsModel(config, lora=self._lora)
        if self._lora is not None and self._mesh is not None:
            self._lora = shard_lora(self._lora, self._mesh)
        self.adapters = dict(lora[1]) if lora else {}
        self._aid_host = np.zeros((ec.max_slots,), np.int32)
        self.params = params
        self.config = config
        self.ec = ec
        self._spec = ec.speculative
        self._pipe_depth = ec.pipeline_depth
        # query rows per slot of a verify pass
        self._k = 1 + ec.spec_max_draft if self._spec else 1
        # full stop set: primary eos_id (if any) plus the multi-EOS extras
        self._stop_ids = frozenset(
            i for i in (ec.eos_id,) + tuple(ec.eos_ids) if i >= 0)
        self._scfg = ec.scheduler if ec.scheduler is not None else SchedulerConfig()
        weights: dict = {}
        for name, w in self._scfg.adapter_weights:
            if name not in self.adapters:
                raise ValueError(f"adapter_weights names unknown adapter "
                                 f"{name!r} (loaded: {sorted(self.adapters)})")
            weights[self.adapters[name]] = float(w)
        self._sched = QosScheduler(self._scfg, weights)
        self.batcher = NativeBatcher(ec.max_slots, ec.num_pages, ec.page_size,
                                     ec.max_pages_per_slot)
        c = config
        shape = (c.n_layers, ec.num_pages, c.n_kv_heads, ec.page_size, c.head_dim)
        self._paged = ec.paged_kernel
        if self._mesh is None:
            self.k_pool = make_kv_pool(shape, ec.kv_quant, device=self.device)
            self.v_pool = make_kv_pool(shape, ec.kv_quant, device=self.device)
        else:
            # per-shard lists: each shard holds its own slice of the weights
            # and its own KV heads' pages, allocated on its device directly
            self.params = shard_params(self.params, self._mesh)
            self.k_pool = alloc_pool(shape, self._mesh, quant=ec.kv_quant)
            self.v_pool = alloc_pool(shape, self._mesh, quant=ec.kv_quant)
        # per-engine registry (TTFT/TPOT/queue-wait/tick histograms + KV
        # gauges) and the SLO tracker it feeds
        self.telemetry = EngineTelemetry(
            enabled=ec.telemetry,
            slo=SloTracker(ec.slo or SloConfig()) if ec.telemetry else None)
        # tiered KV backing store: preemption swap blobs + pinned session
        # KV over host RAM aging to checksummed page files; a stable
        # disk_dir makes pinned sessions survive a full engine restart (the
        # store replays its manifest here)
        self._kv = TieredKVStore(
            ec.kv_store if ec.kv_store is not None
            else KVStoreConfig(host_max_bytes=self._scfg.swap_max_bytes),
            on_event=self.telemetry.count_kv_event)
        # exported-KV handle registry (prefill side) + the handoff chaos the
        # decode side's pull path consults (serve.py)
        normalize_role(ec.role)
        self._handoffs = HandoffStore(ttl_s=ec.handoff_ttl_s,
                                      max_bytes=ec.handoff_max_bytes)
        self._handoff_chaos = (HandoffChaos(ec.handoff_chaos)
                               if ec.handoff_chaos is not None else None)
        # published-prefix registry (multi-reader, TTL'd, byte-budgeted;
        # served as GET /engine/kv_fabric/<key>) + the fabric chaos the
        # pulling side's serve layer consults
        self._fabric = (FabricStore(ttl_s=ec.fabric_ttl_s,
                                    max_bytes=ec.fabric_max_bytes)
                        if ec.fabric else None)
        self._fabric_chaos = (FabricChaos(ec.fabric_chaos)
                              if ec.fabric_chaos is not None else None)
        # constrained-decoding chaos (zero-legal masks forced in the mask
        # builders; serve.py hands it to its ConstrainRegistry for the
        # cache-read corruption) and the subsystem's loop-side counters
        self._constrain_chaos = (ConstrainChaos(ec.constrain_chaos)
                                 if ec.constrain_chaos is not None else None)
        self._constrained_requests = 0
        self._constraint_stalls = 0
        # wired by JetStreamModel (it owns the tokenizer): tokens -> the
        # text fingerprint ladder the router's placement matches, and the
        # model identity stamped into every published frame (same-shape
        # models share chain hashes, so the puller must match the model too)
        self.fabric_fingerprinter = None
        self.fabric_model_id = None
        # rid -> pending: written under _lock (submit, cancel and every
        # terminal path), read lock-free on the loop thread and by the
        # health and watchdog probes (one dict operation is atomic under
        # the GIL), as the JAX engine reads it
        self._requests: dict[int, _Pending] = {}
        # O(1) cancel: future -> rid, maintained at submit and at every
        # terminal path
        self._future_rid: dict[Future, int] = {}  # guarded-by: _lock
        # session id -> rid of its one queued/in-flight turn: a session's KV
        # timeline is serial, so a concurrent turn raises SessionBusy
        self._session_active: dict[str, int] = {}  # guarded-by: _lock
        self._slot_req: dict[int, int] = {}
        self._prefilling: dict[int, int] = {}  # slot -> next prompt offset
        # Host-side mirrors of the C++ slot state, grown incrementally
        # (slot_pages row at admission + commit_token_ex page grants +
        # lookahead reservations) so the decode loop never re-snapshots
        # max_slots x max_pages from C per tick.  Rows/lens are LIVE only
        # for decode-ready slots — they stay zero (trash page, len 0) while
        # a slot is prefilling, so the decode step's unconditional KV write
        # cannot touch its pages.
        self._pt_host = np.zeros((ec.max_slots, ec.max_pages_per_slot), np.int32)
        self._len_host = np.zeros((ec.max_slots,), np.int32)
        # last committed token per slot: the next decode step's input
        self._tok_host = np.zeros((ec.max_slots,), np.int32)
        self._prefill_rows: dict[int, np.ndarray] = {}  # slot -> page row
        # ---- pipelined decode state
        # the one uncommitted in-flight tick: {"staging", "out", "slots",
        # "rids", ...}, committed behind the NEXT dispatch or at a fence
        self._inflight: Optional[dict] = None
        # device-resident feedback edge of the next dispatch: the previous
        # tick's guarded tokens ([B]) or packed rows ([B, K]); None =
        # rebuild from the host mirrors first
        self._dec_state: Optional[torch.Tensor] = None
        # seq_lens the NEXT dispatch uses (committed length + in-flight
        # lag), advanced by arithmetic, uploaded per dispatch, never read
        # back; it drives the lookahead page reservation
        self._dec_lens_shadow = np.zeros((ec.max_slots,), np.int32)
        # a roster change (admit, finish, NaN row) sets this: the next
        # pipelined dispatch drains and rebuilds first; the reason labels
        # the fence in stats["pipeline_fence_reasons"]
        self._roster_dirty = True
        self._dirty_reason: Optional[str] = None
        shapes = {"lens": (ec.max_slots,), "table": (ec.max_slots, ec.max_pages_per_slot)}
        if self._spec:  # seed and output rows are packed [B, K]
            shapes.update(seed=(ec.max_slots, self._k), drafts=(ec.max_slots, self._k - 1),
                          dlen=(ec.max_slots,), packed=(ec.max_slots, self._k))
        else:
            shapes.update(tokens=(ec.max_slots,), sampled=(ec.max_slots,))
        self._staging = ([_Staging(self.device, shapes) for _ in range(2)]
                         if self._pipe_depth else [])
        self._stage_flip = 0
        self._fences = 0
        self._fence_reasons: dict[str, int] = {}
        self._spec_proposed = 0
        self._spec_accepted = 0
        self._next_id = 0
        self._lock = threading.Lock()
        self._running = False
        self._draining = False
        self._stopped = False
        # stamped at every loop tick (health's last_tick_age_s)
        self._last_tick_ts = time.monotonic()
        # in-flight requests with failures > 0, so health() reads DEGRADED
        # without scanning the requests
        self._retrying = 0  # guarded-by: _lock
        self._thread: Optional[threading.Thread] = None
        self._wake = threading.Event()
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(ec.seed)
        self._prefill_dispatches = 0
        self._prefill_rows_total = 0
        self._prefill_batch_hist: dict[int, int] = {}
        self._decode_steps = 0
        self._ticks = 0
        self._ticks_failed = 0
        self._requests_failed = 0
        self._requests_shed = 0      # deadline expiry before first token
        self._requests_rejected = 0  # EngineOverloaded at submit
        self._nan_rows = 0
        # preemptions by mode, and the host wall time of swap-outs
        # (snapshot + put) and swap-ins (pop + scatter)
        self._preemptions = 0
        self._preempt_modes = {"swap": 0, "recompute": 0}
        self._preempt_reasons: dict[str, int] = {}
        self._swap_out_s = 0.0
        self._swap_in_s = 0.0
        # pages (and their bytes) that session restores scattered back
        self._restored_pages = 0
        self._restored_bytes = 0
        # ---- fault tolerance: chaos, watchdog, epoch fence
        self._chaos = ChaosInjector(ec.chaos) if ec.chaos is not None else None
        # epoch fence: a restarted loop bumps this; a stale (previously
        # hung) thread that wakes up sees the mismatch and exits without
        # touching engine state
        self._epoch = 0
        self._restarts = 0
        self._wd_stop = threading.Event()
        self._wd_thread: Optional[threading.Thread] = None
        # loop threads record their epoch here; state-mutation points check
        # it so a stale (superseded) thread dies instead of writing
        self._tls = threading.local()
        # request id per decode row (-1 = inactive), cached between roster
        # changes: the chaos injector's targeting key
        self._row_rids_c: Optional[list] = None
        # (tick, perf_counter) of the last decode dispatch: consecutive-tick
        # gaps land in engine_dispatch_gap_seconds
        self._dispatch_mark: Optional[tuple] = None
        # ---- performance introspection plane (perf.py): analytical FLOPs
        # model + goodput ledger (charged at dispatch, attributed at
        # commit), per-tick phase timeline, prefix-cache analytics, and the
        # managed profiler artifact store
        self._perf_on = ec.perf if ec.perf is not None else ec.telemetry
        dev_kind = (torch.cuda.get_device_name(self.device)
                    if self.device.type == "cuda" else "")
        plat, peak = platform_peak_flops(
            self.device.type, dev_kind, self._tp,
            n_cards=1 if self._mesh is None else len(self._mesh.distinct_devices))
        self.perf = PerfLedger(peak, plat, window_s=ec.perf_window_s,
                               on_charge=(self.telemetry.count_flops
                                          if self._perf_on else None))
        self.timeline = TickTimeline(capacity=ec.perf_timeline_capacity)
        self.cache_analytics = CacheStats()
        self.profiles = ProfileStore(parent=ec.profile_dir,
                                     max_runs=ec.profile_max_runs,
                                     max_bytes=ec.profile_max_bytes)
        self.flight = FlightRecorder(capacity=ec.flight_recorder_capacity,
                                     dump_dir=ec.flight_dir)
        self._trace_ring: dict[int, RequestSpan] = {}  # guarded-by: _lock
        # retained-size accounting for the trace ring (trace_history_bytes)
        self._trace_ring_bytes = 0
        self._trace_sizes: dict[int, int] = {}  # guarded-by: _lock
        # trace id -> flight-recorder dump paths referencing it (bounded)
        self._trace_dumps: dict[str, list] = {}  # guarded-by: _lock
        # session id -> (trace_id, span_id) of its most recent terminal
        # turn, so turn N+1's span links turn N
        self._session_spans: dict[str, tuple] = {}  # guarded-by: _lock
        self._nan_dump_tick = -1  # last tick that produced a NaN dump
        # ---- incident plane: hot paths only ever feed() it (an O(1)
        # append); detection, evidence, classification and bundle writes
        # run on ITS thread
        self.incidents: Optional[IncidentManager] = None
        self._burn_above: set = set()
        if ec.incidents:
            self.incidents = IncidentManager(
                scope="engine",
                config=IncidentConfig(
                    debounce_s=ec.incident_debounce_s,
                    resolve_s=ec.incident_resolve_s,
                    poll_interval_s=ec.incident_poll_s,
                    bundle_dir=ec.incident_dir),
                detectors=engine_detectors(),
                evidence=self._incident_evidence,
                dump=self._incident_dump,
                on_firing=self.telemetry.count_incident_firing,
                on_resolve=self.telemetry.count_incident,
                on_open_count=self.telemetry.set_incidents_open)
            self.incidents.add_poller(self._incident_poll)
        # on-demand torch.profiler capture, started and stopped on the loop
        # thread; the device synchronizes before a capture stops, so the
        # window's last kernels are in the trace
        self._profiler = TickProfiler(sync=self._sync_device)
        self._profiler.on_complete = self._profile_complete

    @staticmethod
    def _build_mesh(tp: int, device):
        """The engine's tensor mesh, or None at ``tensor_parallel`` 1."""
        if not isinstance(tp, int) or tp < 1:
            raise ValueError(f"tensor_parallel={tp!r} must be an integer >= 1")
        devices = list(device) if isinstance(device, (list, tuple)) else None
        if devices is not None and len(devices) != tp:
            raise ValueError(f"tensor_parallel={tp} needs one device per shard, "
                             f"got {len(devices)}")
        if tp == 1:
            return None
        if devices is None and resolve_device(device).type == "cpu":
            devices = ["cpu"] * tp
        return tensor_mesh(tp, devices)

    # ---------------------------------------------------------------- public

    def start(self) -> None:
        if self._running and self._thread is not None and self._thread.is_alive():
            return  # idempotent: a second loop on the same pools would race
        self._running = True
        self._draining = False
        self._last_tick_ts = time.monotonic()
        self._thread = threading.Thread(target=self._loop, args=(self._epoch,),
                                        daemon=True)
        self._thread.start()
        if self.ec.watchdog_interval_s > 0 and self._wd_thread is None:
            self._wd_stop.clear()
            self._wd_thread = threading.Thread(target=self._watchdog, daemon=True)
            self._wd_thread.start()
        if self.incidents is not None:
            self.incidents.start()  # idempotent, like this method

    def begin_drain(self) -> None:
        """Enter DRAINING without stopping: new submissions are refused with
        EngineShutdown, but queued and in-flight requests keep running to
        completion — the fleet-level graceful-drain handshake (the router
        stops routing to a DRAINING replica on its next health probe; the
        operator calls ``stop()`` once ``stats['active_slots']`` and
        ``stats['queue_depth']`` reach zero, or lets the drain timeout
        force it)."""
        with self._lock:
            self._draining = True

    def cancel_drain(self) -> None:
        """Abort an in-progress ``begin_drain`` (scale-down was cancelled):
        the engine resumes accepting submissions.  No-op after stop()."""
        with self._lock:
            if not self._stopped:
                self._draining = False

    def stop(self, drain: bool = True) -> None:
        """Graceful drain then hard stop: new submissions are refused
        (EngineShutdown), queued requests are failed with EngineShutdown,
        in-flight slots get up to ``drain_timeout_s`` to finish, then are
        failed too.  ``drain=False`` skips the wait."""
        with self._lock:  # atomic with generate_async's shutdown check
            self._draining = True
        # retire the watchdog FIRST: joining it fences any _supervise in
        # flight, so self._thread cannot be swapped for a restarted loop
        # between the join and batcher.close() below
        self._wd_stop.set()
        if self._wd_thread is not None:
            self._wd_thread.join(timeout=5)
            self._wd_thread = None
        self._fail_unassigned(EngineShutdown("engine stopping"))
        t = self._thread
        if drain and t is not None and t.is_alive():
            deadline = time.monotonic() + self.ec.drain_timeout_s
            while self._slot_req and time.monotonic() < deadline:
                time.sleep(0.01)
        self._running = False
        self._wake.set()
        if t is not None:
            t.join(timeout=10)
        # the loop is joined: an uncommitted pipeline tick is dropped with
        # its requests, never committed into a closing batcher
        if self._inflight is not None:
            self._charge_dropped(self._inflight, "tick_retry")
        self._inflight = None
        self._dec_state = None
        self._roster_dirty = True
        for slot in list(self._slot_req):
            self._fail_slot(slot, EngineShutdown("engine stopped"))
        self._fail_unassigned(EngineShutdown("engine stopped"))
        # a capture still open (armed on an engine that got no more work)
        # must not keep the process's one profiler busy
        self._profiler.abort()
        # retire the incident manager BEFORE the batcher closes: its final
        # processing pass may snapshot evidence through self.stats
        if self.incidents is not None:
            self.incidents.stop()
        self.batcher.close()
        # an ephemeral (auto-tempdir) store deletes its page files; an
        # explicit disk_dir keeps the session manifest for the next engine
        self._kv.close()
        # managed profiler artifacts die with the engine
        self.profiles.close()
        # unpulled handoff frames and published fabric frames die with the
        # engine: a pull would route to this process's port
        self._handoffs.clear()
        if self._fabric is not None:
            self._fabric.clear()
        self._stopped = True
        self._draining = False

    def health(self) -> dict:
        """Engine health state machine, as the JAX engine reports it:

        SERVING   — loop thread alive, no distress signal
        DEGRADED  — alive, but a request is mid-retry after tick failures,
                    or the current tick has been stuck past hang_timeout_s
        DRAINING  — stop() in progress
        DEAD      — loop thread not running (never started, stopped, or
                    died with restart disabled)

        ``role`` is the configured ``EngineConfig.role``; ``restarts``
        counts the watchdog's loop restarts."""
        if self._draining:
            state = "DRAINING"
        else:
            t = self._thread
            age = time.monotonic() - self._last_tick_ts
            if not self._running or t is None or not t.is_alive():
                state = "DEAD"
            elif (self._slot_req or self._requests) and age > self.ec.hang_timeout_s:
                state = "DEGRADED"
            else:
                # graftlint: disable=lock-discipline -- O(1) gauge, no lock:
                # _retrying tracks requests mid-retry (maintained under _lock
                # by _note_group_failure / _reset_failures / the terminal
                # path) so a /metrics scrape never waits on the hot-loop lock
                state = "DEGRADED" if self._retrying > 0 else "SERVING"
        return {"state": state, "role": self.ec.role,
                "last_tick_age_s": round(time.monotonic() - self._last_tick_ts, 4),
                "ticks": self._ticks, "ticks_failed": self._ticks_failed,
                "restarts": self._restarts}

    def generate_async(self, tokens: list[int], max_new_tokens: int = 32,
                       deadline: Optional[float] = None,
                       priority: Optional[str] = None,
                       session_id: Optional[str] = None,
                       stream: Optional[queue.Queue] = None,
                       trace=None, links: Optional[list] = None,
                       waste_hint: Optional[str] = None,
                       handoff: bool = False, kv_import=None,
                       fabric_import=None,
                       pre_hints: Optional[dict] = None,
                       adapter: Optional[str] = None, brownout: int = 0,
                       constrain=None) -> Future:
        """Submit a prompt; the Future resolves to a result dict (``rid``,
        ``tokens``, ``num_tokens``, ``truncated``, ``cancelled``,
        ``preemptions``, ``ttft_s``, ``latency_s``, a ``session`` block with
        a session id, a ``handoff`` block for a prefill phase and a
        ``fabric`` block after a fabric import).

        ``deadline``: seconds from now (default ``default_deadline_s``); a
        request without its first token by then is shed with
        DeadlineExceeded.  ``priority``: QoS class — "interactive" (default)
        | "batch" | "best_effort" — deciding admission order and preemption
        standing.  ``session_id``: conversation pin — the finished turn's KV
        pages park in the tiered store under this id and the NEXT turn with
        the same id, whose prompt extends this turn's context, restores
        them instead of re-prefilling.  ``stream``: a queue that receives
        each token id as it is committed, then ``(None, result)`` or
        ``(None, exception)`` (``generate_stream`` reads it).  ``trace``: a
        ``core.tracing.TraceContext`` to adopt — the request's span joins
        that trace as a child (the ingress relay passes the hop context via
        the ``traceparent`` header); a fresh trace is minted when absent.
        ``links``: cross-trace span links (the failed relay hop a
        re-admission resumes from); a ``session_prev`` link to the
        session's previous turn is added automatically.  ``waste_hint``:
        the caller knows this request's prefill recomputes work done
        elsewhere (``failover_reprefill``, or ``handoff_degraded`` /
        ``fabric_degraded`` for an import that failed before submit); the
        perf ledger charges it as waste under that reason.
        ``handoff``: disaggregated PREFILL phase — at finish the committed
        KV pages are exported into the handoff store and the result's
        ``handoff`` block carries the one-shot pull handle.  ``kv_import``:
        disaggregated DECODE phase — a verified ``(blob, nbytes,
        resume_len)`` covering the prompt (which already ends with the
        prefill phase's first token): admission scatters it into a fresh
        slot row and decode starts without a prefill.  ``fabric_import``: a
        verified ``(blob, hashes, nbytes)`` remote PREFIX frame, matched by
        chain hash at admission and scattered past what the prefix cache
        covers.  Any import problem degrades to a plain re-prefill.
        ``pre_hints``: serve-layer walls spent on this request BEFORE submit
        (``{"fabric_pull": s}`` / ``{"handoff_import": s}``), carried on the
        span for the latency waterfall.
        ``adapter``: name of a loaded LoRA adapter to decode this request
        with (None = the base model).  ``brownout``: the ingress
        degradation stage, clamped to [0, 3]: >= 2 drops this request's
        speculation drafts, >= 3 also defers its fabric publish at finish
        (quality degrades, never correctness).  ``constrain``: a
        ``serving.constrain.GrammarConstraint`` gating every token this
        request samples (compiled by the serve layer, off the tick loop);
        its token table must map THIS model's vocabulary.

        Raises RequestError for an empty prompt, a token id outside the
        vocabulary (an out-of-range embedding index would device-assert on
        the card), a bad priority or session id, an unknown adapter, a
        constraint mapped for another vocabulary, or a request beyond the
        slot capacity; EngineOverloaded when the queue is at
        ``max_queue_depth``; SessionBusy while the session has a turn in
        flight; EngineShutdown once stop() has begun."""
        if not tokens:
            raise RequestError("empty prompt")
        if waste_hint is not None and waste_hint not in WASTE_REASONS:
            raise RequestError(f"unknown waste_hint {waste_hint!r} "
                               f"(known: {WASTE_REASONS})")
        V = self.config.vocab_size
        if any(not 0 <= int(t) < V for t in tokens):
            raise RequestError(f"token ids must lie in [0, {V})")
        prio = normalize_priority(priority)
        if session_id is not None:
            session_id = normalize_session_id(session_id)
        if constrain is not None:
            tv = getattr(getattr(constrain, "table", None), "vocab_size", None)
            if tv != self.config.vocab_size:
                # a mask sized for another vocab would silently mis-gate
                # every token: the one constraint shape bug admission can
                # catch cheaply
                raise RequestError(
                    f"constraint token table maps vocab {tv}, model vocab "
                    f"is {self.config.vocab_size}")
        if self._draining or self._stopped:
            raise EngineShutdown("engine is stopping")
        # a request that can never fit must fail HERE, not head-of-line-
        # block the scheduler
        if (self._pages_for(len(tokens) + max_new_tokens)
                > self.ec.max_pages_per_slot
                or self._pages_for(len(tokens)) >= self.ec.num_pages):
            raise RequestError(
                f"prompt+generation ({len(tokens)}+{max_new_tokens}) exceeds engine capacity "
                f"({self.ec.max_pages_per_slot * self.ec.page_size} tokens/slot)"
            )
        depth = len(self._sched) + self.batcher.queue_depth
        if self.ec.max_queue_depth > 0 and depth >= self.ec.max_queue_depth:
            self._requests_rejected += 1
            if self.incidents is not None:
                # capacity signal: admission-queue growth past the bound
                self.incidents.feed("queue_growth", queue_depth=depth,
                                    rejected=1,
                                    trace_ids=self._live_trace_ids())
            exc = EngineOverloaded(f"queue depth {depth} >= "
                                   f"max_queue_depth {self.ec.max_queue_depth}")
            # load-proportional retry hint, surfaced as Retry-After
            exc.retry_after_s = round(min(
                10.0, 0.25 + 0.1 * depth / max(1, self.ec.max_slots)), 3)
            raise exc
        if deadline is None:
            deadline = self.ec.default_deadline_s
        aid = 0
        if adapter is not None:
            if adapter not in self.adapters:
                raise RequestError(f"unknown adapter {adapter!r} "
                                   f"(loaded: {sorted(self.adapters)})")
            aid = self.adapters[adapter]
        toks = [int(t) for t in tokens]
        hashes = _page_hashes(toks, self.ec.page_size, aid)
        fut: Future = Future()
        now = time.perf_counter()
        with self._lock:
            # shutdown check is atomic with registration: stop() flips
            # _draining under this lock BEFORE failing unassigned work
            if self._draining or self._stopped:
                raise EngineShutdown("engine is stopping")
            if session_id is not None and session_id in self._session_active:
                raise SessionBusy(
                    f"session {session_id!r} already has request "
                    f"{self._session_active[session_id]} in flight")
            rid = self._next_id
            self._next_id += 1
            span = None
            if self.ec.telemetry:
                span = RequestSpan(rid, trace=trace, links=links, cls=prio)
                for k, v in (pre_hints or {}).items():
                    # pulls the serve layer ran before the span's clock
                    # started (waterfall.PRE_HINT_SEGMENTS)
                    span.hint(f"pre_{k}", float(v))
                if session_id is not None:
                    prev = self._session_spans.get(session_id)
                    if prev is not None:
                        # turn N+1 links turn N
                        span.links.append({"type": "session_prev",
                                           "trace_id": prev[0],
                                           "span_id": prev[1]})
            pending = self._requests[rid] = _Pending(
                tokens=toks, max_new_tokens=max_new_tokens, future=fut,
                submitted_at=now, page_hashes=hashes, context=list(toks),
                rid=rid, deadline=now + deadline if deadline is not None else None,
                priority=prio, rank=PRIORITY_RANK[prio], session_id=session_id,
                stream=stream, span=span, waste_reason=waste_hint,
                handoff=handoff, adapter_id=aid,
                brownout=max(0, min(3, int(brownout))), constrain=constrain)
            if constrain is not None:
                self._constrained_requests += 1
            if session_id is not None:
                self._session_active[session_id] = rid
            self._future_rid[fut] = rid
        if kv_import is not None:
            self._park_handoff(pending, kv_import)
        if fabric_import is not None and kv_import is None:
            self._park_fabric(pending, fabric_import)
        if waste_hint in ("handoff_degraded", "fabric_degraded"):
            # the serve layer degraded the import BEFORE submit: the same
            # incident signal as an engine-side degrade
            self._note_degradation(waste_hint.split("_", 1)[0], "pre_submit",
                                   pending)
        # the request waits in the HOST scheduler queue; the loop submits it
        # to the C++ core only when the policy admits it
        self._sched.push(self._entry_for(rid, pending))
        self._wake.set()
        return fut

    def _park_handoff(self, pending: _Pending, kv_import) -> None:
        """Park a decode phase's pulled frame in the tiered store under its
        rid; admission then takes the swap-resume scatter.  ``resume_len``
        must equal the submitted token count: the frame's KV covers
        positions [0, len(tokens) - 2] and the first decode step writes
        position len(tokens) - 1 (serve.py verified the frame; this is the
        engine-side backstop).  A failure degrades to a re-prefill."""
        blob, nbytes, resume_len = kv_import
        ok = False
        if int(resume_len) == len(pending.tokens):
            try:
                ok = self._kv.put_swap(pending.rid, blob, int(nbytes), count=False)
            except Exception:  # noqa: BLE001 — an import must degrade
                ok = False
        if ok:
            pending.swapped = True
            pending.resume_len = int(resume_len)
            pending.handoff_import = True
            self.telemetry.count_handoff("import")
            self.telemetry.count_handoff_bytes("in", int(nbytes))
        else:
            self._degrade_handoff(pending, "park_failed")

    def _park_fabric(self, pending: _Pending, fabric_import) -> None:
        """A verified remote prefix frame rides the pending record (freed
        with it, so no reap path can leak it), budgeted: the frames parked
        on queued requests stay within ``fabric_max_bytes``, or this import
        degrades to a re-prefill."""
        try:
            blob, fhashes, fnbytes = fabric_import
            fnbytes = int(fnbytes)
            fh = np.asarray(fhashes, np.uint64)
            with self._lock:
                # check + reserve atomically against concurrent submits
                parked = sum(p.fabric_import[2] for p in self._requests.values()
                             if p.fabric_import is not None)
                if parked + fnbytes > self.ec.fabric_max_bytes:
                    raise MemoryError("fabric parking budget exhausted")
                pending.fabric_import = (blob, fh, fnbytes)
            self.telemetry.count_fabric("import")
            self.telemetry.count_fabric_bytes("in", fnbytes)
        except Exception:  # noqa: BLE001 — an import must degrade
            pending.fabric_import = None
            pending.waste_reason = "fabric_degraded"
            self._degrade_fabric(pending, "park_failed")

    def _entry_for(self, rid: int, pending: _Pending) -> QueueEntry:
        return QueueEntry(rid=rid, rank=pending.rank, deadline=pending.deadline,
                          submitted_at=pending.submitted_at,
                          adapter_id=pending.adapter_id,
                          pages=self._pages_for(len(pending.tokens)))

    def generate(self, tokens: list[int], max_new_tokens: int = 32,
                 timeout: float = 300.0, deadline: Optional[float] = None,
                 priority: Optional[str] = None,
                 session_id: Optional[str] = None, trace=None,
                 links: Optional[list] = None,
                 waste_hint: Optional[str] = None, handoff: bool = False,
                 kv_import=None, fabric_import=None,
                 pre_hints: Optional[dict] = None,
                 adapter: Optional[str] = None, brownout: int = 0,
                 constrain=None) -> dict:
        fut = self.generate_async(tokens, max_new_tokens, deadline=deadline,
                                  priority=priority, session_id=session_id,
                                  trace=trace, links=links, waste_hint=waste_hint,
                                  handoff=handoff, kv_import=kv_import,
                                  fabric_import=fabric_import, pre_hints=pre_hints,
                                  adapter=adapter, brownout=brownout,
                                  constrain=constrain)
        try:
            return fut.result(timeout=timeout)
        except FutureTimeoutError:
            # the caller is gone: cancel so the engine frees the slot and
            # pages at its next tick instead of decoding to the budget
            self.cancel(fut)
            raise

    def generate_stream(self, tokens: list[int], max_new_tokens: int = 32,
                        timeout: float = 300.0, deadline: Optional[float] = None,
                        priority: Optional[str] = None,
                        session_id: Optional[str] = None, trace=None,
                        links: Optional[list] = None,
                        waste_hint: Optional[str] = None, kv_import=None,
                        fabric_import=None,
                        pre_hints: Optional[dict] = None,
                        adapter: Optional[str] = None, brownout: int = 0,
                        constrain=None) -> Iterator:
        """Yield token ids as they are committed, then the result dict that
        ``generate`` returns.  The prompt is submitted NOW (a plain method
        returning an iterator), so it runs even if the caller delays
        iteration.  ``timeout`` bounds the wait for EACH next item (a
        stall raises TimeoutError), not the whole generation.  A typed
        engine fault (shed, failure, shutdown) is raised from the
        iterator.  The iterator's ``.future`` is what ``cancel`` takes when
        a streaming client disconnects."""
        q: queue.Queue = queue.Queue()
        fut = self.generate_async(tokens, max_new_tokens, deadline=deadline,
                                  priority=priority, session_id=session_id,
                                  stream=q, trace=trace, links=links,
                                  waste_hint=waste_hint, kv_import=kv_import,
                                  fabric_import=fabric_import, pre_hints=pre_hints,
                                  adapter=adapter, brownout=brownout,
                                  constrain=constrain)

        def _iter():
            while True:
                try:
                    item = q.get(timeout=timeout)
                except queue.Empty:
                    raise TimeoutError(
                        f"generation stalled past {timeout}s") from None
                if isinstance(item, tuple) and item[0] is None:
                    if isinstance(item[1], BaseException):
                        raise item[1]
                    yield item[1]
                    return
                yield item

        return _StreamHandle(_iter(), fut)

    def cancel(self, future: Future) -> bool:
        """Cancel the request behind a generate_async future.  A request
        still queued (or preempted and re-queued) resolves IMMEDIATELY
        (``cancelled: True``, keeping any tokens it committed before an
        eviction); one in a slot is finished by the loop at its next tick.
        False if the request already finished."""
        with self._lock:
            rid = self._future_rid.get(future)
            pending = self._requests.get(rid) if rid is not None else None
            if pending is None:
                return False
            pending.cancelled = True
            queued = rid not in self._slot_req.values()
            if queued:
                self._requests.pop(rid)
        if queued:
            # resolve OUTSIDE the lock: a done-callback may re-enter
            self._sched.remove(rid)
            self._kv.discard_swap(rid)
            self._retire(pending, "cancelled")
            self._resolve(pending, self._result(rid, pending, cancelled=True))
            return True
        self._wake.set()
        return True

    @staticmethod
    def _result(rid: int, pending: _Pending, truncated: bool = False,
                cancelled: bool = False) -> dict:
        """A request's result dict (a request cancelled while preempted keeps
        its committed tokens and first TTFT)."""
        return {
            "rid": rid,
            "tokens": pending.generated,
            "num_tokens": len(pending.generated),
            "truncated": truncated,
            "cancelled": cancelled,
            "preemptions": pending.preemptions,
            "ttft_s": (pending.first_token_at - pending.submitted_at
                       if pending.first_token_at else 0.0),
            "latency_s": time.perf_counter() - pending.submitted_at,
        }

    def _resolve_queued_cancel(self, rid: int, pending: _Pending) -> bool:
        """Loop-side twin of cancel()'s queued branch.  False when cancel()
        itself won the race and already resolved it."""
        with self._lock:
            if self._requests.get(rid) is not pending:
                return False
            self._requests.pop(rid, None)
        self._sched.remove(rid)
        self._kv.discard_swap(rid)
        self._retire(pending, "cancelled")
        self._resolve(pending, self._result(rid, pending, cancelled=True))
        return True

    def _retire(self, pending: _Pending, outcome: str) -> None:
        """Every terminal path (finish, fail, shed, cancel, reap, stop)
        funnels here exactly once per request: the future index and the
        session-busy entry are released, so a session is never left "in
        flight" by a missed edge; the outcome is counted, and the span is
        terminal-marked and retired into the bounded trace history (oldest
        evicted first, by entries and by bytes)."""
        sid = pending.session_id
        with self._lock:
            self._future_rid.pop(pending.future, None)
            if sid is not None and self._session_active.get(sid) == pending.rid:
                del self._session_active[sid]
            if pending.failures:  # no longer mid-retry: it is terminal now
                pending.failures = 0
                self._retrying -= 1
        self.telemetry.count_outcome(outcome)
        span = pending.span
        if span is None:
            return
        if span.outcome is None:
            span.mark(outcome)
        evicted = 0
        with self._lock:
            if sid is not None:
                # the NEXT turn's span links this one (session_prev);
                # pop-then-insert keeps active sessions at the LRU tail
                self._session_spans.pop(sid, None)
                self._session_spans[sid] = (span.trace_id, span.span_id)
                while len(self._session_spans) > self._TRACE_REF_CAP:
                    self._session_spans.pop(next(iter(self._session_spans)))
            nb = span.nbytes()
            self._trace_ring[span.rid] = span
            self._trace_sizes[span.rid] = nb
            self._trace_ring_bytes += nb
            while (self._trace_ring
                   and (len(self._trace_ring) > self.ec.trace_history
                        or self._trace_ring_bytes > self.ec.trace_history_bytes)):
                old_rid = next(iter(self._trace_ring))
                if old_rid == span.rid:
                    break  # never evict the span being archived
                self._trace_ring.pop(old_rid)
                self._trace_ring_bytes -= self._trace_sizes.pop(old_rid, 0)
                evicted += 1
        self.telemetry.count_trace_evictions(evicted)

    def sessions(self) -> dict:
        """Pinned sessions in the tiered KV store: id -> {nbytes, version,
        tiers, context_len, pages}.  Entries a previous engine left on the
        same ``disk_dir`` appear here before first touch."""
        return self._kv.session_list()

    def drop_session(self, session_id: str) -> bool:
        """Unpin a session: its KV leaves both tiers and the manifest.
        False if no such session."""
        return self._kv.drop_session(session_id)

    @property
    def stats(self) -> dict:
        with self._lock:
            return {
                "active_slots": self.batcher.num_active,
                # host scheduler queue + the (normally empty) C++ queue
                "queue_depth": len(self._sched) + self.batcher.queue_depth,
                "free_pages": self.batcher.free_pages,
                "preemptions": self._preemptions,
                "preemption_modes": dict(self._preempt_modes),
                "preemption_reasons": dict(self._preempt_reasons),
                "swap_out_ms": self._swap_out_s * 1e3,
                "swap_in_ms": self._swap_in_s * 1e3,
                "session_restored_pages": self._restored_pages,
                "session_restored_bytes": self._restored_bytes,
                "scheduler": self._sched.snapshot(),
                **self._kv.stats(),
                "requests_shed": self._requests_shed,
                "requests_rejected": self._requests_rejected,
                "constrained_requests": self._constrained_requests,
                "constraint_stalls": self._constraint_stalls,
                "spec_proposed": self._spec_proposed,
                "spec_accepted": self._spec_accepted,
                "prefill_dispatches": self._prefill_dispatches,
                "prefill_rows": self._prefill_rows_total,
                "prefill_batch_hist": dict(self._prefill_batch_hist),
                "pipeline_depth": self._pipe_depth,
                "pipeline_fences": self._fences,
                "pipeline_fence_reasons": dict(self._fence_reasons),
                "decode_steps": self._decode_steps,
                "ticks": self._ticks,
                "ticks_failed": self._ticks_failed,
                "restarts": self._restarts,
                "requests_failed": self._requests_failed,
                "nan_rows": self._nan_rows,
                "trace_history_entries": len(self._trace_ring),
                "trace_history_bytes": self._trace_ring_bytes,
                "role": self.ec.role,
                # the tensor mesh's degree (1 = no mesh)
                "tensor_parallel": self._tp,
                "handoff": self._handoffs.stats(),
                **({"fabric": self._fabric.stats()}
                   if self._fabric is not None else {}),
                **({"handoff_chaos": self._handoff_chaos.stats()}
                   if self._handoff_chaos is not None else {}),
                **({"fabric_chaos": self._fabric_chaos.stats()}
                   if self._fabric_chaos is not None else {}),
                **({"constrain_chaos": self._constrain_chaos.stats()}
                   if self._constrain_chaos is not None else {}),
                **({"slo": self.telemetry.slo.snapshot()}
                   if self.telemetry.slo is not None else {}),
                **({"incidents": self.incidents.stats()}
                   if self.incidents is not None else {}),
                **({"chaos": self._chaos.stats()} if self._chaos else {}),
                **self.batcher.cache_stats(),
            }

    # ------------------------------------------------ incident plane API

    def incident_list(self) -> list:
        """Incidents this engine's manager holds (open first), served as
        ``GET /engine/incidents``.  Empty when the plane is off."""
        return self.incidents.list() if self.incidents is not None else []

    def incident_get(self, incident_id: str) -> Optional[dict]:
        return (self.incidents.get(incident_id)
                if self.incidents is not None else None)

    def incident_open_count(self) -> int:
        return self.incidents.open_count() if self.incidents is not None else 0

    def _incident_event(self, kind: str, **attrs) -> None:
        """The ONE incident-plane call the hot paths make: O(1) append
        into the manager's intake deque, no-op when the plane is off."""
        if self.incidents is not None:
            self.incidents.feed(kind, **attrs)

    def _note_degradation(self, source: str, outcome: str,
                          pending: Optional[_Pending] = None) -> None:
        """Degradation-outcome signal: a storage-fault recompute, a handoff
        re-prefill or a degraded fabric pull completed the request the slow
        way.  One call per degraded request, where its outcome is counted."""
        if self.incidents is None:
            return
        tids = ([pending.span.trace_id]
                if pending is not None and pending.span is not None else [])
        self.incidents.feed("degradation", source=source, outcome=outcome,
                            rid=getattr(pending, "rid", None), trace_ids=tids)

    def _live_trace_ids(self, cap: int = 4) -> list:
        """Trace ids of a few live requests (else of the most recent
        archived spans): the correlation evidence for signals that concern
        the ENGINE rather than one request.  Best-effort."""
        if not self.ec.telemetry:
            return []
        out: list = []
        try:
            with self._lock:
                for p in self._requests.values():
                    if p.span is not None:
                        out.append(p.span.trace_id)
                        if len(out) >= cap:
                            break
                if not out:
                    for sp in reversed(self._trace_ring.values()):
                        out.append(sp.trace_id)
                        if len(out) >= cap:
                            break
            return out
        except Exception:  # noqa: BLE001 — evidence is best-effort
            return out

    def _incident_evidence(self) -> dict:
        """Evidence snapshot for a newly opened incident (manager thread):
        the metrics window, the health state, and the SLO burn series."""
        out: dict = {}
        try:
            st = self.stats
            out["metrics"] = {k: st.get(k) for k in (
                "active_slots", "queue_depth", "free_pages", "ticks",
                "ticks_failed", "requests_shed", "requests_rejected",
                "requests_failed", "nan_rows", "restarts", "preemptions")}
            if "slo" in st:
                out["slo"] = st["slo"]
        except Exception:  # noqa: BLE001 — engine may be stopping
            pass
        try:
            out["health"] = self.health()
        except Exception:  # noqa: BLE001
            pass
        return out

    def _incident_dump(self, first_event: dict) -> Optional[str]:
        """Flight-recorder dump for a new incident: reuse the dump the
        triggering signal already produced, else force one now while the
        ring still holds the faulting ticks."""
        path = first_event.get("dump")
        if path:
            return path
        return self.flight.dump(
            "incident_open",
            extra={"kind": first_event.get("kind"),
                   "trace_ids": list(first_event.get("trace_ids") or ())})

    def _incident_poll(self) -> None:
        """SLO burn-threshold detector (manager thread): edge-triggered per
        (class, metric) against the tracker's own snapshot; re-arms at half
        the threshold so a rate hovering at the line doesn't flap."""
        slo = self.telemetry.slo
        if slo is None:
            return
        try:
            snap = slo.snapshot()
        except Exception:  # noqa: BLE001
            return
        seen: set = set()
        for cls, metrics in snap.items():
            for metric, rec in metrics.items():
                thr = rec.get("burn_threshold")
                burn = (rec.get("burn") or {}).get(rec.get("burn_window"))
                key = (cls, metric)
                seen.add(key)
                if burn is None or (thr and burn < thr * 0.5):
                    self._burn_above.discard(key)
                    continue
                if (rec.get("burn_samples") or 0) < (rec.get("burn_min_samples") or 0):
                    continue
                if thr and burn >= thr and key not in self._burn_above:
                    self._burn_above.add(key)
                    try:
                        queue_depth = len(self._sched) + self.batcher.queue_depth
                    except Exception:  # noqa: BLE001
                        queue_depth = 0
                    self._incident_event(
                        "slo_burn", cls=cls, metric=metric,
                        burn=round(burn, 3), threshold=thr,
                        window=rec.get("burn_window"),
                        queue_depth=queue_depth,
                        prefill_active=len(self._prefilling),
                        dominant_segment=self._dominant_segment(cls),
                        trace_ids=self._live_trace_ids())
        self._burn_above &= seen

    # ------------------------------------------------ perf introspection API

    def _kv_fragmentation(self) -> tuple:
        """(owned_pages, committed_tokens, internal-fragmentation ratio)
        over live decode slots: 1 - tokens / (pages * page_size)."""
        owned = int(np.count_nonzero(self._pt_host))
        toks = int(self._len_host.sum())
        if owned <= 0:
            return 0, toks, 0.0
        frag = 1.0 - toks / (owned * self.ec.page_size)
        return owned, toks, max(0.0, min(1.0, frag))

    def perf_snapshot(self) -> dict:
        """The performance-introspection snapshot (``GET /engine/perf``):
        the FLOPs/goodput ledger with exact waste attribution, windowed
        MFU/goodput ratios, cache analytics, the tick-phase timeline tail,
        and the profiler run registry."""
        snap = self.perf.snapshot()
        snap["enabled"] = self._perf_on
        owned, toks, frag = self._kv_fragmentation()
        try:
            cs = self.batcher.cache_stats()
            free = self.batcher.free_pages
        except RuntimeError:  # engine stopped
            cs, free = {}, 0
        total = max(1, self.ec.num_pages - 1)  # page 0 is the trash page
        snap["cache"] = {
            **self.cache_analytics.snapshot(),
            **cs,
            "free_pages": free,
            "occupancy": round((total - free) / total, 6),
            "owned_pages": owned,
            "committed_tokens": toks,
            "fragmentation": round(frag, 6),
            # the fleet fabric's published prefixes: what the router's
            # cache-aware placement scores (through /fleet/cache)
            "fabric": self.fabric_view(),
        }
        snap["timeline"] = self.timeline.snapshot()
        snap["profiler"] = {
            "active": self._profiler.active,
            "captures": self._profiler.captures,
            "last_error": self._profiler.last_error,
            "runs": self.profiles.snapshot(),
        }
        snap["spec"] = {"proposed": self._spec_proposed,
                        "accepted": self._spec_accepted}
        return snap

    def refresh_perf_metrics(self) -> None:
        """Scrape-time refresh of the derived perf gauges (MFU, goodput
        ratio, KV fragmentation)."""
        if not self._perf_on:
            return
        _, _, frag = self._kv_fragmentation()
        self.telemetry.set_perf(self.perf.mfu(), self.perf.goodput_ratio(),
                                frag, self.perf.platform)

    # ---------------------------------------------------------- tracing API

    def trace(self, rid: int) -> Optional[dict]:
        """Lifecycle trace for a request id: live requests from their
        in-flight span, resolved ones from the bounded trace history.  None
        when telemetry is off or the rid fell out of the history ring."""
        with self._lock:
            pending = self._requests.get(rid)
            span = pending.span if pending is not None else self._trace_ring.get(rid)
        return span.to_dict() if span is not None else None

    # bound on the auxiliary trace-reference maps (flight-dump refs,
    # session last-span links)
    _TRACE_REF_CAP = 256

    def trace_by_id(self, trace_id: str) -> dict:
        """Every span this engine holds for one distributed trace id —
        live requests and the bounded history — plus the flight-recorder
        dump paths that reference it (the ingress's ``GET
        /debug/trace/<id>`` fans this out across replicas)."""
        with self._lock:
            spans = [p.span for p in self._requests.values()
                     if p.span is not None and p.span.trace_id == trace_id]
            seen = {id(sp) for sp in spans}
            spans += [sp for sp in self._trace_ring.values()
                      if sp.trace_id == trace_id and id(sp) not in seen]
            dumps = list(self._trace_dumps.get(trace_id, ()))
        return {"trace_id": trace_id,
                "spans": [sp.to_dict() for sp in spans],
                "flight_dumps": dumps}

    def waterfall(self, rid: int) -> Optional[dict]:
        """Engine-local latency waterfall for one request id (``GET
        /engine/waterfall/<rid>``): the span's phase marks partitioned into
        attributed segments whose sum equals the span wall by construction,
        and the critical path against the pipelined loop's overlapped host
        phases.  None when telemetry is off or the rid aged out."""
        with self._lock:
            pending = self._requests.get(rid)
            span = pending.span if pending is not None else self._trace_ring.get(rid)
        if span is None:
            return None
        t0 = span.events[0][1]
        t_end = span.events[-1][1]
        overlays = waterfall_mod.overlays_from_timeline(
            self.timeline.snapshot(last=128), t0, t_end)
        return waterfall_mod.build_engine_waterfall(span.to_dict(), overlays=overlays)

    # recent archived spans per latency_budget() read
    _BUDGET_SCAN_CAP = 512

    def latency_budget(self) -> dict:
        """Per-class latency-budget samples from the recent span history
        (``GET /engine/latency``): ``{"classes": {...}, "samples": {cls:
        [...]}}``; empty when telemetry is off."""
        if not self.ec.telemetry:
            return {"classes": {}, "samples": {}}
        with self._lock:
            spans = list(self._trace_ring.values())[-self._BUDGET_SCAN_CAP:]
        by_cls: dict = {}
        for span in spans:
            sample = waterfall_mod.span_budget_sample(span.to_dict())
            if sample is None:
                continue
            bucket = by_cls.setdefault(sample.pop("cls"), [])
            bucket.append(sample)
            if len(bucket) > waterfall_mod.BUDGET_SAMPLE_CAP:
                bucket.pop(0)
        return {"classes": waterfall_mod.class_budgets(by_cls), "samples": by_cls}

    def _dominant_segment(self, cls: str) -> Optional[dict]:
        """The segment dominating ``cls``'s recent TTFT budget (manager
        thread, best-effort)."""
        try:
            samples = self.latency_budget()["samples"].get(cls)
            return waterfall_mod.dominant_segment(samples) if samples else None
        except Exception:  # noqa: BLE001 — evidence is best-effort
            return None

    def _note_dump(self, path: Optional[str], trace_ids) -> None:
        """Remember which traces a flight dump concerns."""
        if path is None:
            return
        with self._lock:
            for tid in trace_ids:
                if tid is None:
                    continue
                paths = self._trace_dumps.setdefault(tid, [])
                if path not in paths:
                    paths.append(path)
            while len(self._trace_dumps) > self._TRACE_REF_CAP:
                self._trace_dumps.pop(next(iter(self._trace_dumps)))

    def _slot_trace_ids(self, slots: list) -> list:
        """Trace id per slot (None for unbound rows).  Loop-thread only."""
        out = []
        for sl in slots:
            p = self._requests.get(self._slot_req.get(sl))
            out.append(p.span.trace_id if p is not None and p.span is not None else None)
        return out

    def trace_n_ticks(self, n: int, trace_dir: Optional[str] = None) -> str:
        """Capture a torch.profiler trace (CPU and CUDA activities) of the
        next ``n`` live engine work ticks into ``trace_dir``.  Start/stop run
        on the loop thread at tick boundaries; returns immediately — poll
        ``profiler_active`` for completion.  Raises RuntimeError if a
        capture is already in flight.  ``trace_dir=None`` (the ``POST
        /engine/profile`` path) captures into a MANAGED dir from the
        ProfileStore, capped and removed on ``stop()``."""
        if self._stopped or not self._running:
            # a dead loop never reaches a tick boundary
            raise RuntimeError("engine is not running")
        managed = trace_dir is None
        if managed:
            trace_dir = self.profiles.new_dir()
        rec = self.profiles.begin(trace_dir, n, managed)
        try:
            self._profiler.request(n, trace_dir, ctx=rec)
        except BaseException:
            self.profiles.discard(rec)  # refused: no orphan run record
            raise
        self._wake.set()
        return trace_dir

    def _profile_complete(self, error: Optional[str], rec) -> None:
        """TickProfiler completion hook (loop thread): size the capture's
        artifacts, record its launch calls and lost device records, and
        apply the store's count/byte caps."""
        if rec is not None:
            self.profiles.complete(rec, error=error, launch_calls=self._profiler.launch_calls,
                                   lost_records=self._profiler.lost_records)

    @property
    def profiler_active(self) -> bool:
        return self._profiler.active

    def _sync_device(self) -> None:
        """Wait for every kernel the loop queued on the engine's device."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------ loop

    def _bucket(self, n: int) -> int:
        for b in PREFILL_BUCKETS:
            if n <= b:
                return b
        # past the largest static bucket: round up to the page grid so the
        # single-shot path still covers the whole prompt
        ps = self.ec.page_size
        return -(-n // ps) * ps

    def _pages_for(self, tokens: int) -> int:
        return (tokens + self.ec.page_size - 1) // self.ec.page_size

    def _host(self, arr: np.ndarray) -> torch.Tensor:
        """A host array as a tensor on the engine's device (a blocking copy:
        the sync loop and prefill only)."""
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def _count_prefill(self, rows: int) -> None:
        """One fused prefill dispatch carrying ``rows`` prompt rows."""
        self._prefill_dispatches += 1
        self._prefill_rows_total += rows
        self._prefill_batch_hist[rows] = self._prefill_batch_hist.get(rows, 0) + 1
        self.telemetry.observe_prefill_batch(rows)

    # ------------------------------------------------ perf-ledger charging
    # analytical FLOPs are charged where the dispatch OUTCOME is known,
    # attributed goodput or waste in the same call: goodput + waste ==
    # dispatched is the ledger's construction, not a reconciliation

    def _charge_prefill_rows(self, slots: list, lens, off: int, ok,
                             finishing=None) -> None:
        """One fused prefill dispatch: each row charged at its REAL
        position count this chunk (padding lanes are machine work, not
        requested work).  A row whose request carries a waste_reason lands
        under that reason; a NaN-guarded FINISHING row's work -> tick_retry."""
        C = self.ec.prefill_chunk
        for i, slot in enumerate(slots):
            pending = self._requests.get(self._slot_req.get(slot))
            if pending is None:
                continue
            toks = max(0, min(C, int(lens[i]) - off))
            if toks <= 0:
                continue
            bad = (ok is not None and not ok[i]
                   and (finishing is None or i in finishing))
            self.perf.charge("prefill", self._fm.prefill_row(toks, off), toks,
                             "tick_retry" if bad else pending.waste_reason)

    def _charge_dropped(self, rec: dict, reason: str) -> None:
        """A pipelined tick whose results are discarded wholesale (watchdog
        restart / stop): its dispatched FLOPs were real device work that
        produced nothing — waste under ``reason``."""
        kind = "verify" if rec.get("kind") == "spec" else "decode"
        for f in (rec.get("flops") or {}).values():
            f, k = f if isinstance(f, tuple) else (f, 1)
            self.perf.charge(kind, f, k, reason)

    def _loop(self, epoch: int) -> None:
        """The engine loop of epoch ``epoch``: the watchdog bumps
        ``self._epoch`` before reviving a dead or hung loop, so a stale
        thread that wakes up exits without touching engine state."""
        self._tls.epoch = epoch
        # inference_mode is thread-local: every loop thread (a restarted one
        # too) enters it itself
        with torch.inference_mode():
            while self._running and self._epoch == epoch:
                if self._chaos is not None:
                    # may sleep (slow tick) or raise ChaosThreadDeath — a
                    # BaseException no isolation boundary below can swallow;
                    # it ends this thread for the watchdog to find
                    try:
                        self._chaos.on_tick()
                    except BaseException:
                        return  # thread dies; state stays as-is, like a crash
                    if self._epoch != epoch:
                        return  # superseded while we were stalled
                obs = self.ec.telemetry
                overrun_s = (self.ec.incident_tick_overrun_s
                             if self.incidents is not None else 0.0)
                tick_t0 = time.perf_counter() if (obs or overrun_s > 0) else 0.0
                self._ticks += 1
                self._last_tick_ts = time.monotonic()
                self._profiler.on_tick_start(self._ticks)
                did_work = False
                try:
                    did_work = self._tick()
                except _StaleThread:
                    return  # superseded after a hang: exit without a trace
                except Exception as exc:  # noqa: BLE001 — loop must survive
                    # backstop for host-side faults escaping the per-phase
                    # isolation boundaries
                    try:
                        self._note_group_failure(list(self._slot_req), "tick", exc)
                    except _StaleThread:
                        return
                    if obs:
                        self.telemetry.observe_tick(time.perf_counter() - tick_t0)
                    time.sleep(0.005)
                    continue
                finally:
                    # work ticks only: the capture window must not be
                    # consumed by idle waits (a failed tick dispatched)
                    self._profiler.on_tick_end(self._ticks,
                                               did_work or bool(self._slot_req))
                if obs and did_work:
                    # work ticks only: idle 20ms waits would swamp it
                    self.telemetry.observe_tick(time.perf_counter() - tick_t0)
                if overrun_s > 0 and did_work:
                    dur = time.perf_counter() - tick_t0
                    if dur > overrun_s:
                        self._incident_event(
                            "tick_overrun", duration_s=round(dur, 4),
                            threshold_s=overrun_s,
                            trace_ids=self._slot_trace_ids(list(self._slot_req)))
                if not did_work:
                    self._wake.wait(timeout=0.02)
                    self._wake.clear()

    def _tick(self) -> bool:
        """One engine tick: reap expired, admit (policy order, preempting
        when a higher class is blocked), prefill groups, decode.  Each
        compute phase runs inside its own isolation boundary (_isolated)."""
        self._check_epoch()
        # per-tick phase timeline (perf.py): admit covers reap + leftover
        # drain + chaos/pool preemption + scheduler admission; the dispatch
        # segments cover the device calls (the pipelined paths add
        # readback/commit_behind/drain sub-segments from inside)
        tl = self.timeline if self._perf_on else None
        tp = time.perf_counter()
        # eager queue reaping: deadline-expired queued requests shed NOW,
        # not when they reach the admission head
        did_work = self._reap_expired_queue(tp)
        # C++-queued leftovers (an admit that failed after its submit last
        # tick — rare; the scheduler queue is the real queue)
        while True:
            admitted = self.batcher.admit()
            if admitted is None:
                break
            did_work = True
            self._install_admitted(admitted)

        # chaos: forced preemption storms (faults.py)
        if self._chaos is not None and self._chaos.should_preempt():
            victim = self._pick_victim(max_rank=-1)
            if victim is not None:
                did_work = True
                self._preempt_slot(victim, "chaos")

        # pool-pressure relief: below the free-page watermark, evict a
        # strictly lower-priority decode slot before decode growth
        # OOM-truncates a higher-priority one (off unless min_free_pages)
        if self._scfg.preemption and self._scfg.min_free_pages > 0:
            free = self.batcher.free_pages + self.batcher.reclaimable()
            if free < self._scfg.min_free_pages:
                ranks = [self._requests[r].rank
                         for s, r in self._slot_req.items()
                         if s not in self._prefilling and r in self._requests]
                if len(ranks) > 1:
                    victim = self._pick_victim(max_rank=min(ranks))
                    if victim is not None:
                        did_work = True
                        self._preempt_slot(victim, "pool")

        did_work |= self._admit_from_scheduler()
        if tl is not None and (did_work or self._prefilling):
            t = time.perf_counter()
            tl.note(self._ticks, "admit", t - tp)
            tp = t

        shorts: dict[int, list] = {}
        chunked: dict[int, list] = {}
        for slot in list(self._prefilling):
            did_work = True
            pending = self._requests.get(self._slot_req.get(slot))
            if pending is None:  # failed out from under us: reclaim
                self._fail_slot(slot, TickFailure("orphaned prefill slot"))
                continue
            if pending.cancelled:
                # mid-prefill cancel: pool pages are partially written —
                # free them WITHOUT caching
                del self._prefilling[slot]
                self._finish(slot, self._slot_req[slot], truncated=False,
                             cancelled=True, cache_ok=False)
                continue
            if (pending.deadline is not None and not pending.first_token_at
                    and time.perf_counter() > pending.deadline):
                # also covers a chunked prefill whose deadline lapsed
                # mid-prompt; past the first token a request runs to the end
                self._fail_slot(slot, DeadlineExceeded(
                    "deadline expired before first token"), shed=True)
                continue
            off = self._prefilling[slot]
            plen = len(pending.tokens)
            if off == 0 and plen <= self.ec.prefill_chunk:
                shorts.setdefault(self._bucket(plen), []).append(slot)
            else:
                chunked.setdefault(off, []).append(slot)
        for bucket in sorted(shorts):
            self._isolated("prefill", shorts[bucket],
                           self._prefill_short_group, shorts[bucket], bucket,
                           shape={"rows": len(shorts[bucket]), "bucket": bucket})
        for off in sorted(chunked):
            self._isolated("prefill_chunk", chunked[off],
                           self._prefill_chunk_group, chunked[off], off,
                           shape={"rows": len(chunked[off]), "offset": off,
                                  "chunk": self.ec.prefill_chunk})
        if tl is not None and (shorts or chunked):
            t = time.perf_counter()
            tl.note(self._ticks, "prefill_dispatch", t - tp)
            tp = t

        decode_ready = [s for s in self._slot_req if s not in self._prefilling]
        for slot in list(decode_ready):
            pending = self._requests.get(self._slot_req.get(slot))
            if pending is None:
                did_work = True
                decode_ready.remove(slot)
                self._fail_slot(slot, TickFailure("orphaned decode slot"))
            elif pending.cancelled:
                did_work = True
                decode_ready.remove(slot)
                # prompt KV is complete: its pages are safe to cache
                self._finish(slot, self._slot_req[slot], truncated=False,
                             cancelled=True)
        if decode_ready:
            did_work = True
            # structured output: a grammar mask is valid only against the
            # automaton state AFTER the last committed token, so a
            # constrained tick never dispatches over an uncommitted
            # in-flight token.  Fence first (the "constrain" fence), then
            # build this tick's mask; the drain's commits may finish or fail
            # rows, and a detected stall fails its slot here
            gmask = None
            if any(self._constraint_for(s) is not None for s in decode_ready):
                if self._inflight is not None:
                    self._drain_pipeline("constrain")
                    decode_ready = self._ready_now()
                if decode_ready:
                    decode_ready, gmask = self._build_grammar_masks(decode_ready)
                if not decode_ready:
                    return did_work
            constrained = gmask is not None
            if self._pipe_depth > 0 and not (constrained and self._spec is not None):
                if self._spec is not None:
                    self._isolated("verify", decode_ready,
                                   self._decode_tick_spec_pipelined, decode_ready,
                                   shape={"rows": len(decode_ready),
                                          "speculative": True, "pipelined": True,
                                          "k": self._k})
                else:
                    self._isolated("decode", decode_ready,
                                   self._decode_tick_pipelined, decode_ready, gmask,
                                   shape={"rows": len(decode_ready),
                                          "pipelined": True, "constrained": constrained})
            else:
                # the sync loop; and a constrained speculative tick at EVERY
                # depth: its verify mask composes with this tick's drafts
                # (position j assumes drafts 0..j-1 accepted), which only
                # the sync draft walk has in hand before the dispatch
                drafts = ({slot: self._draft_for(slot, int(self._len_host[slot]))
                           for slot in decode_ready} if self._spec else {})
                if any(drafts.values()):
                    self._isolated("decode", decode_ready,
                                   self._decode_tick_speculative, decode_ready,
                                   drafts, gmask,
                                   shape={"rows": len(decode_ready),
                                          "speculative": True,
                                          "constrained": constrained, "k": self._k})
                else:
                    self._isolated("decode", decode_ready,
                                   self._decode_tick_single, decode_ready, gmask,
                                   shape={"rows": len(decode_ready),
                                          "constrained": constrained})
            if tl is not None:
                tl.note(self._ticks, "decode_dispatch", time.perf_counter() - tp)
        elif self._inflight is not None:
            # every row finished at commit-behind: retire the in-flight
            # tick (its tokens belong to already-resolved requests)
            did_work = True
            self._drain_pipeline("idle")
        return did_work

    # ------------------------------------------- QoS admission / preemption

    def _install_admitted(self, admitted) -> None:
        """Bind one C++ admission to its request, then route it to
        swap-resume (restore KV, straight to decode) or to prefill past the
        cached prefix, extended by the session's pinned pages on a
        session's first admission."""
        slot, rid, plen, _, cached = admitted
        # fetch + slot binding are one atomic step vs cancel(): once
        # _slot_req holds rid, cancel defers to this loop
        with self._lock:
            pending = self._requests.get(rid)
            if pending is not None:
                self._slot_req[slot] = rid
                self._aid_host[slot] = pending.adapter_id
        if pending is None:
            # resolved while queued (cancel, stop): release the slot untouched
            self.batcher.release(slot)
            self._kv.discard_swap(rid)
            return
        if pending.span is not None:
            now = pending.span.mark(
                "admitted" if not pending.preemptions else "readmitted")
            if not pending.preemptions:
                self.telemetry.observe_queue_wait(now - pending.submitted_at,
                                                  pending.priority)
        if pending.cancelled:  # cancelled between submit and admit
            self._kv.discard_swap(rid)
            self._finish(slot, rid, truncated=False, cancelled=True,
                         cache_ok=False)
            return
        if pending.constrain_snap is not None:
            # preempt-resume: restore the automaton byte-exact from its
            # preemption snapshot BEFORE any first-token mask is built —
            # swap-resume and drop-recompute both sample their next token
            # from exactly this state
            pending.constrain.restore(pending.constrain_snap)
            pending.constrain_snap = None
        if (pending.deadline is not None and not pending.first_token_at
                and time.perf_counter() > pending.deadline):
            # expired while queued: shed before spending any prefill (never
            # after the first token — a preempted request always resumes)
            self._fail_slot(slot, DeadlineExceeded(
                "deadline expired after "
                f"{time.perf_counter() - pending.submitted_at:.3f}s in queue"),
                shed=True)
            return
        if self._perf_on and not pending.swapped:
            # cache analytics: admission is the one point where requested
            # vs granted prefix-cache pages are both known; reuse keys on
            # the deepest matched chain hash
            n_lookup = min(max(0, (plen - 1) // self.ec.page_size),
                           len(pending.page_hashes))
            if n_lookup > 0:
                key = int(pending.page_hashes[cached - 1]) if cached > 0 else None
                self.cache_analytics.note_lookup(n_lookup, cached, key)
                self.telemetry.count_cache_pages(n_lookup, min(cached, n_lookup))
        if pending.swapped:
            item = self._kv.pop_swap(rid, count=not pending.handoff_import)
            if item is not None:
                try:
                    self._resume_swapped(slot, pending, item)
                    return
                except _StaleThread:
                    raise
                except Exception as exc:  # noqa: BLE001 — fail this slot only
                    if not pending.handoff_import:
                        # never leave the slot half-installed for decode
                        err = TickFailure(f"swap-in failed: {type(exc).__name__}: {exc}")
                        err.__cause__ = exc
                        self._fail_slot(slot, err)
                        return
                    # a verified handoff frame that failed the scatter:
                    # re-prefill below (the slot owns its pages, and the
                    # prefill overwrites whatever the scatter touched)
                    pending.swapped = False
                    self._degrade_handoff(pending, "scatter_failed")
                    if self.ec.telemetry:
                        self._flight_event("handoff_import", [slot], None,
                                           time.perf_counter(), "error",
                                           error=f"{type(exc).__name__}: {exc}")
            else:
                # blob lost (failed verification after a spill): recompute —
                # tokens already hold the full context, a cold re-prefill of
                # positions this engine (or the prefill replica) computed
                pending.swapped = False
                if pending.handoff_import:
                    self._degrade_handoff(pending, "blob_lost")
                else:
                    pending.waste_reason = "preempt_recompute"
        off = cached * self.ec.page_size
        if pending.session_id is not None and pending.session_restore is None:
            off = self._restore_session(slot, pending, cached)
        if pending.fabric_import is not None:
            # scatter the verified remote prefix pages that the device cache
            # and the session restore did not already cover
            off = max(off, self._restore_fabric(slot, pending, off // self.ec.page_size))
        self._prefilling[slot] = off
        self._prefill_rows[slot] = self.batcher.slot_pages(slot)

    def _pack(self, key: str, blob, meta: dict) -> tuple:
        """A handoff or fabric blob as its wire frame -> ``(data, nbytes)``:
        version 1 at TP=1; at TP>1 the sharded version-2 frame (a CRC per
        shard's sub-frame) with the degree in ``meta["tp"]``, so the
        importer can check the layout."""
        if self._mesh is None:
            data, nbytes, _ = pack_frame(key, blob, meta)
        else:
            meta["tp"] = self._tp
            data, nbytes, _ = pack_sharded_frame(key, blob, meta)
        return data, nbytes

    def _snapshot_pages(self, pages: np.ndarray) -> tuple:
        """Host snapshot of the pools' ``pages`` -> ``(blob, nbytes)``, the
        one device -> host primitive behind swap, session pin, handoff
        export and fabric publish, in the JAX engine's blob layout.  TP=1:
        a ``(k, v)`` tuple whose parts are numpy ``[layers, n, Hkv, page,
        hd]`` slabs (bf16 as raw bits) or the int8 pool's ``{"q", "s"}``
        dicts.  TP>1: a per-shard LIST of such ``(k, v)`` pytrees in
        KV-head order, each read from its own shard's pool, so no
        pool-sized gathered buffer ever exists (counted in
        ``engine_kv_shard_bytes_total{direction="export"}``).  A blocking
        copy; the callers run after the pipeline fence."""
        if self._mesh is None:
            idx = torch.from_numpy(np.asarray(pages, np.int64)).to(self.device)
            fetch = lambda leaf: leaf_to_host(leaf[:, idx])  # noqa: E731
            blob = (_pool_map(fetch, self.k_pool), _pool_map(fetch, self.v_pool))
            return blob, sum(a.nbytes for a in _blob_leaves(blob))
        k_blocks = _pool_map(lambda *shards: snapshot_shards(shards, pages), *self.k_pool)
        v_blocks = _pool_map(lambda *shards: snapshot_shards(shards, pages), *self.v_pool)
        blob = [(_pool_map(lambda b: b[i], k_blocks), _pool_map(lambda b: b[i], v_blocks))
                for i in range(self._tp)]
        nbytes = sum(a.nbytes for a in _blob_leaves(blob))
        self.telemetry.count_kv_shard_bytes("export", nbytes)
        return blob, nbytes

    def _scatter_pages(self, pages: np.ndarray, blob, lo: int, hi: int) -> None:
        """Write a host KV blob's page range ``[lo, hi)`` into the pools at
        device ``pages``, in place — the one host -> device primitive
        behind every restore.  A blob whose mesh degree matches this
        engine's scatters shard to shard; a mismatched degree is resharded
        on the host first, the EXPLICIT slow path counted under
        ``engine_kv_reshard_total{outcome="reshard"}`` (``match`` for a
        sharded blob at this degree), never silent garbage.  Enqueued on
        the loop's stream, so it lands after any tick already dispatched."""
        tp = self._tp
        if blob_degree(blob) != tp:
            blob = reshard_blob(blob, tp)
            self.telemetry.count_reshard("reshard")
        elif tp > 1:
            self.telemetry.count_reshard("match")
        if tp == 1:
            if isinstance(blob, list):  # a degree-1 shard list: unwrap
                blob = blob[0]
            idx = torch.from_numpy(np.asarray(pages, np.int64)).to(self.device)

            def put(leaf, host):
                leaf[:, idx] = leaf_to_tensor(host[:, lo:hi], self.device)

            _pool_map(put, self.k_pool, blob[0])
            _pool_map(put, self.v_pool, blob[1])
            return
        nbytes = 0
        for part, pools in ((0, self.k_pool), (1, self.v_pool)):
            hosts = [shard[part] for shard in blob]

            def put(*args):
                nonlocal nbytes
                leaves, blocks = args[:tp], [b[:, lo:hi] for b in args[tp:]]
                nbytes += sum(b.nbytes for b in blocks)
                scatter_shards(leaves, pages, blocks)

            _pool_map(put, *pools, *hosts)
        self.telemetry.count_kv_shard_bytes("restore", nbytes)

    def _restore_session(self, slot: int, pending: _Pending, cached: int) -> int:
        """Session-turn prefix restore: fetch the session's pinned KV pages
        from the tiered store (verified there), match the stored chain
        hashes against this prompt's, and scatter the pages the device
        prefix cache did NOT already cover into the slot's freshly
        allocated row.  Returns the prefill offset (tokens covered).

        Degrades, never fails: a miss, a verification failure, a prompt
        that does not extend the pinned context, or any error here falls
        back to the plain prefix-cache offset.  ``pending.session_restore``
        records the outcome for the result dict."""
        ps = self.ec.page_size
        t0 = time.perf_counter()
        try:
            outcome, payload = self._kv.restore_session(pending.session_id)
            if payload is None:
                pending.session_restore = "degraded" if outcome == "corrupt" else "cold"
                self.telemetry.count_session_restore(pending.session_restore)
                if pending.session_restore == "degraded":
                    # the store HAD the session but verification failed:
                    # the storage-fault signal; a plain miss is not one
                    self._note_degradation("storage", outcome, pending)
                return cached * ps
            blob, nbytes, meta = payload
            usable = self._matched_pages(pending, np.asarray(meta.get("hashes", ()), np.uint64))
            if usable <= cached:
                # the device cache covers everything the store could offer
                # (or the prompt diverged from the pinned context before it)
                pending.session_restore = "cache" if cached > 0 else "cold"
                self.telemetry.count_session_restore(pending.session_restore)
                return cached * ps
            row = self.batcher.slot_pages(slot)
            self._check_epoch()  # last fence before writing the pools
            self._scatter_pages(row[cached:usable], blob, cached, usable)
            pending.session_restore = outcome  # "host" | "disk"
            self.telemetry.count_session_restore(outcome)
            self._restored_pages += usable - cached
            self._restored_bytes += sum(a[:, cached:usable].nbytes for a in _blob_leaves(blob))
            if pending.span is not None:
                pending.span.mark("session_restore")
            if self.ec.telemetry:
                self._flight_event(
                    "session_restore", [slot],
                    {"tier": outcome, "pages": int(usable - cached),
                     "cached": cached, "bytes": nbytes}, t0, "ok")
            return usable * ps
        except _StaleThread:
            raise
        except Exception as exc:  # noqa: BLE001 — restore must degrade
            pending.session_restore = "degraded"
            self.telemetry.count_session_restore("degraded")
            self._note_degradation("storage", "restore_error", pending)
            if self.ec.telemetry:
                self._flight_event("session_restore", [slot], None, t0, "error",
                                   error=f"{type(exc).__name__}: {exc}")
            return cached * ps

    def _matched_pages(self, pending: _Pending, hashes: np.ndarray) -> int:
        """How many of the prompt's full pages, from page 0, carry the chain
        hashes ``hashes`` lists: the pages a stored KV image may restore.
        At least ONE prompt position stays uncovered, so prefill computes
        the logits of the first sampled token."""
        own = pending.page_hashes
        limit = min(len(hashes), len(own),
                    max(0, (len(pending.tokens) - 1) // self.ec.page_size))
        usable = 0
        while usable < limit and own[usable] == hashes[usable]:
            usable += 1
        return usable

    def _restore_fabric(self, slot: int, pending: _Pending, covered: int) -> int:
        """Fleet-fabric prefix fault-in: match the pulled frame's chain
        hashes against this prompt's, scatter the verified pages past what
        the device cache (and any session restore) already ``covered`` into
        the slot's freshly owned pages, and return the prefill offset in
        tokens.

        Degrades, never fails: a hash mismatch from page 0 (the router's
        text fingerprints are a heuristic; THIS check is the correctness
        gate) or any scatter error falls back to the plain offset, the
        recomputed prefix attributed ``fabric_degraded``; a frame the local
        state already covers is a no-op ("local").
        ``pending.fabric_restore`` records the outcome."""
        ps = self.ec.page_size
        blob, fhashes, nbytes = pending.fabric_import
        pending.fabric_import = None  # freed either way: frames are MBs
        t0 = time.perf_counter()
        try:
            usable = self._matched_pages(pending, fhashes)
            if usable == 0:
                # the frame shares nothing with this prompt: the pull was
                # wasted and the whole prefix recomputes locally
                self._degrade_fabric(pending, "hash_mismatch")
                return covered * ps
            if usable <= covered:
                # local state reaches at least as deep: nothing to scatter,
                # nothing recomputed — not a degrade
                pending.fabric_restore = "local"
                self.telemetry.count_fabric("local")
                return covered * ps
            row = self.batcher.slot_pages(slot)
            self._check_epoch()  # last fence before writing the pools
            self._scatter_pages(row[covered:usable], blob, covered, usable)
            pending.fabric_restore = "hit"
            self.telemetry.count_fabric("hit")
            if pending.span is not None:
                pending.span.mark("fabric_restore")
            if self.ec.telemetry:
                self._flight_event(
                    "fabric_restore", [slot],
                    {"pages": int(usable - covered), "covered": covered,
                     "bytes": nbytes}, t0, "ok")
            return usable * ps
        except _StaleThread:
            raise
        except Exception as exc:  # noqa: BLE001 — a restore must degrade
            self._degrade_fabric(pending, "restore_error")
            if self.ec.telemetry:
                self._flight_event("fabric_restore", [slot], None, t0, "error",
                                   error=f"{type(exc).__name__}: {exc}")
            return covered * ps

    def _degrade_fabric(self, pending: _Pending, outcome: str) -> None:
        """A fabric import failed: the prefix recomputes locally, attributed
        ``fabric_degraded`` unless the prefill already carries a reason."""
        pending.fabric_restore = "degraded"
        pending.waste_reason = pending.waste_reason or "fabric_degraded"
        self.telemetry.count_fabric("degraded")
        self._note_degradation("fabric", outcome, pending)

    def _degrade_handoff(self, pending: _Pending, outcome: str) -> None:
        """A handoff import failed: the request re-prefills the prefill
        replica's work, attributed as waste."""
        pending.waste_reason = "handoff_degraded"
        self.telemetry.count_handoff("degraded")
        self._note_degradation("handoff", outcome, pending)

    def _resume_swapped(self, slot: int, pending: _Pending, item) -> None:
        """Swap-in: scatter the evicted KV pages from the store into the
        slot's freshly allocated pages and rebind the host mirrors — the
        slot rejoins decode exactly where it left off (seq_len, page row,
        last committed token), byte-identical under greedy.  A handoff
        import (the decode phase) takes the same path with no generated
        token yet: its feedback token is the prompt's last, which IS the
        prefill phase's first sampled token."""
        t0 = time.perf_counter()
        blob, nbytes = item
        L = pending.resume_len
        owned = self._pages_for(L)
        # a handoff frame may run ONE page short of owned: a prompt that
        # ended exactly on a page boundary got no next page from its
        # finishing commit, so the export could not include it.  Position
        # L-1's KV is written by the first decode step before anything
        # reads it.
        cov = min(owned, int(_blob_leaves(blob)[0].shape[1]))
        # swap submits carry no prefix hashes, so every page here is freshly
        # owned by this slot: the scatter never writes a shared cache page
        row = self.batcher.slot_pages(slot)
        self._check_epoch()  # last fence before writing the pools
        self._scatter_pages(row[:cov], blob, 0, cov)
        pending.swapped = False
        if pending.handoff_import:
            if pending.span is not None:
                pending.span.mark("handoff_import")
            if self.ec.telemetry:
                self._flight_event("handoff_import", [slot],
                                   {"pages": cov, "bytes": nbytes}, t0, "ok")
        else:
            self.telemetry.count_swap("in", nbytes)
            if pending.span is not None:
                pending.span.mark("resumed")
            if self.ec.telemetry:
                self._flight_event("swap_in", [slot], {"pages": cov, "bytes": nbytes},
                                   t0, "ok")
        self._activate_decode(slot, L, owned, row)
        self._tok_host[slot] = (pending.generated[-1] if pending.generated
                                else pending.tokens[-1])
        if not pending.handoff_import:
            self._swap_in_s += time.perf_counter() - t0

    def _reap_expired_queue(self, now: float) -> bool:
        """Shed every queued request whose deadline lapsed — every tick,
        not at the admission head.  Preempted requests (first token already
        out) are never shed; they resume."""
        did = False
        for entry in self._sched.expired(now):
            with self._lock:
                pending = self._requests.get(entry.rid)
                if pending is None:
                    self._sched.remove(entry.rid)
                    continue
                if pending.first_token_at or pending.cancelled:
                    continue  # resumes / resolves via its own path
                self._requests.pop(entry.rid)
            self._sched.remove(entry.rid)
            self._kv.discard_swap(entry.rid)
            self._sched.reaped += 1
            self._requests_shed += 1
            did = True
            self._retire(pending, "shed")
            self._resolve_exception(pending, DeadlineExceeded(
                "deadline expired after "
                f"{now - pending.submitted_at:.3f}s in queue (reaped)"))
        return did

    def _admit_from_scheduler(self) -> bool:
        """Drain the host scheduler queue in policy order: submit-then-admit
        one request at a time while slots and pages allow; when the head is
        blocked, preempt a strictly lower-priority decode slot (at most
        max_preemptions_per_tick) and retry — otherwise stop (strict
        priority: never bypass a blocked head for a lower class)."""
        did = False
        budget = self._scfg.max_preemptions_per_tick if self._scfg.preemption else 0
        while True:
            entry = self._sched.peek()
            if entry is None:
                break
            rid = entry.rid
            pending = self._requests.get(rid)
            if pending is None:
                self._sched.remove(rid)  # resolved out from under the queue
                continue
            if pending.cancelled:
                # a queued cancel that landed after a preempt re-queue
                if self._resolve_queued_cancel(rid, pending):
                    did = True
                else:
                    self._sched.remove(rid)
                continue
            plen = len(pending.tokens)
            need = self._pages_for(plen)
            have_slot = self.batcher.free_slots > 0
            # min_free_pages doubles as an ADMISSION reserve: a slot evicted
            # for pool pressure is not readmitted while the pool is still
            # below the watermark (that would thrash a swap every tick)
            have_pages = (self.batcher.free_pages + self.batcher.reclaimable()
                          >= need + self._scfg.min_free_pages)
            if not (have_slot and have_pages):
                if budget > 0:
                    victim = self._pick_victim(max_rank=entry.rank)
                    if victim is not None:
                        budget -= 1
                        did = True
                        self._preempt_slot(victim, "pages" if have_slot else "priority")
                        continue  # re-evaluate the head with freed capacity
                break
            self._sched.pop(entry)
            did = True
            mnew = max(1, pending.max_new_tokens - len(pending.generated))
            lookup = None
            if not pending.swapped:
                # lookup eligibility stops one page short of the prompt
                # end: prefill must compute at least the final token
                lookup = pending.page_hashes[:(plen - 1) // self.ec.page_size]
            if not self.batcher.submit(rid, plen, mnew, lookup):
                # defensive: capacity was validated at generate_async
                with self._lock:
                    self._requests.pop(rid, None)
                self._kv.discard_swap(rid)
                self._requests_failed += 1
                self._retire(pending, "failed")
                self._resolve_exception(pending, RequestError(
                    f"prompt+generation ({plen}+{mnew}) exceeds engine capacity"))
                continue
            admitted = self.batcher.admit()
            if admitted is None:
                break  # stays at the C++ queue head; drained next tick
            self._install_admitted(admitted)
        return did

    def _pick_victim(self, max_rank: int) -> Optional[int]:
        """The decode-ready slot to preempt: rank strictly greater than
        ``max_rank`` (-1 = any), preferring the lowest class, then the
        latest deadline (none = latest), then the most recent submission.
        None when no eligible victim exists — equals never preempt
        equals."""
        best, best_key = None, None
        for slot, rid in self._slot_req.items():
            if slot in self._prefilling:
                continue  # mid-prefill KV is incomplete; not preemptible
            p = self._requests.get(rid)
            if p is None or p.cancelled or p.rank <= max_rank:
                continue
            key = (p.rank, p.deadline if p.deadline is not None else float("inf"),
                   p.submitted_at)
            if best_key is None or key > best_key:
                best, best_key = slot, key
        return best

    def _preempt_slot(self, slot: int, reason: str) -> None:
        """Evict one decoding slot: its KV pages are swapped to the store
        (restored byte-identically on resume) or dropped into the prefix
        cache (the re-prefill usually re-adopts the very same pages); the
        slot and pages free, and the request re-queues with its class,
        deadline and original submit time.  ``reason`` is what made room
        necessary (priority | pages | pool)."""
        # pipeline fence BEFORE reading the victim's mirrors: the in-flight
        # tick's commit lands first, so the snapshot captures every
        # committed token, and no dispatched tick still writes the pages.
        # The drain may finish or fail the victim — re-validate below.
        self._check_epoch()
        self._drain_pipeline("preempt")
        rid = self._slot_req.get(slot)
        pending = self._requests.get(rid) if rid is not None else None
        if pending is None:
            return
        if pending.cancelled:  # cancel raced the eviction: just finish it
            self._finish(slot, rid, truncated=False, cancelled=True)
            return
        ps = self.ec.page_size
        L = int(self._len_host[slot])
        # committed KV covers positions [0, L-2] (the last token's KV is
        # written by its NEXT decode step); pages_for(L) bounds the pages
        # that hold it — a lookahead page past that frees with the slot
        owned = self._pages_for(L)
        mode = self._scfg.swap_policy
        if mode == "auto":
            mode = "swap" if L >= self._scfg.swap_min_tokens else "recompute"
        t0 = time.perf_counter()
        nbytes = 0
        if mode == "swap" and owned > 0:
            blob, nbytes = self._snapshot_pages(self._pt_host[slot, :owned])
            if self._kv.put_swap(rid, blob, nbytes):
                self._swap_out_s += time.perf_counter() - t0
                self.telemetry.count_swap("out", nbytes)
            else:
                mode, nbytes = "recompute", 0  # over budget: drop instead
        release_hashes = None
        pending.tokens = list(pending.context)
        if mode == "swap":
            pending.swapped = True
            pending.resume_len = L
        else:
            # drop-and-recompute: the resume prompt is the full committed
            # context; its completed full pages go to the prefix cache
            pending.swapped = False
            pending.page_hashes = _page_hashes(pending.context, ps, pending.adapter_id)
            release_hashes = pending.page_hashes[:max(0, (L - 1) // ps)]
            # the resume re-prefill recomputes positions this engine already
            # computed once: waste, attributed (the cache-hit share is never
            # dispatched, so only the recomputed positions are charged)
            pending.waste_reason = "preempt_recompute"
        if pending.constrain is not None:
            # the automaton rides the slot like its KV: the "preempt" drain
            # above landed every committed token's advance, so the snapshot
            # covers the whole committed generation
            pending.constrain_snap = pending.constrain.snapshot()
        pending.preemptions += 1
        self._preemptions += 1
        self._preempt_modes[mode] += 1
        self._preempt_reasons[reason] = self._preempt_reasons.get(reason, 0) + 1
        self._reset_failures(pending)
        # the requeue gap is queue wait, not decode speed: the first
        # post-resume commit must not record the pause as one TPOT
        pending.last_token_at = 0.0
        if pending.span is not None:
            pending.span.mark("preempted")
        self.telemetry.count_preemption(reason, mode)
        if self.ec.telemetry:
            self._flight_event("preempt", [slot],
                               {"reason": reason, "mode": mode, "pages": owned,
                                "bytes": nbytes, "seq_len": L}, t0, "ok")
        with self._lock:
            self._slot_req.pop(slot, None)
        self._release_slot_state(slot)
        self.batcher.release(slot, release_hashes)
        self._sched.push(self._entry_for(rid, pending))
        if pending.cancelled:
            # cancel() landed during the swap-out window (it saw the slot
            # still bound and deferred to us): resolve NOW
            self._resolve_queued_cancel(rid, pending)

    def _isolated(self, phase: str, slots: list, fn, *args,  # graftlint: hot-path
                  shape: Optional[dict] = None) -> bool:
        """Isolation boundary around one tick phase: an exception fails only
        ``slots``, and only after ``max_consecutive_failures`` in a row — a
        transient fault retries in place next tick (a failed dispatch
        committed nothing, so greedy decode re-produces the same tokens).
        ChaosThreadDeath and _StaleThread (BaseExceptions) pass through.

        Every guarded dispatch also leaves a flight-recorder event (tick,
        phase, slot set, dispatch shape, duration, outcome), and its wall
        accumulates onto each participant's span (the waterfall's carve)."""
        obs = self.ec.telemetry
        t0 = time.perf_counter() if obs else 0.0
        try:
            if self._chaos is not None:
                self._chaos.maybe_dispatch_error(phase)
            fn(*args)
            if obs:
                self._flight_event(phase, slots, shape, t0, "ok")
                dur = time.perf_counter() - t0
                for sl in slots:
                    p = self._requests.get(self._slot_req.get(sl))
                    if p is not None and p.span is not None:
                        p.span.hint(phase, dur)
            return True
        except Exception as exc:  # noqa: BLE001 — the boundary's whole job
            if obs:
                self._flight_event(phase, slots, shape, t0, "error",
                                   error=f"{type(exc).__name__}: {exc}")
            self._note_group_failure(slots, phase, exc)
            return False

    def _flight_event(self, phase: str, slots: list, shape: Optional[dict],
                      t0: float, outcome: str, **extra) -> None:
        # tick events carry both correlation keys: request ids for
        # engine-local digging, trace ids for fleet-wide trace assembly
        self.flight.record(
            tick=self._ticks, phase=phase, slots=list(slots),
            rids=[self._slot_req.get(sl) for sl in slots],
            trace_ids=self._slot_trace_ids(slots),
            shape=shape, duration_s=round(time.perf_counter() - t0, 6),
            outcome=outcome, **extra)

    def _guard_logits(self, logits, row_rids, phase: str = "decode"):
        """Chaos NaN injection + the sample-path logit guard.  ``row_rids``:
        request id per leading logits row (-1 = inactive).  Returns
        (logits, ok) where ok is a device [B]-bool — True iff every logit of
        that row (all K verify rows of a [B, K, V] pass) is finite — or None
        when the guard is disabled."""
        if self._chaos is not None:
            rows = self._chaos.nan_rows(row_rids, phase)
            if rows:
                logits = logits.clone()
                logits[torch.tensor(rows, device=logits.device)] = float("nan")
        if not self.ec.logit_guard:
            return logits, None
        return logits, torch.isfinite(logits).reshape(logits.shape[0], -1).all(dim=1)

    def _poison(self, phase: str = "decode"):
        """The fused dispatches' chaos poison mask: a [max_slots] bool on the
        device, or None when no row is poisoned this tick."""
        if self._chaos is None:
            return None
        rows = self._chaos.nan_rows(self._row_rids(), phase)
        if not rows:
            return None
        mask = np.zeros((self.ec.max_slots,), bool)
        mask[rows] = True
        return torch.from_numpy(mask).to(self.device)

    def _model_kw(self, aids: np.ndarray) -> dict:
        """The keyword arguments of a prefill or decode call: the tensor
        mesh, and the adapter table with the rows' adapter ids on the
        device on an engine with adapters."""
        if self._lora is None:
            return {"mesh": self._mesh}
        return {"mesh": self._mesh, "lora_params": self._lora,
                "adapter_ids": self._host(aids)}

    def _sample(self, logits, ok_dev, mask: Optional[np.ndarray] = None):
        """One host transfer of the sampled tokens (and the guard).  A
        grammar ``mask`` ([rows, V] bool) sets illegal logits to the finite
        -1e30 AFTER the guard has read the raw logits, so a poisoned row
        still trips the guard."""
        if mask is not None:
            logits = torch.where(self._host(mask), logits, -1e30)
        sampled = sample_tokens(logits, self._gen, self.ec.temperature)
        if ok_dev is None:
            return sampled.cpu().numpy(), None
        both = torch.stack([sampled, ok_dev.to(torch.int32)]).cpu().numpy()
        return both[0], both[1].astype(bool)

    def _prefill_short_group(self, slots: list, bucket: int) -> None:
        """ONE dispatch for every same-bucket short prompt: a [B, bucket]
        prefill, one write_pages scatter of all rows' owned pages (unowned
        tails route to the trash page 0), and one batched first-token
        sample."""
        ps = self.ec.page_size
        B = len(slots)
        n_pages = bucket // ps
        toks = np.zeros((B, bucket), np.int32)
        lens = np.zeros((B,), np.int32)
        rows = np.zeros((B, n_pages), np.int32)
        aids = np.zeros((B,), np.int32)
        for i, slot in enumerate(slots):
            pending = self._requests[self._slot_req[slot]]
            if pending.span is not None:
                pending.span.mark("prefill")
            plen = len(pending.tokens)
            toks[i, :plen] = pending.tokens
            lens[i] = plen
            aids[i] = pending.adapter_id
            owned = self._pages_for(plen)
            rows[i, :owned] = self._prefill_rows[slot][:owned]
        self._check_epoch()  # last fence before writing the pools
        logits, pk, pv = prefill(self.params, self.config, self._host(toks),
                                 self._host(lens), ps, **self._model_kw(aids))
        self._count_prefill(B)
        write_pages(self.k_pool, self.v_pool, pk, pv, self._host(rows), mesh=self._mesh)
        logits, ok_dev = self._guard_logits(
            logits, [self._slot_req[sl] for sl in slots], phase="prefill")
        cmask, cstall, cdone = self._prefill_masks(slots)
        sampled, ok = self._sample(logits, ok_dev, cmask)
        if self._perf_on:
            # per ROW at the real prompt length; a recompute prefill lands
            # under its waste reason, a NaN-tripped row -> tick_retry
            self._charge_prefill_rows(slots, lens, 0, ok)
        now = time.perf_counter()
        for i, slot in enumerate(slots):
            if ok is not None and not ok[i]:
                self._fail_nan(slot, "prefill sample row")
                continue
            if i in cstall:
                self._fail_constraint_stall(slot)
                continue
            pending = self._requests[self._slot_req[slot]]
            del self._prefilling[slot]
            plen = int(lens[i])
            if i in cdone:
                # a recompute-resumed automaton already at a closed grammar:
                # nothing may follow — finish with the kept tokens instead
                # of sampling (outcome "valid")
                self._activate_decode(slot, plen, self._pages_for(plen),
                                      self._prefill_rows[slot])
                self._finish(slot, self._slot_req[slot], truncated=False)
                continue
            self._mark_first_token(pending, now)
            self._activate_decode(slot, plen, self._pages_for(plen),
                                  self._prefill_rows[slot])
            self._commit(slot, int(sampled[i]))

    def _mark_first_token(self, pending: _Pending, now: float) -> None:
        if pending.first_token_at:
            # resume prefill after a drop-preempt: the first token left long
            # ago — TTFT and the span mark must not move
            return
        pending.first_token_at = now
        if pending.span is not None:
            pending.span.mark("first_token")
        self.telemetry.observe_ttft(now - pending.submitted_at, pending.priority)

    def _prefill_chunk_group(self, slots: list, off: int) -> None:
        """ONE chunked-prefill dispatch for every long prompt at the same
        chunk offset: each row advances one page-aligned chunk; rows whose
        chunk completes the prompt sample their first token."""
        ps = self.ec.page_size
        C = self.ec.prefill_chunk
        B = len(slots)
        first_page = off // ps
        n_chunk = C // ps
        n_hist = first_page + n_chunk
        toks = np.zeros((B, C), np.int32)
        lens = np.zeros((B,), np.int32)
        aids = np.zeros((B,), np.int32)
        chunk_ids = np.zeros((B, n_chunk), np.int32)
        hist_ids = np.zeros((B, n_hist), np.int32)
        table_rows = {}
        for i, slot in enumerate(slots):
            pending = self._requests[self._slot_req[slot]]
            if pending.span is not None:
                pending.span.mark("prefill")
            plen = len(pending.tokens)
            chunk = pending.tokens[off:off + C]
            toks[i, :len(chunk)] = chunk
            lens[i] = plen
            aids[i] = pending.adapter_id
            owned = self._pages_for(plen)
            table_rows[slot] = row = self._prefill_rows[slot]
            # pages past the owned range (final-chunk padding) scatter into
            # the reserved trash page 0; reads past `length` are masked
            real = max(0, min(owned - first_page, n_chunk))
            chunk_ids[i, :real] = row[first_page:first_page + real]
            hreal = min(owned, n_hist)
            hist_ids[i, :hreal] = row[:hreal]
        self._check_epoch()  # last fence before writing the pools
        logits, self.k_pool, self.v_pool = prefill_chunk(
            self.params, self.config, self._host(toks), off,
            self._host(lens), self._host(chunk_ids), self._host(hist_ids),
            self.k_pool, self.v_pool, ps, **self._model_kw(aids))
        self._count_prefill(B)
        finishing = [i for i in range(B) if off + C >= int(lens[i])]
        ok = None
        cstall = cdone = ()
        if finishing:
            logits, ok_dev = self._guard_logits(
                logits, [self._slot_req[sl] for sl in slots], phase="prefill")
            # mid-prompt rows sample nothing: their grammar walks would be
            # pure waste
            cmask, cstall, cdone = self._prefill_masks(slots, only=set(finishing))
            # rows mid-prompt get sampled too (their values are unused) —
            # still one transfer in total
            sampled, ok = self._sample(logits, ok_dev, cmask)
            now = time.perf_counter()
        if self._perf_on:
            # each row advances min(C, plen-off) real positions over `off`
            # of history; only FINISHING rows can charge tick_retry
            self._charge_prefill_rows(slots, lens, off, ok, finishing=set(finishing))
        for i, slot in enumerate(slots):
            if i not in finishing:
                self._prefilling[slot] = off + C
                # an advanced chunk IS progress for the failure cap
                self._reset_failures(self._requests[self._slot_req[slot]])
                continue
            if ok is not None and not ok[i]:
                self._fail_nan(slot, "chunked-prefill sample row")
                continue
            if i in cstall:
                self._fail_constraint_stall(slot)
                continue
            pending = self._requests[self._slot_req[slot]]
            del self._prefilling[slot]
            plen = int(lens[i])
            if i in cdone:
                # closed restored automaton: the same graceful finish as the
                # short-prefill group
                self._activate_decode(slot, plen, self._pages_for(plen),
                                      table_rows[slot])
                self._finish(slot, self._slot_req[slot], truncated=False)
                continue
            self._mark_first_token(pending, now)
            self._activate_decode(slot, plen, self._pages_for(plen),
                                  table_rows[slot])
            self._commit(slot, int(sampled[i]))

    def _decode_tick_single(self, decode_ready, gmask=None) -> None:
        """One decode step over ALL slots (inactive and prefilling rows hold
        len 0 and the trash page), the NaN guard, one batched sample (under
        this tick's grammar mask ``gmask``, if any), and the commits."""
        self._check_epoch()  # last fence before writing the pools
        self._note_dispatch_gap(time.perf_counter())
        logits, self.k_pool, self.v_pool = decode_step(
            self.params, self.config, self._host(self._tok_host),
            self._host(self._len_host), self._host(self._pt_host),
            self.k_pool, self.v_pool, paged=self._paged,
            **self._model_kw(self._aid_host))
        self._dispatch_mark = (self._ticks, time.perf_counter())
        self._decode_steps += 1
        sampled, ok = self._sample(*self._guard_logits(logits, self._row_rids()), gmask)
        if self._perf_on:
            # charged before the commits below advance the lengths
            for slot in decode_ready:
                if self._slot_req.get(slot) not in self._requests:
                    continue
                bad = ok is not None and not ok[slot]
                self.perf.charge("decode", self._fm.decode_row(int(self._len_host[slot])),
                                 1, "tick_retry" if bad else None)
        for slot in decode_ready:
            if ok is not None and not ok[slot]:
                self._fail_nan(slot, f"decode row (slot {slot})")
                continue
            self._commit(slot, int(sampled[slot]))

    # ------------------------------------------------- pipelined decode loop

    def _row_rids(self) -> list:
        """Request id per decode row (slot), -1 for inactive/prefilling
        rows — the chaos injector's per-request targeting key.  Cached
        between roster changes."""
        rids = self._row_rids_c
        if rids is None:
            rids = [-1] * self.ec.max_slots
            for slot, rid in self._slot_req.items():
                if slot not in self._prefilling:
                    rids[slot] = rid
            self._row_rids_c = rids
        return rids

    def _note_dispatch_gap(self, t_issue: float) -> None:
        """Observe the host-side gap since the previous decode dispatch
        returned — only across consecutive decode ticks, so idle waits and
        prefill-only ticks don't pollute the histogram."""
        mark = self._dispatch_mark
        if self.ec.telemetry and mark is not None and mark[0] >= self._ticks - 1:
            self.telemetry.observe_dispatch_gap(t_issue - mark[1])

    def _mark_roster_change(self, reason: str) -> None:
        """A slot joined or left the decode roster: the next pipelined
        dispatch must drain and rebuild device state first.  ``reason``
        labels that fence (the first recorded cause wins until consumed,
        except that "nan" overrides a pending mundane one: it is the label a
        postmortem looks for)."""
        if self._dirty_reason is None or reason == "nan":
            self._dirty_reason = reason
        self._roster_dirty = True
        self._row_rids_c = None

    def _count_fence(self, reason: str) -> None:
        self._fences += 1
        self._fence_reasons[reason] = self._fence_reasons.get(reason, 0) + 1
        self.telemetry.count_fence(reason)

    def _drain_pipeline(self, reason: str) -> None:
        """Pipeline fence: wait for the in-flight tick's readback, commit
        its tokens, and drop the device feedback so the next dispatch
        rebuilds from the (now current) host mirrors.  A no-op, and not
        counted, when nothing is in flight."""
        rec, self._inflight = self._inflight, None
        self._dec_state = None
        if rec is None:
            return
        self._count_fence(reason)
        t0 = time.perf_counter() if self._perf_on else 0.0
        self._commit_inflight(rec)
        if self._perf_on:
            self.timeline.note(self._ticks, "drain", time.perf_counter() - t0)

    def _discard_pipeline(self) -> None:
        """Drop pipeline state WITHOUT committing (watchdog restart: the
        in-flight tick's requests are being failed wholesale, and this runs
        off the loop thread, where a readback could block on a hung
        dispatch forever).  The dropped tick's staging set is not reused
        until its event has fired (``_acquire_staging``), so no copy of it
        can still be reading or writing a pinned buffer the revived loop
        fills."""
        if self._inflight is not None:
            self._count_fence("restart")
            # dispatched, never committed: real device work, discarded
            self._charge_dropped(self._inflight, "tick_retry")
        self._inflight = None
        self._dec_state = None
        self._roster_dirty = True

    def _reset_pipeline_after_failure(self) -> None:
        """A failed pipelined tick leaves in-flight/device state suspect:
        reset so the retry rebuilds from committed host state (greedy
        re-derives any dropped in-flight token byte-identically).  A
        SUPERSEDED thread must not touch the state: it now belongs to the
        restarted loop, which reset it itself in _supervise."""
        if getattr(self._tls, "epoch", None) in (None, self._epoch):
            self._inflight = None
            self._dec_state = None
            self._roster_dirty = True

    def _fence(self, reason: str, st: _Staging) -> list:
        """Drain the pipeline at a fence labelled ``reason`` and rebuild the
        device state from the host mirrors.  Returns the slots still ready
        to decode (the drain's commits may finish or fail rows)."""
        self._drain_pipeline(reason)
        # the drain's blocking readback is the hang window the watchdog
        # fires on: a stale thread resuming here must die before
        # rebuilding state the restarted loop now owns
        self._check_epoch()
        decode_ready = self._ready_now()
        if decode_ready:
            self._rebuild_device_state(decode_ready, st)
        return decode_ready

    def _fence_if_dirty(self, decode_ready, st: _Staging) -> list:
        """``_fence`` when the roster changed since the last dispatch (or
        the device state was dropped), else ``decode_ready`` as it is."""
        if not self._roster_dirty and self._dec_state is not None:
            return decode_ready
        reason, self._dirty_reason = self._dirty_reason or "roster", None
        return self._fence(reason, st)

    def _sync_fallback(self, gmask=None) -> None:
        """Pool exhausted at the lookahead: drain, then run this tick through
        the sync path, whose commit-time OOM truncates the right row; the
        device state rebuilds next tick."""
        self._drain_pipeline("pool")
        decode_ready = self._ready_now()
        if decode_ready:
            self._decode_tick_single(decode_ready, gmask)

    def _pipe_model_kw(self, st: _Staging) -> dict:
        """``_model_kw`` for a pipelined dispatch: the adapter ids go up
        from the staging set's pinned buffer without blocking."""
        if self._lora is None:
            return {"mesh": self._mesh}
        return {"mesh": self._mesh, "lora_params": self._lora,
                "adapter_ids": st.upload("aids", self._aid_host)}

    def _acquire_staging(self) -> _Staging:
        """The staging set of this tick's dispatch.  Its previous user was
        the dispatch before last, whose readback the commit-behind has
        already waited on, so ``wait`` returns at once (it blocks only
        after a failed tick dropped an uncommitted dispatch)."""
        self._stage_flip ^= 1
        st = self._staging[self._stage_flip]
        st.wait()
        return st

    def _readback(self, rec: dict) -> np.ndarray:
        """The in-flight tick's tokens on the host: waits on its event (the
        copy was started at dispatch); the wait is the timeline's
        ``readback`` segment."""
        t0 = time.perf_counter() if self._perf_on else 0.0
        rec["staging"].wait()
        out = rec["out"].numpy().copy()
        if self._perf_on:
            self.timeline.note(self._ticks, "readback", time.perf_counter() - t0)
        return out

    def _commit_inflight(self, rec: dict) -> None:
        """Commit-behind: land tick N's sampled tokens in the C++ batcher and
        host mirrors — called right after tick N+1's dispatch, or from a
        fence.  Rows whose slot was rebound or released since the dispatch
        are discarded by the rid guard; a guard-tripped row (negative
        token, see model.decode_step_sample) fails only itself."""
        if rec.get("kind") == "spec":
            self._commit_inflight_spec(rec)
            return
        sampled = self._readback(rec)
        perf = self._perf_on
        t0 = time.perf_counter() if perf else 0.0
        fl = rec.get("flops") or {}
        for slot in rec["slots"]:
            rid = rec["rids"][slot]
            f = fl.get(slot)
            if self._slot_req.get(slot) != rid or rid not in self._requests:
                # finished/failed/preempted behind the dispatch: the row's
                # device work is discarded by the rid guard
                if f:
                    self.perf.charge("decode", f, 1, "pipeline_drop")
                continue
            tok = int(sampled[slot])
            if tok < 0:  # guard encoding: -token - 1 == non-finite row
                if f:
                    self.perf.charge("decode", f, 1, "tick_retry")
                self._fail_nan(slot, f"pipelined decode row (slot {slot})")
                continue
            if f:
                self.perf.charge("decode", f, 1, None)
            self._commit(slot, tok)
        if perf:
            self.timeline.note(self._ticks, "commit_behind", time.perf_counter() - t0)

    def _reserve_to(self, slot: int, need: int) -> int:
        """Reserve pages until the slot OWNS ``need`` (a later commit
        crossing into a reserved page allocates nothing) and mirror them
        into the host page table.  Returns the owned-page count (>= need),
        or -1 on pool exhaustion: the callers then fall back to one sync
        tick, whose commit-time OOM truncates exactly like depth 0."""
        owned = int(np.count_nonzero(self._pt_host[slot]))
        while owned < need:
            p = self.batcher.reserve_page(slot)
            if p < 0:
                return -1
            self._pt_host[slot, owned] = p
            owned += 1
        return owned

    def _cover_row0(self, slot: int, S: int) -> int:
        """Speculative lookahead: a tick commits 1..K tokens, so the next
        dispatch's row-0 write (position S-1) may lie past the pages the
        committed length implies — reserve up to pages_for(S).  Draft rows
        need no cover (_draft_for clamps them to owned room).  Returns the
        owned-page count, or -1 when the pool can't cover the row."""
        need = self._pages_for(S)
        if need > self.ec.max_pages_per_slot:
            return -1
        return self._reserve_to(slot, need)

    def _ready_now(self) -> list:
        """The decode-ready slots as of now (after a drain): bound to a live
        request and not mid-prefill."""
        return [s for s in self._slot_req
                if s not in self._prefilling and self._slot_req[s] in self._requests]

    def _rebuild_device_state(self, decode_ready, st: _Staging) -> None:
        """Upload the last committed token per slot as the feedback edge the
        fused steps then carry forward between fences; in speculative mode
        as a seed packed row ``[last_token, -1, ...]``.  The seq-len shadow
        restarts from the committed lengths."""
        if self._spec is not None:
            seed = np.full((self.ec.max_slots, self._k), -1, np.int32)
            for slot in decode_ready:
                seed[slot, 0] = self._tok_host[slot]
            self._dec_state = st.upload("seed", seed)
        else:
            toks = np.zeros((self.ec.max_slots,), np.int32)
            for slot in decode_ready:
                toks[slot] = self._tok_host[slot]
            self._dec_state = st.upload("tokens", toks)
        self._dec_lens_shadow = self._len_host.copy()
        self._roster_dirty = False
        # reasons recorded by the drain's own commits are absorbed by this
        # rebuild, except "nan": the next fence must still carry it
        if self._dirty_reason != "nan":
            self._dirty_reason = None

    def _reserve_lookahead(self, decode_ready) -> bool:
        """Commit-behind page accounting: the C++ page grant for tick N's
        token happens one tick late, so before dispatching with seq_lens S
        every live row must already own pages_for(S) pages.  Only a row
        whose KV write starts a new page ((S-1) % page_size == 0) needs
        work: after a rebuild the commit-growth invariant covers the rest.
        False when the pool can't cover a row."""
        ps = self.ec.page_size
        for slot in decode_ready:
            S = int(self._dec_lens_shadow[slot])
            if S <= 0 or (S - 1) % ps:
                continue
            need = self._pages_for(S)
            if need > self.ec.max_pages_per_slot:
                # the one-past-final step of a row finishing behind the
                # dispatch: the model trash-routes its KV write
                continue
            if self._reserve_to(slot, need) < 0:
                return False
        return True

    def _decode_tick_pipelined(self, decode_ready, gmask=None) -> None:
        """One pipelined decode tick: fence if the roster changed, reserve
        lookahead pages, dispatch the fused step (the device consumes its
        own previous output), start the token readback, then commit the
        PREVIOUS tick's tokens while this one runs.

        ``gmask``: this tick's [max_slots, V] grammar mask, the fused
        step's ``token_mask``, uploaded from a pinned buffer without
        blocking.  A constrained tick arrives with the pipeline already
        drained (the "constrain" fence), so the mask is exact for the token
        this dispatch samples; its commit lands at the next tick's fence."""
        self._check_epoch()  # a superseded thread must not touch the pipeline
        try:
            st = self._acquire_staging()
            decode_ready = self._fence_if_dirty(decode_ready, st)
            if not decode_ready:
                return
            if not self._reserve_lookahead(decode_ready):
                self._sync_fallback(gmask)
                return
            poison = self._poison()
            self._check_epoch()  # last fence before writing the pools
            self._note_dispatch_gap(time.perf_counter())
            sampled, self.k_pool, self.v_pool = decode_step_sample(
                self.params, self.config, self._dec_state,
                st.upload("lens", self._dec_lens_shadow),
                st.upload("table", self._pt_host), self.k_pool, self.v_pool,
                self._gen, poison, temperature=self.ec.temperature,
                guard=self.ec.logit_guard, paged=self._paged,
                token_mask=st.upload("mask", gmask) if gmask is not None else None,
                **self._pipe_model_kw(st))
            self._dispatch_mark = (self._ticks, time.perf_counter())
            self._decode_steps += 1
            rec = {"staging": st, "out": st.read_back("sampled", sampled),
                   "slots": tuple(decode_ready),
                   "rids": {s: self._slot_req[s] for s in decode_ready}}
            if self._perf_on:
                # FLOPs priced at dispatch (the shadow lens this dispatch
                # used), attributed at commit-behind when each row's outcome
                # is known
                rec["flops"] = {s: self._fm.decode_row(int(self._dec_lens_shadow[s]))
                                for s in decode_ready}
            prev, self._inflight = self._inflight, rec
            self._dec_state = sampled
            shadow = self._dec_lens_shadow
            self._dec_lens_shadow = np.where(shadow > 0, shadow + 1, 0).astype(np.int32)
            if prev is not None:
                # commit-behind: tick N lands while tick N+1 runs
                self._commit_inflight(prev)
        except BaseException:
            self._reset_pipeline_after_failure()
            raise

    # -------------------------------------------- pipelined speculative loop

    def _accepted_row(self, pending: _Pending, row: np.ndarray) -> list:
        """One packed verify row as the tokens the sync commit walk would
        commit: the leading non-sentinel entries, cut at the remaining
        budget and after the first stop id.  Empty == the row's NaN guard
        tripped."""
        n = int((row >= 0).sum())  # packed rows are leading-accepted
        toks = [int(t) for t in row[:n]]
        toks = toks[:max(0, pending.max_new_tokens - len(pending.generated))]
        for j, t in enumerate(toks):
            if t in self._stop_ids:
                return toks[:j + 1]
        return toks

    def _stage_inflight_spec(self, rec: dict) -> bool:
        """Read back the in-flight verify tick's packed tokens and STAGE
        them: append to ``pending.context`` (this tick's drafts read it) and
        advance the seq-len shadow.  The C++ commits stay deferred to the
        commit-behind after the next dispatch.  Returns False when a row
        finished or tripped the guard, so its release or failure must land
        before the next dispatch; ``rec["fence_reason"]`` names why."""
        packed = self._readback(rec)
        rec["packed_np"] = packed
        reason = None
        for slot in rec["slots"]:
            rid = rec["rids"][slot]
            pending = self._requests.get(rid)
            if self._slot_req.get(slot) != rid or pending is None:
                continue
            toks = self._accepted_row(pending, packed[slot])
            rec["staged"][slot] = toks
            if not toks:  # sentinel row: the guard tripped
                reason = "nan"
                continue
            pending.context.extend(toks)
            if (len(pending.generated) + len(toks) >= pending.max_new_tokens
                    or toks[-1] in self._stop_ids):
                reason = reason or "finish"
            self._dec_lens_shadow[slot] += len(toks)
        rec["fence_reason"] = reason
        return reason is None

    def _commit_inflight_spec(self, rec: dict) -> None:
        """Commit-behind of a verify tick: 1..K staged tokens per slot into
        the C++ batcher.  Rows a fence drained before staging are decoded
        from the packed array here, context append included.  A sentinel
        row fails only its own slot."""
        packed = rec.get("packed_np")
        if packed is None:
            packed = self._readback(rec)
        perf = self._perf_on
        t0 = time.perf_counter() if perf else 0.0
        fl = rec.get("flops") or {}
        for slot in rec["slots"]:
            f_row, k_i = fl.get(slot, (0.0, 1))
            rid = rec["rids"][slot]
            if self._slot_req.get(slot) != rid or rid not in self._requests:
                # finished behind the dispatch: the rid guard discards it
                if f_row:
                    self.perf.charge("verify", f_row, k_i, "pipeline_drop")
                continue
            pending = self._requests[rid]
            toks = rec["staged"].get(slot)
            staged = toks is not None
            if not staged:
                toks = self._accepted_row(pending, packed[slot])
            if not toks:
                if f_row:
                    self.perf.charge("verify", f_row, k_i, "tick_retry")
                rec["staged"].pop(slot, None)
                self._fail_nan(slot, f"fused verify row (slot {slot})")
                continue
            d = rec["drafts"].get(slot) or ()
            self._spec_proposed += len(d)
            committed = 0
            for t in toks:
                rc = self._commit(slot, t, ctx=not staged)
                committed += 1
                if staged:
                    # what is left here after an exception is exactly the
                    # uncommitted tail the failed tick must un-stage
                    rec["staged"][slot] = toks[committed:]
                if rc != 1:
                    break  # finished / truncated: the slot is released
            if staged:
                rest = rec["staged"].pop(slot)
                if rest:
                    # the batcher finished earlier than staging predicted:
                    # context stays exactly prompt + generated
                    del pending.context[-len(rest):]
            if f_row:
                # committed positions' share is goodput; the remainder
                # (rejected drafts / early-EOS tail) is spec_reject
                good = f_row * min(committed, k_i) / k_i
                self.perf.charge("verify", good, committed, None)
                if k_i > committed:
                    self.perf.charge("verify", f_row - good, k_i - committed,
                                     "spec_reject")
            # accepted drafts = committed minus the bonus/correction token
            acc = max(0, committed - 1)
            self._spec_accepted += acc
            if d:
                self.telemetry.observe_spec(len(d), acc)
        if perf:
            self.timeline.note(self._ticks, "commit_behind", time.perf_counter() - t0)

    def _decode_tick_spec_pipelined(self, decode_ready) -> None:
        """One pipelined SPECULATIVE tick: fence if the roster changed, read
        back the previous verify tick's packed tokens and stage them, draft
        from the staged context, reserve up to K lookahead pages per slot,
        dispatch the fused verify (the device derives its committed-token
        feedback from the previous packed output), then commit the PREVIOUS
        tick's 1..K tokens per slot while this one runs."""
        self._check_epoch()  # a superseded thread must not touch the pipeline
        staged_rec = None  # staged-but-uncommitted record, for rollback
        try:
            st = self._acquire_staging()
            decode_ready = self._fence_if_dirty(decode_ready, st)
            if not decode_ready:
                return
            prev = self._inflight
            staged_n = {}
            if prev is not None:
                staged_rec = prev
                if self._stage_inflight_spec(prev):
                    staged_n = {s: len(t) for s, t in prev["staged"].items()}
                else:
                    # a row finished or tripped the guard behind the
                    # dispatch: commit now at a fence, so the release or
                    # failure lands before this dispatch's page table
                    fr = prev["fence_reason"]
                    decode_ready = self._fence(fr, st)
                    if fr == "nan" and self._dirty_reason == "nan":
                        # this fence carried the nan label already
                        self._dirty_reason = None
                    if not decode_ready:
                        return
                    prev = None
            K = self._k
            drafts = np.zeros((self.ec.max_slots, K - 1), np.int32)
            dlen = np.zeros((self.ec.max_slots,), np.int32)
            by_slot = {}
            shadow = self._dec_lens_shadow
            for slot in decode_ready:
                S = int(shadow[slot])
                if S <= 0:
                    continue
                owned = self._cover_row0(slot, S)
                if owned < 0:
                    self._sync_fallback()
                    return
                pending = self._requests[self._slot_req[slot]]
                gen = len(pending.generated) + staged_n.get(slot, 0)
                d = self._draft_for(slot, S, gen_count=gen, owned=owned)
                if d:
                    drafts[slot, :len(d)] = d
                    dlen[slot] = len(d)
                    by_slot[slot] = list(d)
            lens = st.upload("lens", shadow)
            table = st.upload("table", self._pt_host)
            self._check_epoch()  # last fence before writing the pools
            if by_slot:
                poison = self._poison("verify")
                self._note_dispatch_gap(time.perf_counter())
                packed, self.k_pool, self.v_pool = decode_step_verify_sample(
                    self.params, self.config, self._dec_state,
                    st.upload("drafts", drafts), st.upload("dlen", dlen), lens,
                    table, self.k_pool, self.v_pool, self._gen, poison,
                    temperature=self.ec.temperature, guard=self.ec.logit_guard,
                    paged=self._paged, **self._pipe_model_kw(st))
            else:
                # no drafts anywhere: the single-token step (the sync loop's
                # no-draft dispatch, same numerics) on the packed edge
                poison = self._poison()
                self._note_dispatch_gap(time.perf_counter())
                packed, self.k_pool, self.v_pool = decode_step_sample_packed(
                    self.params, self.config, self._dec_state, lens, table,
                    self.k_pool, self.v_pool, self._gen, poison,
                    temperature=self.ec.temperature, guard=self.ec.logit_guard,
                    paged=self._paged, **self._pipe_model_kw(st))
            self._dispatch_mark = (self._ticks, time.perf_counter())
            self._decode_steps += 1
            self._inflight = {
                "kind": "spec", "staging": st, "out": st.read_back("packed", packed),
                "slots": tuple(decode_ready),
                "rids": {s: self._slot_req[s] for s in decode_ready},
                "drafts": by_slot, "staged": {}}
            if self._perf_on:
                # (flops, k) per row priced at dispatch — k = 1 committed +
                # real drafts (padding verify lanes are not requested work)
                self._inflight["flops"] = {
                    s: (self._fm.verify_row(int(shadow[s]), int(dlen[s]) + 1),
                        int(dlen[s]) + 1)
                    for s in decode_ready}
            self._dec_state = packed
            if prev is not None:
                # commit-behind: tick N's 1..K tokens per slot land while
                # tick N+1 runs
                self._commit_inflight(prev)
        except BaseException:
            # un-stage context tokens the commit-behind never landed, so the
            # retry re-derives them (a superseded thread leaves the state to
            # the restarted loop)
            if (staged_rec is not None
                    and getattr(self._tls, "epoch", None) in (None, self._epoch)):
                for slot, toks in staged_rec.get("staged", {}).items():
                    p = self._requests.get(staged_rec["rids"].get(slot))
                    if p is not None and toks:
                        del p.context[-len(toks):]
            self._reset_pipeline_after_failure()
            raise

    # ------------------------------------------------------- speculative

    def _draft_for(self, slot: int, seq_len: int, gen_count: Optional[int] = None,
                   owned: Optional[int] = None) -> list:
        """Prompt-lookup draft for one slot, clamped so every draft position
        stays inside the slot's owned pages and inside the token budget.
        ``gen_count`` overrides the generated count (the pipelined loop
        passes committed + staged); ``owned`` passes an owned-page count
        just computed.  The one draft-size policy of both loops, which keeps
        their tick sequences aligned."""
        if seq_len == 0:
            return []
        ps = self.ec.page_size
        # draft row j writes KV at position seq_len-1+j, inside OWNED pages
        # (reservations included)
        if owned is None:
            owned = int(np.count_nonzero(self._pt_host[slot]))
        room = owned * ps - seq_len
        pending = self._requests[self._slot_req[slot]]
        if pending.brownout >= 2:
            # ingress brownout stage 2+: speculation spends K-wide verify
            # passes to buy latency, the first quality cost a browned-out
            # service sheds.  No draft = the plain single-token step, the
            # same tokens, only slower
            return []
        if gen_count is None:
            gen_count = len(pending.generated)
        budget = pending.max_new_tokens - gen_count - 1
        if (room < min(self.ec.spec_max_draft, budget)
                and self.batcher.free_pages > self.ec.max_slots):
            # near a page boundary with drafts still wanted: reserve the
            # next page (the slack gate keeps reservations from starving
            # another slot's commit into OOM truncation)
            p = self.batcher.reserve_page(slot)
            if p >= 0:
                self._pt_host[slot, owned] = p
                room += ps
        draft = self._lookup_draft(pending, min(self.ec.spec_max_draft, room, budget))
        if draft and pending.constrain is not None:
            draft = self._legal_draft_prefix(pending, draft)
        return draft

    def _legal_draft_prefix(self, pending: _Pending, draft: list) -> list:
        """Truncate a prompt-lookup draft at the first token the grammar
        rejects, walking an automaton CLONE (the request's own automaton
        advances only in _commit): a known-illegal draft position would
        spend a verify row on a certain rejection, so every rejected draft
        that does reach verify is a genuine model disagreement, charged to
        spec_reject.  A stop id also ends the draft."""
        ts = time.perf_counter()
        walker = pending.constrain.clone()
        keep = 0
        for t in draft:
            if int(t) in self._stop_ids or not walker.advance(int(t)):
                break
            if not self._grammar_row(walker).any():
                # the grammar CLOSED behind this token (zero legal rows):
                # keep the closing token out of the draft, so no verify
                # position samples from an all-False mask; it arrives as a
                # sampled token and the next tick's mask build finishes the
                # slot
                break
            keep += 1
        if pending.span is not None:
            pending.span.hint("grammar_advance", time.perf_counter() - ts)
        return draft[:keep]

    def _lookup_draft(self, pending: _Pending, limit: int) -> list:
        """Advance the request's n-gram index over newly appended context
        (each position indexed once), then return up to ``limit`` tokens
        that followed the most recent EARLIER occurrence of the context's
        final n-gram."""
        if limit <= 0:
            return []
        ctx = pending.context
        n = self.ec.spec_ngram
        if len(ctx) <= n:
            return []
        # index n-grams starting strictly before the final one, so the
        # lookup yields the most recent EARLIER occurrence
        idx = pending.ngram_index
        p = pending.ngram_p
        last = len(ctx) - n
        while p < last:
            idx[tuple(ctx[p:p + n])] = p
            p += 1
        pending.ngram_p = p
        i = idx.get(tuple(ctx[-n:]))
        if i is None:
            return []
        return ctx[i + n:i + n + limit]

    def _decode_tick_speculative(self, decode_ready, drafts, gmask=None) -> None:
        """One verify pass over [last token + drafts] for every ready slot;
        commit the longest draft prefix matching greedy argmax plus the
        bonus token of the first non-matching row.  Rejected draft KV stays
        masked and is overwritten by a later row-0 write.

        ``gmask``: the [max_slots, V] position-0 grammar mask, expanded here
        into the [max_slots, K, V] verify mask by walking an automaton CLONE
        over each slot's drafts — position j's row assumes drafts 0..j-1
        accepted, the state the commit walk is in when it reads logits[j].
        Drafts the grammar rejects were already cut by _draft_for."""
        K = self._k
        tokens = np.zeros((self.ec.max_slots, K), np.int32)
        for slot in decode_ready:
            tokens[slot, 0] = self._tok_host[slot]
            d = drafts.get(slot) or []
            tokens[slot, 1:1 + len(d)] = d
        vmask = None
        if gmask is not None:
            tm = time.perf_counter()
            vmask = np.ones((self.ec.max_slots, K, self.config.vocab_size), np.bool_)
            for slot in decode_ready:
                pending = self._requests.get(self._slot_req.get(slot))
                if pending is None or pending.constrain is None:
                    continue
                ts = time.perf_counter()
                vmask[slot, 0, :] = gmask[slot]
                walker = pending.constrain.clone()
                for j, t in enumerate(drafts.get(slot) or []):
                    if not walker.advance(int(t)):
                        # only from a dead-end state (illegal drafts were
                        # cut): the previous position's mask forbids going
                        # on, so the commit walk never reads the rows left
                        # all-True here
                        break
                    vmask[slot, j + 1, :] = self._grammar_row(walker)
                if pending.span is not None:
                    pending.span.hint("grammar_advance", time.perf_counter() - ts)
            self.telemetry.observe_grammar_mask(time.perf_counter() - tm)
        self._check_epoch()  # last fence before writing the pools
        self._note_dispatch_gap(time.perf_counter())
        logits, self.k_pool, self.v_pool = decode_step_k(
            self.params, self.config, self._host(tokens),
            self._host(self._len_host), self._host(self._pt_host),
            self.k_pool, self.v_pool, paged=self._paged,
            **self._model_kw(self._aid_host))
        self._dispatch_mark = (self._ticks, time.perf_counter())
        self._decode_steps += 1
        logits, ok_dev = self._guard_logits(logits, self._row_rids(), phase="verify")
        if vmask is not None:
            # AFTER the guard read the raw logits: a poisoned verify pass
            # must still trip the guard
            logits = torch.where(self._host(vmask), logits, -1e30)
        B, _, V = logits.shape
        sampled = sample_tokens(logits.reshape(B * K, V), self._gen,
                                self.ec.temperature).reshape(B, K)
        ok = None
        if ok_dev is None:
            sampled = sampled.cpu().numpy()
        else:  # one host transfer of the tokens and the guard
            both = torch.cat([sampled, ok_dev[:, None].to(torch.int32)], dim=1).cpu().numpy()
            sampled, ok = both[:, :K], both[:, K].astype(bool)
        for slot in decode_ready:
            k_i = 1 + len(drafts.get(slot) or [])
            # priced before this slot's commits advance its length
            f_row = (self._fm.verify_row(int(self._len_host[slot]), k_i)
                     if self._perf_on else 0.0)
            if ok is not None and not ok[slot]:
                if self._perf_on:
                    # the whole poisoned pass is discarded work
                    self.perf.charge("verify", f_row, k_i, "tick_retry")
                # any of the slot's K verify rows non-finite: fail the slot
                # before committing anything from the pass
                self._fail_nan(slot, f"speculative verify (slot {slot})")
                continue
            d = drafts.get(slot) or []
            self._spec_proposed += len(d)
            acc = 0
            committed = 0
            for j in range(len(d) + 1):
                tok = int(sampled[slot, j])
                rc = self._commit(slot, tok)
                committed += 1
                if rc != 1:
                    break  # finished / truncated: the slot is released
                # logits[j+1] is valid only if the input at that row (draft
                # j) is what greedy produced
                if j >= len(d) or d[j] != tok:
                    break
                self._spec_accepted += 1
                acc += 1
            if self._perf_on and f_row > 0:
                # committed positions' share is goodput; the remainder is
                # the speculation tax, attributed spec_reject
                good = f_row * committed / k_i
                self.perf.charge("verify", good, committed, None)
                if k_i > committed:
                    self.perf.charge("verify", f_row - good, k_i - committed,
                                     "spec_reject")
            if d:
                self.telemetry.observe_spec(len(d), acc)

    # --------------------------------------------------------- slot lifecycle

    def _activate_decode(self, slot: int, plen: int, owned: int, row) -> None:
        """Prefill finished: install the slot's page row + length into the
        host mirrors, making it visible to the decode step — a roster
        change for the pipeline."""
        self._check_epoch()
        self._pt_host[slot, :owned] = row[:owned]
        self._len_host[slot] = plen
        self._prefill_rows.pop(slot, None)
        self._mark_roster_change("admit")

    def _commit(self, slot: int, token: int, ctx: bool = True) -> int:
        """Record one generated token; returns the batcher rc (1 = keep
        decoding; anything else means the slot was finished+released).
        ``ctx=False``: the pipelined speculative readback already staged
        the token into ``pending.context``."""
        self._check_epoch()
        rid = self._slot_req[slot]
        pending = self._requests[rid]
        self._reset_failures(pending)
        if pending.constrain is not None and token not in self._stop_ids:
            # THE automaton-advance point: once per committed token, and
            # every commit path funnels here.  The mask already forced
            # legality, so a failed advance is a mask/automaton disagreement
            # (the stall class): the slot fails BEFORE the token reaches
            # the stream or the result
            if not pending.constrain.advance(int(token)):
                self._fail_constraint_stall(slot)
                return 0
        if self.ec.telemetry:
            now = time.perf_counter()
            if pending.last_token_at:
                # inter-token interval (TPOT) — the decode-speed histogram
                self.telemetry.observe_tpot(now - pending.last_token_at,
                                            pending.priority)
            pending.last_token_at = now
        pending.generated.append(token)
        if ctx:
            pending.context.append(token)
        if pending.stream is not None:
            pending.stream.put(token)
        rc, new_page = self.batcher.commit_token_ex(slot, token in self._stop_ids)
        if rc == 1:
            self._len_host[slot] += 1
            self._tok_host[slot] = token
            if new_page >= 0:
                idx = self._pages_for(int(self._len_host[slot])) - 1
                self._pt_host[slot, idx] = new_page
            return rc
        # finished (0) or page-pool OOM (-2): either way the slot frees; OOM
        # truncates the generation rather than deadlocking the pool
        self._finish(slot, rid, truncated=(rc == -2))
        return rc

    def _release_slot_state(self, slot: int) -> None:
        """Zero one slot's host mirrors (page row, length, adapter id, last
        token, prefill row); every release path funnels here, and a release
        is a roster change for the pipeline.  A freed slot decodes as the
        zero adapter."""
        self._pt_host[slot, :] = 0
        self._len_host[slot] = 0
        self._aid_host[slot] = 0
        self._tok_host[slot] = 0
        self._prefill_rows.pop(slot, None)
        self._mark_roster_change("finish")

    def _finish(self, slot: int, rid: int, truncated: bool,
                cancelled: bool = False, cache_ok: bool = True) -> None:
        """Resolve a slot's request and free the slot.  ``cache_ok=False``
        (cancelled mid-prefill): the pages hold partial KV and are neither
        cached nor pinned."""
        self._check_epoch()
        with self._lock:
            pending = self._requests.pop(rid, None)
            self._slot_req.pop(slot, None)
        if pending is None:
            self._release_slot_state(slot)
            self.batcher.release(slot)
            return
        # session pin BEFORE the mirrors zero: the slot's page row and
        # committed length are what the snapshot reads
        session = None
        if pending.session_id is not None:
            session = self._pin_session(slot, pending, cache_ok)
        # the prefill phase's committed pages leave through the handoff
        # store, same window (they ALSO release to the prefix cache below,
        # so a degraded decode phase landing back here is a cache hit)
        handoff_rec = None
        if pending.handoff and not cancelled:
            handoff_rec = self._export_handoff(slot, pending, cache_ok)
        # the fleet-fabric publish, same window; a prefill phase skips it
        # (its pages leave through the one-shot handoff store)
        if self._fabric is not None and not cancelled and not pending.handoff:
            if pending.brownout >= 3:
                # ingress brownout stage 3: a publish snapshots device pages
                # to the host, deferrable work by definition; the pages
                # still reach the local prefix cache below
                self.telemetry.count_fabric("publish_deferred")
            else:
                self._publish_fabric(slot, pending, cache_ok)
        self._release_slot_state(slot)
        # the prompt's full pages enter the prefix cache on the way out,
        # unless the prefill never finished (their KV is partial) or the
        # session pinned them: then they live in the tiered store instead
        release_hashes = pending.page_hashes if cache_ok else None
        if session is not None and session.get("pinned"):
            release_hashes = None
        self.batcher.release(slot, release_hashes)
        self._retire(pending, "cancelled" if cancelled else "done")
        result = self._result(rid, pending, truncated, cancelled)
        if handoff_rec is not None:
            result["handoff"] = handoff_rec
        if pending.fabric_restore is not None:
            result["fabric"] = {"restore": pending.fabric_restore}
        if pending.session_id is not None:
            # "evicted" is a COUNT: session ids are bearer capabilities, so
            # another client's id never appears in this client's response
            result["session"] = {
                "id": pending.session_id,
                "restore": pending.session_restore or "cold",
                "pinned": bool(session.get("pinned")),
                "durable": bool(session.get("durable")),
                "evicted": len(session.get("evicted") or ()),
            }
            err = session.get("error") or session.get("reason")
            if err:
                result["session"]["error"] = err
        if pending.constrain is not None:
            # the structured-output receipt: "valid" when the automaton
            # ACCEPTS the whole generation (a complete grammar-valid
            # utterance); a budget cut, an OOM truncation or a cancel left a
            # legal but incomplete prefix: "truncated"
            c = pending.constrain
            outcome = "valid" if c.accepting() else "truncated"
            self.telemetry.count_constrain(outcome)
            result["constrain"] = {"kind": c.kind, "outcome": outcome,
                                   "n_tokens": c.n_tokens, "n_bytes": c.n_bytes}
            if c.tool_name is not None:
                result["constrain"]["tool"] = c.tool_name
        self._resolve(pending, result)

    def _export_handoff(self, slot: int, pending: _Pending, cache_ok: bool) -> dict:
        """Disaggregated prefill phase, export half: snapshot every page the
        finishing slot owns — positions [0, L-2] where L = len(context) =
        prompt + first token (the last token's KV is written by the decode
        step on the PULLING replica) — frame it KVPG/CRC, and register the
        frame in the handoff store under a one-shot TTL'd handle.  A
        blocking device -> host copy on the loop thread, as a swap-out is.

        Degrades, never raises: any failure returns ``{"error": ...}`` and
        the proxy falls back to the unified path."""
        if not cache_ok:
            self.telemetry.count_handoff("export_failed")
            return {"error": "incomplete prefill"}
        L = len(pending.context)
        owned = min(self._pages_for(L), int(np.count_nonzero(self._pt_host[slot])))
        if L < 2 or owned <= 0:
            self.telemetry.count_handoff("export_failed")
            return {"error": "nothing committed to hand off"}
        t0 = time.perf_counter()
        try:
            blob, _ = self._snapshot_pages(self._pt_host[slot, :owned])
            meta = {"resume_len": L, "page_size": self.ec.page_size,
                    "pages": owned, "adapter_id": pending.adapter_id,
                    "generated": list(pending.generated)}
            data, nbytes = self._pack(f"handoff/{pending.rid}", blob, meta)
            ttl = None
            if self._handoff_chaos is not None and self._handoff_chaos.expire_export():
                ttl = 0.0  # chaos: the puller must find it expired
            handle = self._handoffs.put(data, meta, ttl_s=ttl)
            if handle is None:
                self.telemetry.count_handoff("export_failed")
                return {"error": "handoff store budget exhausted"}
            self.telemetry.count_handoff("export")
            if self.ec.telemetry:
                self._flight_event("handoff_export", [slot],
                                   {"pages": owned, "bytes": nbytes, "resume_len": L},
                                   t0, "ok")
            return {"handle": handle, "pages": owned, "nbytes": nbytes,
                    "resume_len": L,
                    "ttl_s": self.ec.handoff_ttl_s if ttl is None else ttl}
        except Exception as exc:  # noqa: BLE001 — an export must degrade
            self.telemetry.count_handoff("export_failed")
            if self.ec.telemetry:
                self._flight_event("handoff_export", [slot], None, t0, "error",
                                   error=f"{type(exc).__name__}: {exc}")
            return {"error": f"{type(exc).__name__}: {exc}"}

    def _publish_fabric(self, slot: int, pending: _Pending, cache_ok: bool) -> None:
        """Fleet-fabric publish: snapshot the finishing request's committed
        FULL pages (the session-pin geometry: positions [0, L-2]), frame
        them KVPG/CRC keyed by the prefix's deepest chain hash, and register
        the frame in the multi-reader FabricStore.  The meta carries the
        per-page chain hashes (the puller's correctness gate) and the text
        fingerprint ladder (the router's placement key).  Degrades, never
        raises: a failed publish costs the FLEET a share, not this
        request."""
        if not cache_ok:
            return
        ps = self.ec.page_size
        L = int(self._len_host[slot])
        covered = min(max(0, (L - 1) // ps), int(np.count_nonzero(self._pt_host[slot])))
        if covered < max(1, self.ec.fabric_min_pages):
            return
        t0 = time.perf_counter()
        try:
            hashes = _page_hashes(pending.context, ps, pending.adapter_id)[:covered]
            key = fabric_key(hashes[-1])
            if self._fabric.covers(key, covered):
                # the same prefix is already published and live: skip the
                # expensive device -> host snapshot
                self.telemetry.count_fabric("publish_skipped")
                return
            fps = []
            if self.fabric_fingerprinter is not None:
                fps = self.fabric_fingerprinter(pending.context[:covered * ps]) or []
            blob, _ = self._snapshot_pages(self._pt_host[slot, :covered])
            meta = {"hashes": [int(h) for h in hashes], "pages": covered,
                    "page_size": ps, "adapter_id": pending.adapter_id,
                    "model": self.fabric_model_id, "fps": fps}
            data, nbytes = self._pack(f"fabric/{key}", blob, meta)
            ttl = None
            if self._fabric_chaos is not None and self._fabric_chaos.expire_publish():
                ttl = 0.0  # chaos: every later pull must find it expired
            ok = self._fabric.publish(key, data, meta, ttl_s=ttl)
            self.telemetry.count_fabric("publish" if ok else "publish_failed")
            if self.ec.telemetry:
                self._flight_event("fabric_publish", [slot],
                                   {"key": key, "pages": covered, "bytes": nbytes},
                                   t0, "ok" if ok else "rejected")
        except Exception as exc:  # noqa: BLE001 — a publish must degrade
            self.telemetry.count_fabric("publish_failed")
            if self.ec.telemetry:
                self._flight_event("fabric_publish", [slot], None, t0, "error",
                                   error=f"{type(exc).__name__}: {exc}")

    def pull_fabric(self, key: str, count_miss: bool = True) -> Optional[bytes]:
        """Serve one published prefix frame (``GET /engine/kv_fabric/<key>``).
        MULTI-READER: a key is pulled as many times as the fleet wants.
        None on expired or unknown keys (the puller degrades).
        ``count_miss=False``: a multi-model server probing every engine for
        the owner must not charge a miss to the ones that never published
        it."""
        if self._fabric is None:
            return None
        outcome, data = self._fabric.pull(key, count_miss=count_miss)
        if outcome != "miss" or count_miss:
            self.telemetry.count_fabric(
                {"ok": "pull", "expired": "expired", "miss": "miss"}[outcome])
        if data is not None:
            self.telemetry.count_fabric_bytes("out", len(data))
        return data

    def fabric_view(self) -> list:
        """This replica's live published prefixes (FabricStore.view): the
        ``cache.fabric`` block of ``GET /engine/perf``, which the proxy's
        ``/fleet/cache`` view and cache-aware placement read."""
        return self._fabric.view() if self._fabric is not None else []

    def pull_handoff(self, handle: str, count_miss: bool = True) -> Optional[bytes]:
        """Serve one exported KV frame (``GET /engine/kv_handoff/<handle>``).
        One-shot: a second pull of the same handle is refused (two slots
        must not decode from one frame).  None on refused, expired or
        unknown handles (the puller degrades).  ``count_miss``: as in
        ``pull_fabric``."""
        outcome, data = self._handoffs.pull(handle, count_miss=count_miss)
        if outcome != "miss" or count_miss:
            self.telemetry.count_handoff(
                {"ok": "pull", "refused": "pull_refused",
                 "expired": "expired", "miss": "miss"}[outcome])
        if data is not None:
            self.telemetry.count_handoff_bytes("out", len(data))
        return data

    def drop_handoff(self, handle: str) -> bool:
        """Discard an exported frame that will never be pulled (the prefill
        phase's only token completed the generation)."""
        return self._handoffs.drop(handle)

    def _pin_session(self, slot: int, pending: _Pending, cache_ok: bool) -> dict:
        """Park a finishing session turn's KV pages in the tiered store:
        every COMPLETE page of committed KV (positions [0, L-2] — the final
        token's KV is only written by a decode step that never runs) plus
        the context's chain hashes, so the next turn can verify byte-exact
        prefix identity before re-adopting.  Degrades, never raises."""
        if not cache_ok:
            return {"pinned": False, "reason": "incomplete prefill"}
        ps = self.ec.page_size
        L = int(self._len_host[slot])
        covered = min(max(0, (L - 1) // ps), int(np.count_nonzero(self._pt_host[slot])))
        if covered == 0:
            self.telemetry.count_session_pin("rejected")
            return {"pinned": False,
                    "reason": "committed context shorter than one page"}
        t0 = time.perf_counter()
        try:
            blob, nbytes = self._snapshot_pages(self._pt_host[slot, :covered])
            hashes = _page_hashes(pending.context, ps, pending.adapter_id)[:covered]
            meta = {"hashes": [int(h) for h in hashes],
                    "context_len": len(pending.context),
                    "adapter_id": pending.adapter_id, "pages": covered}
            if self._mesh is not None:
                # per-shard list blobs flatten natively into the store's
                # version-1 page files; the degree rides in meta so a
                # restore at another degree reshards explicitly
                meta["tp"] = self._tp
            res = self._kv.pin_session(pending.session_id, blob, nbytes, meta)
        except Exception as exc:  # noqa: BLE001 — a pin must not fail the turn
            self.telemetry.count_session_pin("rejected")
            if self.ec.telemetry:
                self._flight_event("session_pin", [slot], None, t0, "error",
                                   error=f"{type(exc).__name__}: {exc}")
            return {"pinned": False, "reason": f"{type(exc).__name__}: {exc}"}
        self.telemetry.count_session_pin(
            "durable" if res.get("durable")
            else "pinned" if res.get("pinned") else "rejected")
        if self.ec.telemetry:
            self._flight_event(
                "session_pin", [slot],
                {"pages": covered, "bytes": res.get("nbytes"),
                 "durable": res.get("durable"),
                 "evicted": len(res.get("evicted") or ())},
                t0, "ok" if res.get("pinned") else "rejected")
        return res

    def _reset_failures(self, pending: _Pending) -> None:
        """A commit or an advanced prefill chunk is progress: the failure
        cap counts consecutive failures again from zero."""
        if pending.failures:
            with self._lock:
                if pending.failures:
                    pending.failures = 0
                    self._retrying -= 1

    def _note_group_failure(self, slots: list, phase: str, exc: Exception) -> None:
        self._ticks_failed += 1
        cap = self.ec.max_consecutive_failures
        escalated = []
        escalated_tids = []
        for slot in list(slots):
            rid = self._slot_req.get(slot)
            pending = self._requests.get(rid) if rid is not None else None
            if pending is None:
                continue
            with self._lock:
                pending.failures += 1
                if pending.failures == 1:
                    self._retrying += 1
            if pending.failures >= cap:
                err = TickFailure(
                    f"rejected after {pending.failures} consecutive "
                    f"{phase} failures (last: {type(exc).__name__}: {exc})")
                err.__cause__ = exc
                escalated.append(rid)
                if pending.span is not None:
                    escalated_tids.append(pending.span.trace_id)
                self._fail_slot(slot, err)
        if escalated and self.ec.telemetry:
            # a request crossed the consecutive-failure cap: persist the
            # tick-event ring now, while the failing ticks are still in it
            path = self.flight.dump(
                "tick_failure_escalation",
                extra={"phase": phase, "rids": escalated, "tick": self._ticks,
                       "trace_ids": escalated_tids,
                       "error": f"{type(exc).__name__}: {exc}"})
            self._note_dump(path, escalated_tids)

    def _fail_nan(self, slot: int, where: str) -> None:
        """NaN-guard trip: fail the poisoned slot with NonFiniteLogits and
        dump the flight recorder — one dump per TICK, not per row: a whole
        poisoned batch is one incident."""
        self._nan_rows += 1
        self._mark_roster_change("nan")  # before the release's "finish"
        tids: list = []
        path = None
        if self.ec.telemetry:
            tids = self._slot_trace_ids([slot])
            self._flight_event("nan_guard", [slot], None, time.perf_counter(),
                               "nan", error=f"non-finite logits in {where}")
            if self._nan_dump_tick != self._ticks:
                self._nan_dump_tick = self._ticks
                path = self.flight.dump(
                    "nan_guard_trip",
                    extra={"slot": slot, "rid": self._slot_req.get(slot),
                           "trace_ids": tids, "where": where,
                           "tick": self._ticks})
                self._note_dump(path, tids)
        # incident signal: joins the causal chain of a bigger open incident
        # and carries the dump so an incident it opens cites it
        self._incident_event("nan_guard", where=where,
                             rid=self._slot_req.get(slot), trace_ids=tids,
                             dump=path)
        self._fail_slot(slot, NonFiniteLogits(f"non-finite logits in {where}"))

    # ------------------------------------ structured output (constrain.py)

    def _constraint_for(self, slot: int) -> Optional[object]:
        p = self._requests.get(self._slot_req.get(slot))
        return p.constrain if p is not None else None

    def _grammar_row(self, c) -> np.ndarray:  # graftlint: hot-path
        """One automaton state's legal-token mask for the NEXT sampled
        token: the trie-walk token mask with the stop ids composed from
        acceptance — a stop id is legal exactly when the text so far is a
        complete grammar-valid utterance, and once the grammar can only
        END it is the sole legal token (the mask forces termination)."""
        row = c.token_mask()
        acc = c.accepting()
        for t in self._stop_ids:
            if 0 <= t < row.shape[0]:
                row[t] = acc
        return row

    def _grammar_mask_row(self, pending: _Pending):
        """``(row, forced)``: the slot's legal-token row, zeroed when the
        constrain chaos forces a stall; its wall joins the request's
        ``grammar_advance`` share of the waterfall."""
        ts = time.perf_counter()
        row = self._grammar_row(pending.constrain)
        forced = (self._constrain_chaos is not None
                  and self._constrain_chaos.stall_mask())
        if forced:
            row = np.zeros_like(row)
        if pending.span is not None:
            pending.span.hint("grammar_advance", time.perf_counter() - ts)
        return row, forced

    def _build_grammar_masks(self, slots: list) -> tuple:  # graftlint: hot-path
        """This tick's [max_slots, V] boolean token mask from each
        constrained slot's automaton, built on the host; unconstrained rows
        stay all-True, so their sampling is the unmasked one.  MUST run
        with no dispatch in flight (the _tick "constrain" fence).

        A row with zero legal tokens is told apart by acceptance: a CLOSED
        grammar (accepting, nothing may follow — e.g. no stop id to express
        the end) finishes the slot gracefully with the tokens it has; a
        non-accepting empty row (chaos-forced, or a compile or token-map
        bug) fails ONLY that slot (ConstraintStall).  Both leave the
        returned ready list.  Returns ``(surviving_slots, mask)``, mask
        None when no surviving slot is constrained."""
        t0 = time.perf_counter()
        mask = None
        stalled, closed = [], []
        for slot in slots:
            pending = self._requests.get(self._slot_req.get(slot))
            if pending is None or pending.constrain is None:
                continue
            row, forced = self._grammar_mask_row(pending)
            if not row.any():
                if not forced and pending.constrain.accepting():
                    closed.append(slot)
                else:
                    stalled.append(slot)
                continue
            if mask is None:
                mask = np.ones((self.ec.max_slots, self.config.vocab_size), np.bool_)
            mask[slot, :] = row
        self.telemetry.observe_grammar_mask(time.perf_counter() - t0)
        for slot in closed:
            self._finish(slot, self._slot_req[slot], truncated=False)
        for slot in stalled:
            self._fail_constraint_stall(slot)
        if stalled or closed:
            gone = set(stalled) | set(closed)
            slots = [s for s in slots if s not in gone]
        return slots, mask

    def _prefill_masks(self, slots: list, only=None) -> tuple:  # graftlint: hot-path
        """First-token grammar masks of one prefill group, in ROW order
        (``mask[i]`` gates ``slots[i]``); the prompt never advances the
        automaton, so a fresh request masks from the grammar's start state
        and a recompute resume from its restored snapshot.  ``only``
        restricts the build to those row indices (a chunked group's
        finishing rows).  Returns ``(mask_or_None, stalled_rows,
        closed_rows)``: stalled rows keep an all-True row and the caller
        fails them; closed rows (a restored automaton at a complete
        utterance with nothing allowed to follow) finish with their kept
        tokens instead of committing."""
        mask = None
        stall, done = set(), set()
        t0 = time.perf_counter()
        for i, slot in enumerate(slots):
            if only is not None and i not in only:
                continue
            pending = self._requests.get(self._slot_req.get(slot))
            if pending is None or pending.constrain is None:
                continue
            row, forced = self._grammar_mask_row(pending)
            if not row.any():
                if not forced and pending.constrain.accepting():
                    done.add(i)
                else:
                    stall.add(i)
                continue
            if mask is None:
                mask = np.ones((len(slots), self.config.vocab_size), np.bool_)
            mask[i, :] = row
        if mask is not None or stall or done:
            self.telemetry.observe_grammar_mask(time.perf_counter() - t0)
        return mask, stall, done

    def _fail_constraint_stall(self, slot: int) -> None:
        """A constrained slot's mask has zero legal tokens: a grammar
        compile or token-map bug, never the client's fault.  Fail ONLY this
        slot with ConstraintStall, count the outcome, and feed the incident
        plane's constraint_stall detector."""
        self._constraint_stalls += 1
        self.telemetry.count_constrain("stall")
        tids: list = []
        if self.ec.telemetry:
            tids = self._slot_trace_ids([slot])
            self._flight_event("constraint_stall", [slot], None,
                               time.perf_counter(), "stall",
                               error="zero legal tokens under grammar mask")
        self._incident_event("constraint_stall", rid=self._slot_req.get(slot),
                             trace_ids=tids)
        self._fail_slot(slot, ConstraintStall(
            "constrained decode reached a state with zero legal tokens"))

    def _check_epoch(self) -> None:
        """Die (via _StaleThread, uncatchable by the isolation boundaries)
        if this loop thread was superseded by a watchdog restart — the
        restarted loop may have reassigned our slots, so any further host
        mutation would corrupt a fresh request.  Threads with no recorded
        epoch (watchdog, stop(), callers' threads) always pass."""
        e = getattr(self._tls, "epoch", None)
        if e is not None and e != self._epoch:
            raise _StaleThread(f"epoch {e} superseded by {self._epoch}")

    def _fail_slot(self, slot: int, exc: Exception, shed: bool = False) -> None:
        """Fail ONE slot's request with a typed error and free its
        slot/pages (never into the prefix cache: failed state is suspect);
        the rest of the engine is untouched.  ``shed``: a deadline shed,
        counted apart from failures."""
        self._check_epoch()
        with self._lock:
            rid = self._slot_req.pop(slot, None)
            pending = self._requests.pop(rid, None) if rid is not None else None
        self._release_slot_state(slot)
        self._prefilling.pop(slot, None)
        self.batcher.release(slot)
        if pending is None:
            return
        self._kv.discard_swap(rid)
        if shed:
            self._requests_shed += 1
        else:
            self._requests_failed += 1
        self._retire(pending, "shed" if shed else "failed")
        self._resolve_exception(pending, exc)

    def _fail_unassigned(self, exc: Exception) -> None:
        """Fail every request NOT holding a slot (queued or preempted).
        A C++ queue entry left behind is reaped at admission: pending gone
        -> slot released untouched."""
        with self._lock:
            held = set(self._slot_req.values())
            victims = [(rid, p) for rid, p in self._requests.items()
                       if rid not in held]
            for rid, _ in victims:
                del self._requests[rid]
        for rid, p in victims:
            self._sched.remove(rid)
            self._kv.discard_swap(rid)
            self._requests_failed += 1
            self._retire(p, "failed")
            self._resolve_exception(p, exc)

    def _watchdog(self) -> None:
        """Supervisor: detects a dead loop thread (escaped exception /
        injected death) or one hung inside a single tick past
        hang_timeout_s, fails the in-flight futures, and — when
        watchdog_restart — revives the loop with a fresh decode state."""
        while not self._wd_stop.wait(self.ec.watchdog_interval_s):
            if not self._running or self._draining:
                continue
            t = self._thread
            if t is None:
                continue
            if not t.is_alive():
                self._supervise("loop thread died")
            elif ((self._slot_req or self._requests)
                  and time.monotonic() - self._last_tick_ts > self.ec.hang_timeout_s):
                self._supervise(
                    f"loop hung > {self.ec.hang_timeout_s}s inside one tick")

    def _supervise(self, reason: str) -> None:
        """Fence first: a hung-but-alive thread that wakes later sees the
        epoch mismatch at the loop top, the _tick entry, the pre-dispatch
        checks, or any _commit/_finish/_fail_slot and dies (_StaleThread)
        before mutating host state.  RESIDUAL RISK: a thread blocked INSIDE
        a CUDA call cannot be killed; it wakes past its pre-dispatch fence
        and can still enqueue work on the pools before its next check —
        restart-after-hang is best-effort, and a production deployment
        escalates a repeat offender to a process restart.  Loop DEATH (the
        common case) has no such window."""
        self._epoch += 1
        tids: list = []
        dump_path = None
        if self.ec.telemetry:
            # the postmortem the flight recorder exists for: what the loop
            # was doing when the watchdog had to step in (no lock: the loop
            # may be hung holding state)
            try:
                tids = [p.span.trace_id for p in list(self._requests.values())
                        if p.span is not None]
            except RuntimeError:
                tids = []  # the dict changed under the lock-free snapshot
            self.flight.record(tick=self._ticks, phase="watchdog",
                               slots=list(self._slot_req),
                               rids=list(self._slot_req.values()),
                               trace_ids=tids, shape=None, duration_s=0.0,
                               outcome="supervise", error=reason)
            dump_path = self.flight.dump(
                "watchdog_" + ("restart" if self.ec.watchdog_restart else "halt"),
                extra={"detail": reason, "tick": self._ticks, "trace_ids": tids,
                       "epoch": self._epoch, "restarts": self._restarts})
            self._note_dump(dump_path, tids)
        # incident signal: a watchdog trip IS the engine-local replica death
        self._incident_event("watchdog", detail=reason,
                             restart=self.ec.watchdog_restart,
                             trace_ids=tids, dump=dump_path)
        err = TickFailure(f"engine {reason}; request abandoned by supervisor")
        # drop (never commit) the in-flight pipeline tick: its requests are
        # being failed wholesale, and a readback here — on the watchdog
        # thread, against a possibly-hung dispatch — could block forever
        self._discard_pipeline()
        for slot in list(self._slot_req):
            self._fail_slot(slot, err)
        self._fail_unassigned(err)
        self._sched.clear()
        self._kv.clear_swap()
        self._prefilling.clear()
        self._prefill_rows.clear()
        self._pt_host[:] = 0
        self._len_host[:] = 0
        self._aid_host[:] = 0
        self._tok_host[:] = 0
        self._dec_lens_shadow[:] = 0
        if self.ec.watchdog_restart:
            self._restarts += 1
            self._last_tick_ts = time.monotonic()
            # the revived loop enters inference_mode on its own thread, and
            # rebuilds its device state from the (now empty) committed host
            # mirrors at its first pipelined dispatch
            self._thread = threading.Thread(target=self._loop, args=(self._epoch,),
                                            daemon=True)
            self._thread.start()
        else:
            self._running = False

    @staticmethod
    def _resolve(pending: _Pending, result: dict) -> None:
        """Resolve a request's future with its result and close its stream
        with the same result — once: a path that lost a race with another
        (cancel against the loop) is a no-op."""
        try:
            pending.future.set_result(result)
        except Exception:  # already resolved
            return
        if pending.stream is not None:
            pending.stream.put((None, result))

    @staticmethod
    def _resolve_exception(pending: _Pending, exc: Exception) -> None:
        """``_resolve`` for a typed failure: the stream raises it."""
        try:
            pending.future.set_exception(exc)
        except Exception:  # already resolved
            return
        if pending.stream is not None:
            pending.stream.put((None, exc))
