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

Not ported yet (later slices): disaggregation and the fabric, constrained
decoding, telemetry, the watchdog and hang detection, the dispatch fault
families and incidents, int8 weights, LoRA and tensor parallelism.
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
from ..errors import (DeadlineExceeded, EngineOverloaded, EngineShutdown,
                      NonFiniteLogits, RequestError, SessionBusy,
                      TickFailure)
from .kvstore import (BF16Bits, KVStoreConfig, TieredKVStore, bf16_bits,
                      normalize_session_id)
from .model import (DecoderConfig, decode_step, decode_step_k,
                    decode_step_sample, decode_step_sample_packed,
                    decode_step_verify_sample, make_kv_pool, prefill,
                    prefill_chunk, sample_tokens, write_pages)
from .native import NativeBatcher
from .scheduler import (PRIORITY_RANK, QosScheduler, QueueEntry,
                        SchedulerConfig, normalize_priority)

PREFILL_BUCKETS = (32, 64, 128, 256, 512, 1024)

# a request whose tick phase (prefill group / decode step) raises is retried
# in place; after this many CONSECUTIVE failures it is failed with
# TickFailure (the JAX engine's default max_consecutive_failures)
MAX_CONSECUTIVE_FAILURES = 3
# stop(): how long the graceful drain waits for in-flight slots
DRAIN_TIMEOUT_S = 10.0


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
    # streaming: every committed token is also pushed here, then a final
    # (None, result) or (None, exception) sentinel (generate_stream reads it)
    stream: Optional[queue.Queue] = None


def _page_hashes(tokens: list, page_size: int) -> np.ndarray:
    """Chain hashes for each FULL prompt page, byte for byte the JAX
    engine's ``Engine._page_hashes`` with no adapter: hash(page i) is the
    8-byte blake2b of hash(page i-1) + the page's int32 tokens, so a match
    means an identical token prefix at identical positions; 0 is reserved
    as the no-parent sentinel."""
    n = len(tokens) // page_size
    out = np.zeros((n,), np.uint64)
    prev = b""
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
    """The numpy leaves of a ``(k, v)`` KV blob."""
    return [a for part in blob
            for a in (part.values() if isinstance(part, dict) else (part,))]


def _leaf_to_host(t: torch.Tensor) -> np.ndarray:
    """One device slab as a KV blob leaf on the host (a blocking copy): bf16
    as its raw bits (kvstore.BF16Bits), other dtypes as they are."""
    t = t.cpu()
    if t.dtype == torch.bfloat16:
        return bf16_bits(t.view(torch.int16).numpy())
    return t.numpy()


def _leaf_to_tensor(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A KV blob leaf as a tensor on ``device``; bf16 bits (BF16Bits, or an
    ml_dtypes bfloat16 array) come back by a view, bit for bit."""
    bf16 = isinstance(arr, BF16Bits) or arr.dtype.name == "bfloat16"
    a = np.asarray(arr)
    if bf16:
        a = a.view(np.int16)
    if not (a.flags.writeable and a.flags.c_contiguous):
        a = np.array(a, order="C")  # e.g. read back from a page file
    t = torch.from_numpy(a)
    return (t.view(torch.bfloat16) if bf16 else t).to(device)


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
        """``arr`` as an int32 tensor on the device, copied without blocking
        the host."""
        if not self.cuda:
            return torch.from_numpy(np.array(arr, dtype=np.int32))
        host = self.buf[name]
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
    (default ``"cuda"``; raises without a card — pass ``device="cpu"``)."""

    def __init__(self, params, config: DecoderConfig,
                 engine_config: EngineConfig = EngineConfig(), device=None):
        self.device = resolve_device(device)
        for name, t in params.items():
            if t.device != self.device:
                raise ValueError(f"param {name!r} is on {t.device}, the engine "
                                 f"runs on {self.device}")
        ec = engine_config
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
        for name, _ in self._scfg.adapter_weights:
            # the port serves the base model only: every request is adapter 0
            raise ValueError(f"adapter_weights names unknown adapter {name!r} "
                             "(loaded: [])")
        self._sched = QosScheduler(self._scfg)
        self.batcher = NativeBatcher(ec.max_slots, ec.num_pages, ec.page_size,
                                     ec.max_pages_per_slot)
        c = config
        shape = (c.n_layers, ec.num_pages, c.n_kv_heads, ec.page_size, c.head_dim)
        self._paged = ec.paged_kernel
        self.k_pool = make_kv_pool(shape, ec.kv_quant, device=self.device)
        self.v_pool = make_kv_pool(shape, ec.kv_quant, device=self.device)
        # tiered KV backing store: preemption swap blobs + pinned session
        # KV over host RAM aging to checksummed page files; a stable
        # disk_dir makes pinned sessions survive a full engine restart (the
        # store replays its manifest here)
        self._kv = TieredKVStore(
            ec.kv_store if ec.kv_store is not None
            else KVStoreConfig(host_max_bytes=self._scfg.swap_max_bytes))
        self._requests: dict[int, _Pending] = {}  # guarded-by: _lock
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

    # ---------------------------------------------------------------- public

    def start(self) -> None:
        if self._running and self._thread is not None and self._thread.is_alive():
            return  # idempotent: a second loop on the same pools would race
        self._running = True
        self._draining = False
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self, drain: bool = True) -> None:
        """Graceful drain then hard stop: new submissions are refused
        (EngineShutdown), queued requests are failed with EngineShutdown,
        in-flight slots get up to DRAIN_TIMEOUT_S to finish, then are failed
        too.  ``drain=False`` skips the wait."""
        with self._lock:  # atomic with generate_async's shutdown check
            self._draining = True
        self._fail_unassigned(EngineShutdown("engine stopping"))
        t = self._thread
        if drain and t is not None and t.is_alive():
            deadline = time.monotonic() + DRAIN_TIMEOUT_S
            while self._slot_req and time.monotonic() < deadline:
                time.sleep(0.01)
        self._running = False
        self._wake.set()
        if t is not None:
            t.join(timeout=10)
        # the loop is joined: an uncommitted pipeline tick is dropped with
        # its requests, never committed into a closing batcher
        self._discard_pipeline()
        for slot in list(self._slot_req):
            self._fail_slot(slot, EngineShutdown("engine stopped"))
        self._fail_unassigned(EngineShutdown("engine stopped"))
        self.batcher.close()
        # an ephemeral (auto-tempdir) store deletes its page files; an
        # explicit disk_dir keeps the session manifest for the next engine
        self._kv.close()
        self._stopped = True
        self._draining = False

    def health(self) -> dict:
        """Engine health state machine, as the JAX engine reports it:

        SERVING   — loop thread alive, no distress signal
        DEGRADED  — alive, but a request is mid-retry after tick failures
        DRAINING  — stop() in progress
        DEAD      — loop thread not running (never started, or stopped)

        ``role`` is always "unified" (disaggregation is not ported) and
        ``restarts`` always 0 (no watchdog yet, so no hang detection)."""
        if self._draining:
            state = "DRAINING"
        elif (not self._running or self._thread is None
              or not self._thread.is_alive()):
            state = "DEAD"
        else:
            state = "DEGRADED" if self._retrying > 0 else "SERVING"
        return {"state": state, "role": "unified",
                "last_tick_age_s": round(time.monotonic() - self._last_tick_ts, 4),
                "ticks": self._ticks, "ticks_failed": self._ticks_failed,
                "restarts": 0}

    def generate_async(self, tokens: list[int], max_new_tokens: int = 32,
                       deadline: Optional[float] = None,
                       priority: Optional[str] = None,
                       session_id: Optional[str] = None,
                       stream: Optional[queue.Queue] = None) -> Future:
        """Submit a prompt; the Future resolves to a result dict (``rid``,
        ``tokens``, ``num_tokens``, ``truncated``, ``cancelled``,
        ``preemptions``, ``ttft_s``, ``latency_s``, and a ``session`` block
        with a session id).

        ``deadline``: seconds from now (default ``default_deadline_s``); a
        request without its first token by then is shed with
        DeadlineExceeded.  ``priority``: QoS class — "interactive" (default)
        | "batch" | "best_effort" — deciding admission order and preemption
        standing.  ``session_id``: conversation pin — the finished turn's KV
        pages park in the tiered store under this id and the NEXT turn with
        the same id, whose prompt extends this turn's context, restores
        them instead of re-prefilling.  ``stream``: a queue that receives
        each token id as it is committed, then ``(None, result)`` or
        ``(None, exception)`` (``generate_stream`` reads it).

        Raises RequestError for an empty prompt, a token id outside the
        vocabulary (an out-of-range embedding index would device-assert on
        the card), a bad priority or session id, or a request beyond the
        slot capacity; EngineOverloaded when the queue is at
        ``max_queue_depth``; SessionBusy while the session has a turn in
        flight; EngineShutdown once stop() has begun."""
        if not tokens:
            raise RequestError("empty prompt")
        V = self.config.vocab_size
        if any(not 0 <= int(t) < V for t in tokens):
            raise RequestError(f"token ids must lie in [0, {V})")
        prio = normalize_priority(priority)
        if session_id is not None:
            session_id = normalize_session_id(session_id)
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
            exc = EngineOverloaded(f"queue depth {depth} >= "
                                   f"max_queue_depth {self.ec.max_queue_depth}")
            # load-proportional retry hint, surfaced as Retry-After
            exc.retry_after_s = round(min(
                10.0, 0.25 + 0.1 * depth / max(1, self.ec.max_slots)), 3)
            raise exc
        if deadline is None:
            deadline = self.ec.default_deadline_s
        toks = [int(t) for t in tokens]
        hashes = _page_hashes(toks, self.ec.page_size)
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
            pending = self._requests[rid] = _Pending(
                tokens=toks, max_new_tokens=max_new_tokens, future=fut,
                submitted_at=now, page_hashes=hashes, context=list(toks),
                rid=rid, deadline=now + deadline if deadline is not None else None,
                priority=prio, rank=PRIORITY_RANK[prio], session_id=session_id,
                stream=stream)
            if session_id is not None:
                self._session_active[session_id] = rid
            self._future_rid[fut] = rid
        # the request waits in the HOST scheduler queue; the loop submits it
        # to the C++ core only when the policy admits it
        self._sched.push(self._entry_for(rid, pending))
        self._wake.set()
        return fut

    def _entry_for(self, rid: int, pending: _Pending) -> QueueEntry:
        return QueueEntry(rid=rid, rank=pending.rank, deadline=pending.deadline,
                          submitted_at=pending.submitted_at, adapter_id=0,
                          pages=self._pages_for(len(pending.tokens)))

    def generate(self, tokens: list[int], max_new_tokens: int = 32,
                 timeout: float = 300.0, deadline: Optional[float] = None,
                 priority: Optional[str] = None,
                 session_id: Optional[str] = None) -> dict:
        fut = self.generate_async(tokens, max_new_tokens, deadline=deadline,
                                  priority=priority, session_id=session_id)
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
                        session_id: Optional[str] = None) -> Iterator:
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
                                  stream=q)

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
            self._retire(pending)
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
        self._retire(pending)
        self._resolve(pending, self._result(rid, pending, cancelled=True))
        return True

    def _retire(self, pending: _Pending) -> None:
        """Every terminal path (finish, fail, shed, cancel, reap, stop)
        funnels here exactly once per request: the future index and the
        session-busy entry are released, so a session is never left "in
        flight" by a missed edge."""
        with self._lock:
            self._future_rid.pop(pending.future, None)
            sid = pending.session_id
            if sid is not None and self._session_active.get(sid) == pending.rid:
                del self._session_active[sid]
            if pending.failures:  # no longer mid-retry: it is terminal now
                pending.failures = 0
                self._retrying -= 1

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
                "restarts": 0,  # no watchdog yet
                "requests_failed": self._requests_failed,
                "nan_rows": self._nan_rows,
                **self.batcher.cache_stats(),
            }

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

    def _loop(self) -> None:
        # inference_mode is thread-local: it must be entered on this thread
        with torch.inference_mode():
            while self._running:
                self._ticks += 1
                self._last_tick_ts = time.monotonic()
                try:
                    did_work = self._tick()
                except Exception as exc:  # noqa: BLE001 — loop must survive
                    self._note_group_failure(list(self._slot_req), "tick", exc)
                    time.sleep(0.005)
                    continue
                if not did_work:
                    self._wake.wait(timeout=0.02)
                    self._wake.clear()

    def _tick(self) -> bool:
        """One engine tick: reap expired, admit (policy order, preempting
        when a higher class is blocked), prefill groups, decode.  Each
        compute phase runs inside its own isolation boundary (_isolated)."""
        # eager queue reaping: deadline-expired queued requests shed NOW,
        # not when they reach the admission head
        did_work = self._reap_expired_queue(time.perf_counter())
        # C++-queued leftovers (an admit that failed after its submit last
        # tick — rare; the scheduler queue is the real queue)
        while True:
            admitted = self.batcher.admit()
            if admitted is None:
                break
            did_work = True
            self._install_admitted(admitted)

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
                           self._prefill_short_group, shorts[bucket], bucket)
        for off in sorted(chunked):
            self._isolated("prefill_chunk", chunked[off],
                           self._prefill_chunk_group, chunked[off], off)

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
            if self._pipe_depth > 0:
                if self._spec is not None:
                    self._isolated("verify", decode_ready,
                                   self._decode_tick_spec_pipelined, decode_ready)
                else:
                    self._isolated("decode", decode_ready,
                                   self._decode_tick_pipelined, decode_ready)
                return did_work
            drafts = ({slot: self._draft_for(slot, int(self._len_host[slot]))
                       for slot in decode_ready} if self._spec else {})
            if any(drafts.values()):
                self._isolated("decode", decode_ready,
                               self._decode_tick_speculative, decode_ready, drafts)
            else:
                self._isolated("decode", decode_ready, self._decode_tick_single,
                               decode_ready)
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
        if pending is None:
            # resolved while queued (cancel, stop): release the slot untouched
            self.batcher.release(slot)
            self._kv.discard_swap(rid)
            return
        if pending.cancelled:  # cancelled between submit and admit
            self._kv.discard_swap(rid)
            self._finish(slot, rid, truncated=False, cancelled=True,
                         cache_ok=False)
            return
        if (pending.deadline is not None and not pending.first_token_at
                and time.perf_counter() > pending.deadline):
            # expired while queued: shed before spending any prefill (never
            # after the first token — a preempted request always resumes)
            self._fail_slot(slot, DeadlineExceeded(
                "deadline expired after "
                f"{time.perf_counter() - pending.submitted_at:.3f}s in queue"),
                shed=True)
            return
        if pending.swapped:
            item = self._kv.pop_swap(rid)
            if item is not None:
                try:
                    self._resume_swapped(slot, pending, item)
                    return
                except Exception as exc:  # noqa: BLE001 — fail this slot only
                    # never leave the slot half-installed for decode
                    err = TickFailure(f"swap-in failed: {type(exc).__name__}: {exc}")
                    err.__cause__ = exc
                    self._fail_slot(slot, err)
                    return
            # blob lost (failed verification after a spill): recompute —
            # tokens already hold the full context, a cold re-prefill
            pending.swapped = False
        off = cached * self.ec.page_size
        if pending.session_id is not None and pending.session_restore is None:
            off = self._restore_session(slot, pending, cached)
        self._prefilling[slot] = off
        self._prefill_rows[slot] = self.batcher.slot_pages(slot)

    def _snapshot_pages(self, pages: np.ndarray) -> tuple:
        """Host snapshot of the pools' ``pages`` -> ``(blob, nbytes)``, the
        one device -> host primitive behind swap and session pin: a ``(k,
        v)`` tuple whose parts are numpy ``[layers, n, Hkv, page, hd]``
        slabs (bf16 as raw bits) or the int8 pool's ``{"q", "s"}`` dicts —
        the JAX engine's blob layout.  A blocking copy; the callers run
        after the pipeline fence."""
        idx = torch.from_numpy(np.asarray(pages, np.int64)).to(self.device)
        fetch = lambda leaf: _leaf_to_host(leaf[:, idx])  # noqa: E731
        blob = (_pool_map(fetch, self.k_pool), _pool_map(fetch, self.v_pool))
        return blob, sum(a.nbytes for a in _blob_leaves(blob))

    def _scatter_pages(self, pages: np.ndarray, blob, lo: int, hi: int) -> None:
        """Write a host KV blob's page range ``[lo, hi)`` into the pools at
        device ``pages``, in place — the one host -> device primitive
        behind every restore.  Enqueued on the loop's stream, so it lands
        after any tick already dispatched."""
        idx = torch.from_numpy(np.asarray(pages, np.int64)).to(self.device)

        def put(leaf, host):
            leaf[:, idx] = _leaf_to_tensor(host[:, lo:hi], self.device)

        _pool_map(put, self.k_pool, blob[0])
        _pool_map(put, self.v_pool, blob[1])

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
        try:
            outcome, payload = self._kv.restore_session(pending.session_id)
            if payload is None:
                pending.session_restore = "degraded" if outcome == "corrupt" else "cold"
                return cached * ps
            blob, _, meta = payload
            stored = np.asarray(meta.get("hashes", ()), np.uint64)
            own = pending.page_hashes
            # full pages only, and at least ONE prompt position uncovered so
            # prefill computes the logits of the first sampled token
            limit = min(len(stored), len(own), max(0, (len(pending.tokens) - 1) // ps))
            usable = 0
            while usable < limit and own[usable] == stored[usable]:
                usable += 1
            if usable <= cached:
                # the device cache covers everything the store could offer
                # (or the prompt diverged from the pinned context before it)
                pending.session_restore = "cache" if cached > 0 else "cold"
                return cached * ps
            row = self.batcher.slot_pages(slot)
            self._scatter_pages(row[cached:usable], blob, cached, usable)
            pending.session_restore = outcome  # "host" | "disk"
            self._restored_pages += usable - cached
            self._restored_bytes += sum(a[:, cached:usable].nbytes for a in _blob_leaves(blob))
            return usable * ps
        except Exception:  # noqa: BLE001 — restore must degrade
            pending.session_restore = "degraded"
            return cached * ps

    def _resume_swapped(self, slot: int, pending: _Pending, item) -> None:
        """Swap-in: scatter the evicted KV pages from the store into the
        slot's freshly allocated pages and rebind the host mirrors — the
        slot rejoins decode exactly where it left off (seq_len, page row,
        last committed token), byte-identical under greedy."""
        t0 = time.perf_counter()
        blob, _ = item
        L = pending.resume_len
        owned = self._pages_for(L)
        # swap submits carry no prefix hashes, so every page here is freshly
        # owned by this slot: the scatter never writes a shared cache page
        row = self.batcher.slot_pages(slot)
        self._scatter_pages(row[:owned], blob, 0, owned)
        pending.swapped = False
        self._activate_decode(slot, L, owned, row)
        self._tok_host[slot] = pending.generated[-1]
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
            self._retire(pending)
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
                self._retire(pending)
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
        if mode == "swap" and owned > 0:
            t0 = time.perf_counter()
            blob, nbytes = self._snapshot_pages(self._pt_host[slot, :owned])
            if self._kv.put_swap(rid, blob, nbytes):
                self._swap_out_s += time.perf_counter() - t0
            else:
                mode = "recompute"  # over budget: drop instead
        release_hashes = None
        pending.tokens = list(pending.context)
        if mode == "swap":
            pending.swapped = True
            pending.resume_len = L
        else:
            # drop-and-recompute: the resume prompt is the full committed
            # context; its completed full pages go to the prefix cache
            pending.swapped = False
            pending.page_hashes = _page_hashes(pending.context, ps)
            release_hashes = pending.page_hashes[:max(0, (L - 1) // ps)]
        pending.preemptions += 1
        self._preemptions += 1
        self._preempt_modes[mode] += 1
        self._preempt_reasons[reason] = self._preempt_reasons.get(reason, 0) + 1
        self._reset_failures(pending)
        with self._lock:
            self._slot_req.pop(slot, None)
        self._release_slot_state(slot)
        self.batcher.release(slot, release_hashes)
        self._sched.push(self._entry_for(rid, pending))
        if pending.cancelled:
            # cancel() landed during the swap-out window (it saw the slot
            # still bound and deferred to us): resolve NOW
            self._resolve_queued_cancel(rid, pending)

    def _isolated(self, phase: str, slots: list, fn, *args) -> bool:
        """Isolation boundary around one tick phase: an exception fails only
        ``slots``, and only after MAX_CONSECUTIVE_FAILURES in a row — a
        transient fault retries in place next tick (a failed dispatch
        committed nothing, so greedy decode re-produces the same tokens)."""
        try:
            fn(*args)
            return True
        except Exception as exc:  # noqa: BLE001 — the boundary's whole job
            self._note_group_failure(slots, phase, exc)
            return False

    def _guard_logits(self, logits):
        """(logits, ok) where ok is a device [B]-bool — True iff every logit
        of that row (all K verify rows of a [B, K, V] pass) is finite — or
        None when the guard is disabled."""
        if not self.ec.logit_guard:
            return logits, None
        return logits, torch.isfinite(logits).reshape(logits.shape[0], -1).all(dim=1)

    def _sample(self, logits, ok_dev):
        """One host transfer of the sampled tokens (and the guard)."""
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
        for i, slot in enumerate(slots):
            pending = self._requests[self._slot_req[slot]]
            plen = len(pending.tokens)
            toks[i, :plen] = pending.tokens
            lens[i] = plen
            owned = self._pages_for(plen)
            rows[i, :owned] = self._prefill_rows[slot][:owned]
        logits, pk, pv = prefill(self.params, self.config, self._host(toks),
                                 self._host(lens), ps)
        self._count_prefill(B)
        write_pages(self.k_pool, self.v_pool, pk, pv, self._host(rows))
        sampled, ok = self._sample(*self._guard_logits(logits))
        now = time.perf_counter()
        for i, slot in enumerate(slots):
            if ok is not None and not ok[i]:
                self._fail_nan(slot, "prefill sample row")
                continue
            pending = self._requests[self._slot_req[slot]]
            del self._prefilling[slot]
            plen = int(lens[i])
            self._mark_first_token(pending, now)
            self._activate_decode(slot, plen, self._pages_for(plen),
                                  self._prefill_rows[slot])
            self._commit(slot, int(sampled[i]))

    def _mark_first_token(self, pending: _Pending, now: float) -> None:
        if not pending.first_token_at:
            pending.first_token_at = now

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
        chunk_ids = np.zeros((B, n_chunk), np.int32)
        hist_ids = np.zeros((B, n_hist), np.int32)
        table_rows = {}
        for i, slot in enumerate(slots):
            pending = self._requests[self._slot_req[slot]]
            plen = len(pending.tokens)
            chunk = pending.tokens[off:off + C]
            toks[i, :len(chunk)] = chunk
            lens[i] = plen
            owned = self._pages_for(plen)
            table_rows[slot] = row = self._prefill_rows[slot]
            # pages past the owned range (final-chunk padding) scatter into
            # the reserved trash page 0; reads past `length` are masked
            real = max(0, min(owned - first_page, n_chunk))
            chunk_ids[i, :real] = row[first_page:first_page + real]
            hreal = min(owned, n_hist)
            hist_ids[i, :hreal] = row[:hreal]
        logits, self.k_pool, self.v_pool = prefill_chunk(
            self.params, self.config, self._host(toks), off,
            self._host(lens), self._host(chunk_ids), self._host(hist_ids),
            self.k_pool, self.v_pool, ps)
        self._count_prefill(B)
        finishing = [i for i in range(B) if off + C >= int(lens[i])]
        ok = None
        if finishing:
            # rows mid-prompt get sampled too (their values are unused) —
            # still one transfer in total
            sampled, ok = self._sample(*self._guard_logits(logits))
            now = time.perf_counter()
        for i, slot in enumerate(slots):
            if i not in finishing:
                self._prefilling[slot] = off + C
                # an advanced chunk IS progress for the failure cap
                self._reset_failures(self._requests[self._slot_req[slot]])
                continue
            if ok is not None and not ok[i]:
                self._fail_nan(slot, "chunked-prefill sample row")
                continue
            pending = self._requests[self._slot_req[slot]]
            del self._prefilling[slot]
            plen = int(lens[i])
            self._mark_first_token(pending, now)
            self._activate_decode(slot, plen, self._pages_for(plen),
                                  table_rows[slot])
            self._commit(slot, int(sampled[i]))

    def _decode_tick_single(self, decode_ready) -> None:
        """One decode step over ALL slots (inactive and prefilling rows hold
        len 0 and the trash page), the NaN guard, one batched sample, and
        the commits."""
        logits, self.k_pool, self.v_pool = decode_step(
            self.params, self.config, self._host(self._tok_host),
            self._host(self._len_host), self._host(self._pt_host),
            self.k_pool, self.v_pool, paged=self._paged)
        self._decode_steps += 1
        sampled, ok = self._sample(*self._guard_logits(logits))
        for slot in decode_ready:
            if ok is not None and not ok[slot]:
                self._fail_nan(slot, f"decode row (slot {slot})")
                continue
            self._commit(slot, int(sampled[slot]))

    # ------------------------------------------------- pipelined decode loop

    def _mark_roster_change(self, reason: str) -> None:
        """A slot joined or left the decode roster: the next pipelined
        dispatch must drain and rebuild device state first.  ``reason``
        labels that fence (the first recorded cause wins until consumed,
        except that "nan" overrides a pending mundane one: it is the label a
        postmortem looks for)."""
        if self._dirty_reason is None or reason == "nan":
            self._dirty_reason = reason
        self._roster_dirty = True

    def _count_fence(self, reason: str) -> None:
        self._fences += 1
        self._fence_reasons[reason] = self._fence_reasons.get(reason, 0) + 1

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
        self._commit_inflight(rec)

    def _discard_pipeline(self) -> None:
        """Drop pipeline state WITHOUT committing: on stop() the in-flight
        tick's requests are failed wholesale; after a failed tick the state
        is suspect, and the retry rebuilds from committed host state (greedy
        re-derives any dropped in-flight token byte-identically)."""
        self._inflight = None
        self._dec_state = None
        self._roster_dirty = True

    def _fence(self, reason: str, st: _Staging) -> list:
        """Drain the pipeline at a fence labelled ``reason`` and rebuild the
        device state from the host mirrors.  Returns the slots still ready
        to decode (the drain's commits may finish or fail rows)."""
        self._drain_pipeline(reason)
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

    def _sync_fallback(self) -> None:
        """Pool exhausted at the lookahead: drain, then run this tick through
        the sync path, whose commit-time OOM truncates the right row; the
        device state rebuilds next tick."""
        self._drain_pipeline("pool")
        decode_ready = self._ready_now()
        if decode_ready:
            self._decode_tick_single(decode_ready)

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
        copy was started at dispatch)."""
        rec["staging"].wait()
        return rec["out"].numpy().copy()

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
        for slot in rec["slots"]:
            rid = rec["rids"][slot]
            if self._slot_req.get(slot) != rid or rid not in self._requests:
                continue  # finished behind the dispatch
            tok = int(sampled[slot])
            if tok < 0:  # guard encoding: -token - 1 == non-finite row
                self._fail_nan(slot, f"pipelined decode row (slot {slot})")
                continue
            self._commit(slot, tok)

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

    def _decode_tick_pipelined(self, decode_ready) -> None:
        """One pipelined decode tick: fence if the roster changed, reserve
        lookahead pages, dispatch the fused step (the device consumes its
        own previous output), start the token readback, then commit the
        PREVIOUS tick's tokens while this one runs."""
        try:
            st = self._acquire_staging()
            decode_ready = self._fence_if_dirty(decode_ready, st)
            if not decode_ready:
                return
            if not self._reserve_lookahead(decode_ready):
                self._sync_fallback()
                return
            sampled, self.k_pool, self.v_pool = decode_step_sample(
                self.params, self.config, self._dec_state,
                st.upload("lens", self._dec_lens_shadow),
                st.upload("table", self._pt_host), self.k_pool, self.v_pool,
                self._gen, None, temperature=self.ec.temperature,
                guard=self.ec.logit_guard, paged=self._paged)
            self._decode_steps += 1
            rec = {"staging": st, "out": st.read_back("sampled", sampled),
                   "slots": tuple(decode_ready),
                   "rids": {s: self._slot_req[s] for s in decode_ready}}
            prev, self._inflight = self._inflight, rec
            self._dec_state = sampled
            shadow = self._dec_lens_shadow
            self._dec_lens_shadow = np.where(shadow > 0, shadow + 1, 0).astype(np.int32)
            if prev is not None:
                # commit-behind: tick N lands while tick N+1 runs
                self._commit_inflight(prev)
        except BaseException:
            self._discard_pipeline()
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
        for slot in rec["slots"]:
            rid = rec["rids"][slot]
            if self._slot_req.get(slot) != rid or rid not in self._requests:
                continue  # finished behind the dispatch
            pending = self._requests[rid]
            toks = rec["staged"].get(slot)
            staged = toks is not None
            if not staged:
                toks = self._accepted_row(pending, packed[slot])
            if not toks:
                rec["staged"].pop(slot, None)
                self._fail_nan(slot, f"fused verify row (slot {slot})")
                continue
            self._spec_proposed += len(rec["drafts"].get(slot) or ())
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
            # accepted drafts = committed minus the bonus/correction token
            self._spec_accepted += max(0, committed - 1)

    def _decode_tick_spec_pipelined(self, decode_ready) -> None:
        """One pipelined SPECULATIVE tick: fence if the roster changed, read
        back the previous verify tick's packed tokens and stage them, draft
        from the staged context, reserve up to K lookahead pages per slot,
        dispatch the fused verify (the device derives its committed-token
        feedback from the previous packed output), then commit the PREVIOUS
        tick's 1..K tokens per slot while this one runs."""
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
            if by_slot:
                packed, self.k_pool, self.v_pool = decode_step_verify_sample(
                    self.params, self.config, self._dec_state,
                    st.upload("drafts", drafts), st.upload("dlen", dlen), lens,
                    table, self.k_pool, self.v_pool, self._gen, None,
                    temperature=self.ec.temperature, guard=self.ec.logit_guard,
                    paged=self._paged)
            else:
                # no drafts anywhere: the single-token step (the sync loop's
                # no-draft dispatch, same numerics) on the packed edge
                packed, self.k_pool, self.v_pool = decode_step_sample_packed(
                    self.params, self.config, self._dec_state, lens, table,
                    self.k_pool, self.v_pool, self._gen, None,
                    temperature=self.ec.temperature, guard=self.ec.logit_guard,
                    paged=self._paged)
            self._decode_steps += 1
            self._inflight = {
                "kind": "spec", "staging": st, "out": st.read_back("packed", packed),
                "slots": tuple(decode_ready),
                "rids": {s: self._slot_req[s] for s in decode_ready},
                "drafts": by_slot, "staged": {}}
            self._dec_state = packed
            if prev is not None:
                # commit-behind: tick N's 1..K tokens per slot land while
                # tick N+1 runs
                self._commit_inflight(prev)
        except BaseException:
            # un-stage context tokens the commit-behind never landed, so the
            # retry re-derives them
            if staged_rec is not None:
                for slot, toks in staged_rec.get("staged", {}).items():
                    p = self._requests.get(staged_rec["rids"].get(slot))
                    if p is not None and toks:
                        del p.context[-len(toks):]
            self._discard_pipeline()
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
        return self._lookup_draft(pending, min(self.ec.spec_max_draft, room, budget))

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

    def _decode_tick_speculative(self, decode_ready, drafts) -> None:
        """One verify pass over [last token + drafts] for every ready slot;
        commit the longest draft prefix matching greedy argmax plus the
        bonus token of the first non-matching row.  Rejected draft KV stays
        masked and is overwritten by a later row-0 write."""
        K = self._k
        tokens = np.zeros((self.ec.max_slots, K), np.int32)
        for slot in decode_ready:
            tokens[slot, 0] = self._tok_host[slot]
            d = drafts.get(slot) or []
            tokens[slot, 1:1 + len(d)] = d
        logits, self.k_pool, self.v_pool = decode_step_k(
            self.params, self.config, self._host(tokens),
            self._host(self._len_host), self._host(self._pt_host),
            self.k_pool, self.v_pool, paged=self._paged)
        self._decode_steps += 1
        logits, ok_dev = self._guard_logits(logits)
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
            if ok is not None and not ok[slot]:
                # any of the slot's K verify rows non-finite: fail the slot
                # before committing anything from the pass
                self._fail_nan(slot, f"speculative verify (slot {slot})")
                continue
            d = drafts.get(slot) or []
            self._spec_proposed += len(d)
            for j in range(len(d) + 1):
                tok = int(sampled[slot, j])
                if self._commit(slot, tok) != 1:
                    break  # finished / truncated: the slot is released
                # logits[j+1] is valid only if the input at that row (draft
                # j) is what greedy produced
                if j >= len(d) or d[j] != tok:
                    break
                self._spec_accepted += 1

    # --------------------------------------------------------- slot lifecycle

    def _activate_decode(self, slot: int, plen: int, owned: int, row) -> None:
        """Prefill finished: install the slot's page row + length into the
        host mirrors, making it visible to the decode step — a roster
        change for the pipeline."""
        self._pt_host[slot, :owned] = row[:owned]
        self._len_host[slot] = plen
        self._prefill_rows.pop(slot, None)
        self._mark_roster_change("admit")

    def _commit(self, slot: int, token: int, ctx: bool = True) -> int:
        """Record one generated token; returns the batcher rc (1 = keep
        decoding; anything else means the slot was finished+released).
        ``ctx=False``: the pipelined speculative readback already staged
        the token into ``pending.context``."""
        rid = self._slot_req[slot]
        pending = self._requests[rid]
        self._reset_failures(pending)
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
        """Zero one slot's host mirrors; every release path funnels here,
        and a release is a roster change for the pipeline."""
        self._pt_host[slot, :] = 0
        self._len_host[slot] = 0
        self._tok_host[slot] = 0
        self._prefill_rows.pop(slot, None)
        self._mark_roster_change("finish")

    def _finish(self, slot: int, rid: int, truncated: bool,
                cancelled: bool = False, cache_ok: bool = True) -> None:
        """Resolve a slot's request and free the slot.  ``cache_ok=False``
        (cancelled mid-prefill): the pages hold partial KV and are neither
        cached nor pinned."""
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
        self._release_slot_state(slot)
        # the prompt's full pages enter the prefix cache on the way out,
        # unless the prefill never finished (their KV is partial) or the
        # session pinned them: then they live in the tiered store instead
        release_hashes = pending.page_hashes if cache_ok else None
        if session is not None and session.get("pinned"):
            release_hashes = None
        self.batcher.release(slot, release_hashes)
        self._retire(pending)
        result = self._result(rid, pending, truncated, cancelled)
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
        self._resolve(pending, result)

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
            return {"pinned": False,
                    "reason": "committed context shorter than one page"}
        try:
            blob, nbytes = self._snapshot_pages(self._pt_host[slot, :covered])
            hashes = _page_hashes(pending.context, ps)[:covered]
            meta = {"hashes": [int(h) for h in hashes],
                    "context_len": len(pending.context),
                    "adapter_id": 0, "pages": covered}
            return self._kv.pin_session(pending.session_id, blob, nbytes, meta)
        except Exception as exc:  # noqa: BLE001 — a pin must not fail the turn
            return {"pinned": False, "reason": f"{type(exc).__name__}: {exc}"}

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
        for slot in list(slots):
            rid = self._slot_req.get(slot)
            pending = self._requests.get(rid) if rid is not None else None
            if pending is None:
                continue
            with self._lock:
                pending.failures += 1
                if pending.failures == 1:
                    self._retrying += 1
            if pending.failures >= MAX_CONSECUTIVE_FAILURES:
                err = TickFailure(
                    f"rejected after {pending.failures} consecutive "
                    f"{phase} failures (last: {type(exc).__name__}: {exc})")
                err.__cause__ = exc
                self._fail_slot(slot, err)

    def _fail_nan(self, slot: int, where: str) -> None:
        """NaN-guard trip: fail the poisoned slot with NonFiniteLogits."""
        self._nan_rows += 1
        self._mark_roster_change("nan")  # before the release's "finish"
        self._fail_slot(slot, NonFiniteLogits(f"non-finite logits in {where}"))

    def _fail_slot(self, slot: int, exc: Exception, shed: bool = False) -> None:
        """Fail ONE slot's request with a typed error and free its
        slot/pages (never into the prefix cache: failed state is suspect);
        the rest of the engine is untouched.  ``shed``: a deadline shed,
        counted apart from failures."""
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
        self._retire(pending)
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
            self._retire(p)
            self._resolve_exception(p, exc)

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
