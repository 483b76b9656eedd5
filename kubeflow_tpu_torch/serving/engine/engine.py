"""The inference engine: C++ batcher + PyTorch paged prefill/decode loop.

Counterpart of ``kubeflow_tpu/serving/engine/engine.py``, reduced to its
synchronous loop (``pipeline_depth=0``, the JAX package's parity oracle).
Request admission, slot lifecycle and KV page accounting live in the C++
core (core.cc via native.py); this module runs the loop on the device:

    loop:
      admit queued requests into free slots, FIFO through the core's queue
        (the core decides whether the prompt's pages fit, all-or-nothing)
      group prefilling slots (short prompts by bucket, long ones by chunk
        offset) -> ONE prefill per group -> one KV-page scatter -> one
        batched first-token sample per group
      one decode_step over ALL slots, the NaN guard, one batched sample
      commit sampled tokens (C++ grows pages; reports finish/OOM), finish
        and release pages

With ``paged_kernel=True`` (the default here) decode attention runs through
``paged_attention``: the hand-written Hopper kernel on a CUDA pool, its
plain version on a CPU pool.  ``paged_kernel=False`` keeps the gather path
that the JAX engine runs by default.

Not ported yet (later slices): the pipelined loop, QoS scheduling and
preemption, the prefix cache, speculative decoding, sessions and the tiered
KV store, disaggregation and the fabric, constrained decoding, telemetry,
faults and incidents, int8 weights, LoRA and tensor parallelism.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import Future
from typing import Optional, Tuple

import numpy as np
import torch

from ...utils.device import resolve_device
from ..errors import (EngineShutdown, NonFiniteLogits, RequestError,
                      TickFailure)
from .model import (DecoderConfig, decode_step, make_kv_pool, prefill,
                    prefill_chunk, sample_tokens, write_pages)
from .native import NativeBatcher

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
        if engine_config.prefill_chunk % engine_config.page_size != 0:
            raise ValueError("prefill_chunk must be a multiple of page_size")
        self.params = params
        self.config = config
        self.ec = engine_config
        # full stop set: primary eos_id (if any) plus the multi-EOS extras
        self._stop_ids = frozenset(
            i for i in (engine_config.eos_id,) + tuple(engine_config.eos_ids)
            if i >= 0)
        self.batcher = NativeBatcher(
            engine_config.max_slots, engine_config.num_pages,
            engine_config.page_size, engine_config.max_pages_per_slot,
        )
        c = config
        shape = (c.n_layers, engine_config.num_pages, c.n_kv_heads,
                 engine_config.page_size, c.head_dim)
        self._paged = engine_config.paged_kernel
        self.k_pool = make_kv_pool(shape, device=self.device)
        self.v_pool = make_kv_pool(shape, device=self.device)
        self._requests: dict[int, _Pending] = {}  # guarded-by: _lock
        self._slot_req: dict[int, int] = {}
        self._prefilling: dict[int, int] = {}  # slot -> next prompt offset
        # Host-side mirrors of the C++ slot state, grown incrementally
        # (slot_pages row at admission + commit_token_ex page grants) so the
        # decode loop never re-snapshots max_slots x max_pages from C per
        # tick.  Rows/lens are LIVE only for decode-ready slots — they stay
        # zero (trash page, len 0) while a slot is prefilling, so the decode
        # step's unconditional KV write cannot touch its pages.
        self._pt_host = np.zeros(
            (engine_config.max_slots, engine_config.max_pages_per_slot), np.int32)
        self._len_host = np.zeros((engine_config.max_slots,), np.int32)
        # last committed token per slot: the next decode step's input
        self._tok_host = np.zeros((engine_config.max_slots,), np.int32)
        self._prefill_rows: dict[int, np.ndarray] = {}  # slot -> page row
        self._next_id = 0
        self._lock = threading.Lock()
        self._running = False
        self._draining = False
        self._stopped = False
        self._thread: Optional[threading.Thread] = None
        self._wake = threading.Event()
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(engine_config.seed)
        self._prefill_dispatches = 0
        self._prefill_rows_total = 0
        self._prefill_batch_hist: dict[int, int] = {}
        self._decode_steps = 0
        self._ticks = 0
        self._ticks_failed = 0
        self._requests_failed = 0
        self._nan_rows = 0

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
        for slot in list(self._slot_req):
            self._fail_slot(slot, EngineShutdown("engine stopped"))
        self._fail_unassigned(EngineShutdown("engine stopped"))
        self.batcher.close()
        self._stopped = True
        self._draining = False

    def health(self) -> dict:
        """SERVING (loop alive) / DRAINING (stop in progress) / DEAD."""
        if self._draining:
            state = "DRAINING"
        elif (not self._running or self._thread is None
              or not self._thread.is_alive()):
            state = "DEAD"
        else:
            state = "SERVING"
        return {"state": state, "ticks": self._ticks,
                "ticks_failed": self._ticks_failed}

    def generate_async(self, tokens: list[int], max_new_tokens: int = 32) -> Future:
        """Submit a prompt; the Future resolves to a result dict (``rid``,
        ``tokens``, ``num_tokens``, ``truncated``, ``cancelled``, ``ttft_s``,
        ``latency_s``).  Raises RequestError for an empty prompt, a token id
        outside the vocabulary (an out-of-range embedding index would
        device-assert on the card) or a request beyond the slot capacity,
        and EngineShutdown once stop() has begun."""
        if not tokens:
            raise RequestError("empty prompt")
        V = self.config.vocab_size
        if any(not 0 <= int(t) < V for t in tokens):
            raise RequestError(f"token ids must lie in [0, {V})")
        if self._draining or self._stopped:
            raise EngineShutdown("engine is stopping")
        if (self._pages_for(len(tokens) + max_new_tokens)
                > self.ec.max_pages_per_slot
                or self._pages_for(len(tokens)) >= self.ec.num_pages):
            raise RequestError(
                f"prompt+generation ({len(tokens)}+{max_new_tokens}) exceeds engine capacity "
                f"({self.ec.max_pages_per_slot * self.ec.page_size} tokens/slot)"
            )
        fut: Future = Future()
        with self._lock:
            # shutdown check is atomic with registration: stop() flips
            # _draining under this lock BEFORE failing unassigned work
            if self._draining or self._stopped:
                raise EngineShutdown("engine is stopping")
            rid = self._next_id
            self._next_id += 1
            pending = self._requests[rid] = _Pending(
                tokens=[int(t) for t in tokens], max_new_tokens=max_new_tokens,
                future=fut, submitted_at=time.perf_counter())
            # FIFO admission through the C++ core's own queue; registered
            # first so the loop's admit always finds the pending record
            ok = self.batcher.submit(rid, len(pending.tokens),
                                     max(1, max_new_tokens))
            if not ok:
                del self._requests[rid]
        if not ok:
            raise RequestError(
                f"prompt+generation ({len(tokens)}+{max_new_tokens}) exceeds "
                "engine capacity")
        self._wake.set()
        return fut

    def generate(self, tokens: list[int], max_new_tokens: int = 32,
                 timeout: float = 300.0) -> dict:
        return self.generate_async(tokens, max_new_tokens).result(timeout=timeout)

    @property
    def stats(self) -> dict:
        with self._lock:
            return {
                "active_slots": self.batcher.num_active,
                "queue_depth": self.batcher.queue_depth,
                "free_pages": self.batcher.free_pages,
                "prefill_dispatches": self._prefill_dispatches,
                "prefill_rows": self._prefill_rows_total,
                "prefill_batch_hist": dict(self._prefill_batch_hist),
                "decode_steps": self._decode_steps,
                "ticks": self._ticks,
                "ticks_failed": self._ticks_failed,
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
        """A host array as a tensor on the engine's device."""
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
        """One engine tick: admit, prefill groups, decode.  Each compute
        phase runs inside its own isolation boundary (_isolated)."""
        did_work = False
        while True:
            admitted = self.batcher.admit()
            if admitted is None:
                break
            did_work = True
            self._install_admitted(admitted)

        shorts: dict[int, list] = {}
        chunked: dict[int, list] = {}
        for slot in list(self._prefilling):
            did_work = True
            pending = self._requests.get(self._slot_req.get(slot))
            if pending is None:  # failed out from under us: reclaim
                self._fail_slot(slot, TickFailure("orphaned prefill slot"))
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
            if self._requests.get(self._slot_req.get(slot)) is None:
                did_work = True
                decode_ready.remove(slot)
                self._fail_slot(slot, TickFailure("orphaned decode slot"))
        if decode_ready:
            did_work = True
            self._isolated("decode", decode_ready, self._decode_tick_single,
                           decode_ready)
        return did_work

    def _install_admitted(self, admitted) -> None:
        """Bind one C++ admission to its request and queue it for prefill."""
        slot, rid, plen, _, cached = admitted
        with self._lock:
            pending = self._requests.get(rid)
            if pending is not None:
                self._slot_req[slot] = rid
        if pending is None:
            # failed while queued (stop): release the slot untouched
            self.batcher.release(slot)
            return
        self._prefilling[slot] = cached * self.ec.page_size
        self._prefill_rows[slot] = self.batcher.slot_pages(slot)

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
        of that row is finite — or None when the guard is disabled."""
        if not self.ec.logit_guard:
            return logits, None
        return logits, torch.isfinite(logits).all(dim=-1)

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

    # --------------------------------------------------------- slot lifecycle

    def _activate_decode(self, slot: int, plen: int, owned: int, row) -> None:
        """Prefill finished: install the slot's page row + length into the
        host mirrors, making it visible to the decode step."""
        self._pt_host[slot, :owned] = row[:owned]
        self._len_host[slot] = plen
        self._prefill_rows.pop(slot, None)

    def _commit(self, slot: int, token: int) -> int:
        """Record one generated token; returns the batcher rc (1 = keep
        decoding; anything else means the slot was finished+released)."""
        rid = self._slot_req[slot]
        pending = self._requests[rid]
        self._reset_failures(pending)
        pending.generated.append(token)
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
        """Zero one slot's host mirrors; every release path funnels here."""
        self._pt_host[slot, :] = 0
        self._len_host[slot] = 0
        self._tok_host[slot] = 0
        self._prefill_rows.pop(slot, None)

    def _finish(self, slot: int, rid: int, truncated: bool) -> None:
        with self._lock:
            pending = self._requests.pop(rid, None)
            self._slot_req.pop(slot, None)
        self._release_slot_state(slot)
        # no prefix-hash submission in this port yet, so pages free outright
        self.batcher.release(slot)
        if pending is None:
            return
        now = time.perf_counter()
        pending.future.set_result({
            "rid": rid,
            "tokens": pending.generated,
            "num_tokens": len(pending.generated),
            "truncated": truncated,
            "cancelled": False,
            "ttft_s": (pending.first_token_at - pending.submitted_at
                       if pending.first_token_at else 0.0),
            "latency_s": now - pending.submitted_at,
        })

    def _reset_failures(self, pending: _Pending) -> None:
        pending.failures = 0

    def _note_group_failure(self, slots: list, phase: str, exc: Exception) -> None:
        self._ticks_failed += 1
        for slot in list(slots):
            rid = self._slot_req.get(slot)
            pending = self._requests.get(rid) if rid is not None else None
            if pending is None:
                continue
            pending.failures += 1
            if pending.failures >= MAX_CONSECUTIVE_FAILURES:
                err = TickFailure(
                    f"rejected after {pending.failures} consecutive "
                    f"{phase} failures (last: {type(exc).__name__}: {exc})")
                err.__cause__ = exc
                self._fail_slot(slot, err)

    def _fail_nan(self, slot: int, where: str) -> None:
        """NaN-guard trip: fail the poisoned slot with NonFiniteLogits."""
        self._nan_rows += 1
        self._fail_slot(slot, NonFiniteLogits(f"non-finite logits in {where}"))

    def _fail_slot(self, slot: int, exc: Exception) -> None:
        """Fail ONE slot's request with a typed error and free its
        slot/pages; the rest of the engine is untouched."""
        with self._lock:
            rid = self._slot_req.pop(slot, None)
            pending = self._requests.pop(rid, None) if rid is not None else None
        self._release_slot_state(slot)
        self._prefilling.pop(slot, None)
        self.batcher.release(slot)
        if pending is None:
            return
        self._requests_failed += 1
        self._resolve_exception(pending, exc)

    def _fail_unassigned(self, exc: Exception) -> None:
        """Fail every request NOT holding a slot (still queued).  Their C++
        queue entries are reaped at admission: pending gone -> slot
        released untouched."""
        with self._lock:
            held = set(self._slot_req.values())
            victims = [(rid, p) for rid, p in self._requests.items()
                       if rid not in held]
            for rid, _ in victims:
                del self._requests[rid]
        for _, p in victims:
            self._requests_failed += 1
            self._resolve_exception(p, exc)

    @staticmethod
    def _resolve_exception(pending: _Pending, exc: Exception) -> None:
        try:
            pending.future.set_exception(exc)
        except Exception:  # already resolved
            pass
