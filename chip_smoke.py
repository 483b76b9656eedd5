#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py [--out results.json]

Run from the repository root on a machine with one card, ``nvcc`` (under
``$CUDA_HOME`` or ``/usr/local/cuda``) and ``g++``.  Every phase must pass
or the script exits non-zero:

1. device: the card's name and its ``nvidia-smi`` name and power limit;
2. build: the Hopper paged-attention kernel (nvcc, sm_90a) and the C++
   batcher core, from the sources in this checkout, timed;
3. kernel: ``paged_attention`` on the card against its plain PyTorch
   version at the Llama-3-8B decode shapes (B=8, Hq=32, Hkv=8, hd=128,
   page 32, 64 pages per slot), bf16 and int8 pools, K = 1 and 5, ragged
   lengths with an idle slot, partial last pages and a full 2048-token slot;
   times of the kernel (CUDA events around the call, and the device time of
   its split and merge kernels in a torch.profiler window), the plain
   version, ``scaled_dot_product_attention`` over the already-gathered
   cache (a yardstick the port never calls) and the device-memory bound;
   at K = 1 also the kernel at 2, 4, 8 and 16 pages per split;
4. decode: one full-width Llama-3-8B ``decode_step`` with ``paged=True``
   against ``paged=False`` (the gather path) on the same pool state;
5. main path: ``model.init(llama3_8b)`` -> ``Engine`` -> ``JetStreamModel``
   -> ``ModelServer`` on 127.0.0.1 answering 4 concurrent
   ``/v2/models/llama3-8b/generate`` requests (two long enough for the
   chunked prefill) with ``EngineConfig()`` defaults (the pipelined loop and
   the prefix cache) and on the sync loop (``pipeline_depth=0``), in turns
   (pipelined, sync, sync, pipelined); each run checked for 32 tokens per
   request, for the paged kernel's launches (counted from zero for the run:
   one per layer and decode step; its plain version never called), for
   leaked KV pages and, request by request, against the ``forward_full``
   oracle; TTFT, tokens/s and the leading tokens the first two runs share;
5b. speculative: the same requests with ``speculative="prompt_lookup"``
   (pipelined), the same checks, plus drafts proposed and the paged kernel
   launched at K = 5 query rows per slot; the accept rate;
5c. prefix cache: one 1000-byte prompt twice in a row, the second
   admission adopting the first's cached pages; both TTFTs;
5d. QoS: on ``EngineConfig(max_slots=2)`` two batch-class requests (700-byte
   prompts, 160 new tokens) fill both slots and an interactive one (200
   bytes, 32 tokens) arrives once the first has committed 32 tokens, under
   priority scheduling with swap preemption, with recompute preemption,
   with swap on the int8 KV pool, and under the fifo baseline without
   preemption; the interactive request's TTFT under each, the victim's
   preemption mode, swapped bytes and swap-out/in ms, its tokens against
   its run alone (all identical under swap), every token's oracle lag, no
   page or store byte left at drain, and a ``deadline_s=0.05`` request
   queued behind both slots answered 504;
5e. sessions: a three-turn session over HTTP (16 new tokens a turn,
   contexts of about 600, 900 and 1200 bytes) on the host tier, on the disk
   tier, and turns 2-3 on a fresh engine restoring from the disk run's
   manifest, each turn against its context run cold on a fresh engine:
   restore tier, pages and bytes restored, warm vs cold TTFT, identical
   leading tokens, oracle lag;
5f. streaming: the surfaces the ingress calls, over HTTP on ``EngineConfig()``:
   the four prompts as concurrent ``generate_stream`` requests with
   ``X-Stream-Resume: 1`` (each stream's text equal to the decoding of its
   own token ids, ``tokens`` equal to 32, every token within the oracle
   bound, the identical leading tokens against the same prompts' unary
   run; client time to the first event against the engine's ``ttft_s``,
   p50/p99 gaps between events against the engine's ms per decode step),
   the same streams on ``speculative="prompt_lookup"`` (the kernel at K =
   5 inside a stream), a client that hangs up after 8 events and
   re-submits with ``resume_token_ids`` (the whole within the oracle bound,
   the re-prefill's page hits, its TTFT; no page leaked), one OpenAI chat
   stream (``delta.role`` first, ``data: [DONE]`` last), ``/metrics``
   parsed to its load gauges, and ``/engine/health`` through SERVING,
   DRAINING (503, while ``stop()`` drains a stream) and DEAD;
5g. observability and supervision, at full Llama-3-8B: (a) the four
   prompts over HTTP with ``X-Request-Trace: 1`` and a minted
   ``traceparent`` each: the span's phases queued -> admitted -> prefill ->
   first_token -> done, the trace id adopted, ``/engine/trace/<id>`` holding
   the span, ``/engine/waterfall/<rid>`` segments summing to its wall
   within 1 ms, ``/engine/latency`` naming the class, ``/metrics`` counting
   every served request's TTFT; (b) ``/engine/perf``: the platform label and
   peak of the card's kind, MFU > 0, goodput in (0, 1], and the median host
   ms per tick of each timeline phase; (c) ``POST /engine/profile {"ticks":
   8}`` while the four decode: no error, and the Chrome trace holding
   exactly 2 paged kernel records (split + merge) per layer per decode tick
   of the window; (d) the four prompts with telemetry off and on, in turns:
   identical tokens, host ms per tick and tokens/s of each (not gated); (e)
   ``die_on_tick`` mid-decode: the requests fail with TickFailure, the
   watchdog restarts the loop (time from the dead loop's last tick to the
   new loop's first), a ``watchdog_restart`` flight dump, then a request
   within the oracle bound through the kernel and no page leaked; a tick
   stalled past ``hang_timeout_s`` reads DEGRADED, is restarted, and its
   superseded thread exits; (f) a NaN aimed at one request's decode rows
   fails only it (NonFiniteLogits; an HTTP probe 500) while the others give
   their unpoisoned tokens, and a dispatch error on every tick escalates
   to TickFailure after ``max_consecutive_failures`` with a
   ``tick_failure_escalation`` dump; (g) the die-on-tick run's one
   ``replica_death`` incident on ``/engine/incidents``, its bundle on disk;
5h. disaggregation and the fleet KV fabric, at full Llama-3-8B: replica A
   (``role="prefill"``, ``fabric=True``) and B (``role="decode"``,
   ``fabric=True``) share one params dict, each behind its own
   ``ModelServer``, and the script splits requests by hand as the reference
   ingress does: (a) phase 5's four prompts as SSE streams on B (the
   unified baseline), then each prefill phase on A (``kv_handoff``) and
   each decode phase on B (``handoff``, SSE): every token within the oracle
   bound, the count byte-identical to the baseline, B's
   ``prefill_dispatches`` 0, 4 imports, one paged launch per layer and
   decode step on B, none plain; export ms and frame bytes on A, pull ms
   and scatter ms on B, the decode phase's first event against the
   unified one; (b) a repull of a handle answers 404, and on the fault
   replicas A2 and B2 a torn pull, a dead link, a slow pull (which, as in
   the JAX package, completes as an import) and an expired export, each
   completing within the bound, the degraded ones with
   ``handoff_degraded`` waste; (c) A serves a 31-page prompt and
   ``/engine/perf`` lists its key with 31 pages; B serves it with the
   ``fabric`` hint (``restore: hit``) between two cold runs of the same
   length, and B2's torn pull and a pull past the pull budget degrade with
   ``fabric_degraded`` waste; (d) no page leaked, no handoff frame pending,
   no parked fabric frame and no swap byte left on any of the four;
6. profile: one main-path decode step (8 slots, the served lengths), paged
   and gather in turns on the host clock, and a torch.profiler window for
   device busy time by kernel family and the device's idle share; then the
   engine's own loop at ``pipeline_depth`` 1 and 0 with the four prompts
   decoding: host ms per tick, the device idle share (the step's device
   time over the tick), and the host calls that wait on the device per
   tick (the pipelined loop must block on no copy and no stream);
6b. runtime: with Llama-3-8B freed, ``python -m
   kubeflow_tpu_torch.serving.runtime_main --loader jetstream`` as a
   subprocess on a model dir holding Llama-3-8B's ``config.json`` (random
   init on the card) and an ``engine.json`` with ``scheduler`` and
   ``kv_store`` blocks: time to ``/v2/health/ready``, one unary generate,
   one stream and ``/engine/health``, all 200, no traceback, and an exit
   after the terminate (its kernel launches are not readable from here);
7. flash kernel: ``flash_attention``'s forward kernel on the card against
   ``flash_attention_plain`` at the BERT-base shapes (B=32, H=12, S=T=512,
   d=64, bf16; blocks 128): non-causal with a ragged key mask, causal, and
   causal with a left-padded row that sees no key, plus one f32 case at
   S=128; out and lse compared; times of the kernel (CUDA events and a
   torch.profiler window), the plain version and
   ``scaled_dot_product_attention`` with the same boolean mask (a yardstick
   the port never calls) beside the bound, and the time of the blockwise
   f32 backward that the training path pairs with the kernel;
8. train (the training main path): full-width BERT-base MLM
   (``BertConfig(attention="flash")``, random weights, seed 0) through
   ``Trainer`` at B=32, S=512, max_predictions=80 with ragged padding masks:
   the flash loss and gradient norm against ``attention="dense"`` on one
   batch from the same weights, then 2 warm-up and 10 timed steps counting
   the kernel's launches (exactly 12 a step, the plain version never), step
   time, samples/s, tokens/s, MFU, a torch.profiler window, and 5 steps of
   the dense path for the end-to-end comparison;
9. worker: ``python -m kubeflow_tpu_torch.examples.bert_worker`` on the card
   at its tiny defaults, killed at step 3 (exit 137) and rerun: it resumes
   from the step-2 checkpoint and finishes step 4.

The Llama-3-8B weights are freed before phase 6b.  The last lines are the
``{"kernels": [...]}`` record, the ``nvidia-smi`` line and
``{"ok": true, "device": {...}}``.  Weights are random (seed 0) at full
width (and, for the phases that serve, full depth).
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import glob
import http.client
import importlib
import itertools
import json
import math
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time
import traceback
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from kubeflow_tpu_torch.core import tracing
from kubeflow_tpu_torch.serving.engine import model as M
from kubeflow_tpu_torch.serving.engine import paged_attention as PA
from kubeflow_tpu_torch.serving.engine.engine import Engine, EngineConfig, _page_hashes
from kubeflow_tpu_torch.serving.engine.faults import (FabricFaultConfig, FaultConfig,
                                                      HandoffFaultConfig)
from kubeflow_tpu_torch.serving.engine.perf import CUDA_PEAKS
from kubeflow_tpu_torch.serving.engine.kvstore import KVStoreConfig
from kubeflow_tpu_torch.serving.engine.native import load_library
from kubeflow_tpu_torch.serving.engine.scheduler import SchedulerConfig
from kubeflow_tpu_torch.serving.engine.serve import JetStreamModel
from kubeflow_tpu_torch.serving.kvfabric import fabric_key
from kubeflow_tpu_torch.serving.server import ModelServer
from kubeflow_tpu_torch.models import bert
from kubeflow_tpu_torch.train.data import synthetic_mlm_batches, to_device
from kubeflow_tpu_torch.train.trainer import Trainer, TrainerConfig, global_norm
from kubeflow_tpu_torch.utils.native_build import BUILD_DIR

# the module, not the function the package re-exports under the same name
FA = importlib.import_module("kubeflow_tpu_torch.ops.flash_attention")
REPO = os.path.dirname(os.path.abspath(__file__))

# NVIDIA's H100 SXM data sheet: HBM3 bandwidth and dense bf16 tensor rate
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
# ... and float32 outside the tensor cores
F32_FLOPS_PER_S = 67e12

# Llama-3-8B decode shapes on the engine's default geometry
B, HQ, HKV, HD, PS, MAX_PAGES, POOL_PAGES = 8, 32, 8, 128, 32, 64, 512
# a full 2048-token slot, an idle slot, one token, partial last pages and an
# exact page boundary
SEQ_LENS = [2048, 0, 1, 31, 32, 33, 700, 1500]
# kernel vs plain: both compute in f32 and round the output to bf16, so they
# differ by at most one bf16 ulp of the output (2**-7 relative, 2**-8 in the
# best case); atol covers outputs near zero
KERNEL_RTOL, KERNEL_ATOL = 2.0 ** -7, 1e-3
# decode_step paged vs gather, rtol = atol = decode_tol(depth).  The gather
# path rounds the softmax probabilities to bf16 before the PV product (as the
# JAX package does); the kernel keeps them in f32.  Each layer adds one such
# rounding difference to the residual stream, so the logits drift apart with
# depth like a random walk: the reference's 5e-2 (tests/test_engine.py:231;
# :375 holds its two paths at 2e-2 over 2 layers) at 2 layers, scaled by
# sqrt(depth / 2).  The phase checks depths 2, 8 and 32 of the same weights,
# so the growth is on record beside the verdict.
DECODE_DEPTHS = (2, 8, 32)


def decode_tol(depth: int) -> float:
    return 5e-2 * (depth / 2) ** 0.5


# the served tokens against forward_full: a token passes when its oracle
# logit is within this of the oracle max (tie-aware greedy: the engine's
# bucketed/chunked prefill and paged decode round bf16 elsewhere than the
# full forward, and a near-tie may legally flip); the same depth-32 drift
ORACLE_TIE_EPS = decode_tol(32)
MAX_TOKENS = 32
N_WARM, N_TIMED = 3, 20


def log(msg: str) -> None:
    print(msg, flush=True)


def brief(res):
    """A phase result for the log: the served token ids (kept in ``--out``)
    left out."""
    if isinstance(res, dict):
        return {k: brief(v) for k, v in res.items() if k != "token_ids"}
    if isinstance(res, list):
        return [brief(v) for v in res]
    return res


def nvidia_smi() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True, text=True,
                       timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


# device cycles the card spins between the L2 flush and the timed window
# (~0.1 ms at the H100's 1.98 GHz boost clock, more at lower clocks)
SPIN_CYCLES = 200_000


def time_ms(fn, flush: torch.Tensor) -> float:
    """Mean device time of ``fn`` over N_TIMED launches, each timed with CUDA
    events after writing a buffer larger than the L2 cache, so every launch
    finds its inputs in device memory as a decode step over 32 layers does.
    The card spins ``SPIN_CYCLES`` before the start event, so the host has
    queued ``fn``'s kernels by the time the window opens: the window holds
    the device's work and the gaps between its kernels, not the host time a
    short kernel's wrapper takes (which the L2 flush alone does not cover)."""
    for _ in range(N_WARM):
        fn()
    total = 0.0
    for _ in range(N_TIMED):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / N_TIMED


def profiled_ms(fn, flush: torch.Tensor, markers: tuple, n: int = 10) -> dict:
    """Device time of ``fn`` per call from a torch.profiler window of ``n``
    calls (each after the same L2 flush as ``time_ms``): ``total`` sums the
    kernels whose name holds one of ``markers``, and each marker has its
    own share.  The profiler reads each kernel's own duration, where the
    CUDA-event window of ``time_ms`` also holds the gaps between a call's
    kernels.  ``total`` is None when the profiler records no matching
    device event."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=PROFILE_ACTIVITIES, acc_events=True) as prof:
        for _ in range(n):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    us = {m: 0.0 for m in markers}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            for m in markers:
                if m in e.name:
                    us[m] += e.time_range.end - e.time_range.start
                    break
    total = sum(us.values())
    return {"total": total / n / 1e3 if total > 0 else None,
            **{m: v / n / 1e3 for m, v in us.items()}}


# the device kernels of one paged_attention call, and of the flash forward
PAGED_MARKERS = ("paged_split", "paged_merge")
FLASH_MARKERS = ("flash_fwd",)
# the pages_per_split values phase 3 compares on the bf16 and int8 K=1 cases
SPLIT_SWEEP = (2, 4, 8, 16)


# ----------------------------------------------------------------- phase 3


def kernel_case(quant, K, rng, dev, flush) -> dict:
    P = POOL_PAGES
    q = torch.from_numpy(rng.standard_normal((B, K, HQ, HD), dtype=np.float32)).to(
        dev, torch.bfloat16)

    def pool():
        x = torch.from_numpy(rng.standard_normal((P, HKV, PS, HD), dtype=np.float32)).to(
            dev, torch.bfloat16)
        if quant is None:
            return x
        qv, s = M._quantize_kv(x)
        return {"q": qv, "s": s}

    k_pool, v_pool = pool(), pool()
    table = torch.from_numpy(rng.integers(1, P, (B, MAX_PAGES)).astype(np.int32)).to(dev)
    lens = torch.tensor(SEQ_LENS, dtype=torch.int32, device=dev)
    args = (q, k_pool, v_pool, table, lens, PS)

    out = PA.paged_attention(*args)
    ref = PA.paged_attention_plain(*args)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs()
    ok = bool(torch.all(err <= KERNEL_ATOL + KERNEL_RTOL * ref.float().abs()))
    idle_zero = bool(torch.all(out[1] == 0)) if K == 1 else True

    # the yardstick: one library call over the already-gathered cache
    kc = M.pool_get(k_pool, table.long()).permute(0, 2, 1, 3, 4).reshape(B, HKV, -1, HD)
    vc = M.pool_get(v_pool, table.long()).permute(0, 2, 1, 3, 4).reshape(B, HKV, -1, HD)
    T = kc.shape[2]
    pos = torch.arange(T, device=dev)
    draft = torch.arange(K, device=dev)
    mask = (pos[None, None, :] < lens.long()[:, None, None] + draft[None, :, None])[:, None]
    qs = q.transpose(1, 2)

    def library():
        return torch.nn.functional.scaled_dot_product_attention(
            qs, kc, vc, attn_mask=mask, enable_gqa=True)

    try:
        library()
    except TypeError:  # a PyTorch without enable_gqa: expand the kv heads
        kc = kc.repeat_interleave(HQ // HKV, dim=1)
        vc = vc.repeat_interleave(HQ // HKV, dim=1)

        def library():
            return torch.nn.functional.scaled_dot_product_attention(
                qs, kc, vc, attn_mask=mask)

    kernel_ms = time_ms(lambda: PA.paged_attention(*args), flush)
    device = profiled_ms(lambda: PA.paged_attention(*args), flush, PAGED_MARKERS)
    plain_ms = time_ms(lambda: PA.paged_attention_plain(*args), flush)
    library_ms = time_ms(library, flush)
    sweep = {}
    if K == 1:
        for pps in SPLIT_SWEEP:
            def call(pps=pps):
                return PA.paged_attention(*args, _pages_per_split=pps)
            dev_pps = profiled_ms(call, flush, PAGED_MARKERS)
            sweep[pps] = {"kernel_ms": time_ms(call, flush), "device_ms": dev_pps["total"],
                          "merge_ms": dev_pps["paged_merge"]}

    # the bound: each input read once, each output written once, with only
    # the pages this run's lengths visit; operations of QK^T and PV
    pages = [min(MAX_PAGES, max(0, -(-(s + K - 1) // PS))) for s in SEQ_LENS]
    tok_bytes = HD * (1 if quant else 2) + (2 if quant else 0)  # + bf16 scale
    kv_bytes = 2 * sum(pages) * HKV * PS * tok_bytes
    io_bytes = 2 * q.numel() * 2 + table.numel() * 4 + lens.numel() * 4
    flops = sum(pages) * PS * 4 * HD * K * HQ
    bound_ms = max((kv_bytes + io_bytes) / HBM_BYTES_PER_S,
                   flops / BF16_FLOPS_PER_S) * 1e3
    return {"pool": quant or "bf16", "K": K, "max_abs_err": float(err.max()),
            "ok": ok and idle_zero, "kernel_ms": kernel_ms, "device_ms": device["total"],
            "device_ms_by_kernel": device,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms,
            "pages_per_split": PA._split_plan(MAX_PAGES, B, HKV, K * HQ // HKV),
            "split_sweep": sweep,
            "bound_by": ("bytes" if (kv_bytes + io_bytes) / HBM_BYTES_PER_S
                         >= flops / BF16_FLOPS_PER_S else "operations"),
            "visited_kv_bytes": kv_bytes}


# ----------------------------------------------------------------- phase 4


def decode_parity(params, cfg, dev) -> dict:
    """decode_step paged vs gather on one pool state, at the first 2, 8 and
    all 32 layers of the same full-width weights."""
    mp, P = 8, B * 8 + 1
    rng = np.random.default_rng(1)
    table = torch.arange(1, P, dtype=torch.int32, device=dev).reshape(B, mp)
    lens = torch.tensor([256, 0, 1, 33, 100, 200, 255, 17], dtype=torch.int32, device=dev)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, B).astype(np.int32)).to(dev)
    live = lens > 0
    out = {"ok": True, "depths": {}}
    for depth in DECODE_DEPTHS:
        c = dataclasses.replace(cfg, n_layers=depth)
        p = {k: (v[:depth] if v.dim() >= 2 and v.shape[0] == cfg.n_layers
                 and k not in ("embed", "unembed") else v) for k, v in params.items()}
        shape = (depth, P, cfg.n_kv_heads, PS, cfg.head_dim)
        g = torch.Generator(device=dev).manual_seed(1)
        k0 = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
        v0 = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
        lg, _, _ = M.decode_step(p, c, toks, lens, table, k0.clone(), v0.clone())
        lp, _, _ = M.decode_step(p, c, toks, lens, table, k0, v0, paged=True)
        a, b = lp[live], lg[live]
        err = (a - b).abs()
        tol = decode_tol(depth)
        ok = bool(torch.isfinite(a).all()) and bool(torch.all(err <= tol + tol * b.abs()))
        out["depths"][depth] = {
            "ok": ok, "tol": tol, "max_abs_err": float(err.max()),
            "logit_std": float(b.std()),
            "argmax_agree": f"{int((a.argmax(-1) == b.argmax(-1)).sum())}/{int(live.sum())}"}
        out["ok"] = out["ok"] and ok
    return out


# ----------------------------------------------------------------- phase 5

TEXT = ("Kubeflow serves Llama-3-8B on one H100: requests enter through the "
        "model server, queue in the C++ batcher, prefill in buckets or chunks, "
        "and decode over the paged KV pool. ")
PROMPTS = [TEXT[:60], TEXT[:150], (TEXT * 3)[:300], (TEXT * 5)[:600]]
# the prefix-cache phase's prompt: 31 full pages of 32 tokens, chunked
LONG_PROMPT = (TEXT * 8)[:1000]


def post(port: int, body: dict, headers: dict = None) -> tuple:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v2/models/llama3-8b/generate",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:  # 4xx/5xx: the status and its body
        return e.code, json.loads(e.read())


def oracle_lag(params, cfg, dev, prompt: str, got: list) -> float:
    """How far the served tokens fall below the ``forward_full`` max logit
    along their own trajectory (prompt + generation), at the worst step."""
    ids = list(prompt.encode())
    with torch.inference_mode():
        logits = M.forward_full(params, cfg, torch.tensor(
            [ids + got[:-1]], device=dev))[0, len(ids) - 1:]
    picked = logits[torch.arange(len(got), device=dev), torch.tensor(got, device=dev)]
    return (logits.max(-1).values - picked).max().item()


class KernelWatch:
    """The paged kernel's launches counted from zero inside the ``with``
    block, and its plain version watched: a CUDA engine must never run it.
    Read ``launches``, ``by_k`` and ``plain_calls`` after the block."""

    def __enter__(self):
        PA.paged_attention.launches = 0
        PA.paged_attention.launches_by_k = {}
        self.plain_calls = 0
        self._plain = plain = PA.paged_attention_plain

        def counting_plain(*a, **kw):
            self.plain_calls += 1
            return plain(*a, **kw)

        PA.paged_attention_plain = counting_plain
        return self

    def __exit__(self, *exc):
        self.launches = PA.paged_attention.launches
        self.by_k = dict(PA.paged_attention.launches_by_k)
        PA.paged_attention_plain = self._plain


class Served:
    """``Engine(ec)`` -> ``JetStreamModel`` -> ``ModelServer`` on 127.0.0.1,
    stopped (server, then engine) when the ``with`` block ends."""

    def __init__(self, params, cfg, dev, ec: EngineConfig):
        self.engine = Engine(params, cfg, ec, device=dev)
        self.server = ModelServer([JetStreamModel("llama3-8b", engine=self.engine)],
                                  port=0, host="127.0.0.1")

    def __enter__(self):
        self.server.start()
        return self

    def __exit__(self, *exc):
        self.server.stop()
        self.engine.stop()

    def post(self, prompt: str, max_tokens: int, headers: dict = None, **params) -> tuple:
        return post(self.server.port, {"text_input": prompt,
                                       "parameters": {"max_tokens": max_tokens, **params}},
                    headers)

    def warm(self, prompts: list) -> None:
        """Prompts of the served lengths with other bytes (the same prefill
        shapes, no prefix shared with the counted run), so no counted run
        pays first-use costs another does not."""
        with ThreadPoolExecutor(len(prompts)) as pool:
            codes = list(pool.map(lambda p: self.post(p[::-1].swapcase(), 2)[0], prompts))
        assert all(code == 200 for code in codes), codes

    def idle(self, timeout: float = 30.0) -> dict:
        """Wait for every slot to free; the engine's stats then."""
        deadline = time.monotonic() + timeout
        while self.engine.stats["active_slots"] and time.monotonic() < deadline:
            time.sleep(0.01)
        return self.engine.stats


def leaked_pages(stats: dict, ec: EngineConfig) -> int:
    return ec.num_pages - 1 - stats["free_pages"] - stats["cached_pages"]


def serve(params, cfg, dev, ec: EngineConfig, prompts: list, sequential=False) -> dict:
    """A warm-up, then ``prompts`` over HTTP (concurrently, or one after
    another with the cache counters read after each), with the paged
    kernel's launches counted from zero for this run; every served request
    checked against the ``forward_full`` oracle."""
    with Served(params, cfg, dev, ec) as srv:
        srv.warm(prompts)
        engine = srv.engine
        before = engine.stats
        results: list = [None] * len(prompts)
        after_each: list = []

        def run(i):
            results[i] = srv.post(prompts[i], MAX_TOKENS)

        with KernelWatch() as watch:
            t0 = time.perf_counter()
            if sequential:
                for i in range(len(prompts)):
                    run(i)
                    after_each.append({k: engine.stats[k] for k in ("page_hits", "cached_pages")})
            else:
                threads = [threading.Thread(target=run, args=(i,)) for i in range(len(prompts))]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=600)
            wall = time.perf_counter() - t0
        stats = srv.idle()
    served = all(r is not None and r[0] == 200 and r[1]["tokens"] == MAX_TOKENS
                 for r in results)
    leaked = leaked_pages(stats, ec)
    steps = stats["decode_steps"] - before["decode_steps"]
    launches, plain_calls = watch.launches, watch.plain_calls
    out = {"statuses": [r[0] if r else None for r in results],
           "tokens": [r[1]["tokens"] if r else None for r in results],
           "token_ids": [r[1]["token_ids"] if r else None for r in results],
           "prompt_bytes": [len(p) for p in prompts],
           "launches": launches, "launches_by_k": watch.by_k, "plain_calls": plain_calls,
           "decode_steps": steps,
           "leaked_pages": leaked,
           "prefill_dispatches": stats["prefill_dispatches"] - before["prefill_dispatches"],
           "pipeline_fences": stats["pipeline_fences"],
           "spec_proposed": stats["spec_proposed"], "spec_accepted": stats["spec_accepted"],
           "page_hits": stats["page_hits"] - before["page_hits"], "after_each": after_each,
           "ttft_s": [r[1]["ttft_s"] if r else None for r in results],
           "wall_s": wall, "tokens_per_s": sum(MAX_TOKENS for r in results if r) / wall}
    out["oracle_max_logit_lag"] = ([oracle_lag(params, cfg, dev, p, r[1]["token_ids"])
                                    for p, r in zip(prompts, results)] if served else None)
    # every decode or verify call runs the kernel once per layer
    out["ok"] = (served and leaked == 0 and launches == cfg.n_layers * steps > 0
                 and plain_calls == 0
                 and max(out["oracle_max_logit_lag"]) <= ORACLE_TIE_EPS)
    return out


def main_path(params, cfg, dev) -> dict:
    """The engine defaults (the pipelined loop, the prefix cache) and the
    same requests on the sync loop (``pipeline_depth=0``), in turns:
    pipelined, sync, sync, pipelined."""
    runs = []
    for depth in (1, 0, 0, 1):
        runs.append(serve(params, cfg, dev, EngineConfig(pipeline_depth=depth), PROMPTS))
        runs[-1]["pipeline_depth"] = depth
        gc.collect()
        torch.cuda.empty_cache()
    a, b = runs[0]["token_ids"], runs[1]["token_ids"]
    identical = [sum(1 for _ in itertools.takewhile(lambda t: t[0] == t[1], zip(x, y)))
                 if x and y else None for x, y in zip(a, b)]
    return {"ok": all(r["ok"] for r in runs), "runs": runs,
            "identical_leading_tokens": identical,
            "launches": sum(r["launches"] for r in runs)}


def speculative(params, cfg, dev) -> dict:
    """The same requests with prompt-lookup speculative decoding (pipelined,
    K = spec_max_draft + 1 = 5 query rows per slot in a verify pass)."""
    ec = EngineConfig(speculative="prompt_lookup")
    res = serve(params, cfg, dev, ec, PROMPTS)
    k = 1 + ec.spec_max_draft
    res["accept_rate"] = (res["spec_accepted"] / res["spec_proposed"]
                          if res["spec_proposed"] else None)
    res["ok"] = (res["ok"] and res["spec_proposed"] > 0
                 and res["launches_by_k"].get(k, 0) > 0)
    return res


def prefix_cache(params, cfg, dev) -> dict:
    """One long prompt twice in a row on the default engine: the second
    admission adopts the first's cached pages."""
    res = serve(params, cfg, dev, EngineConfig(), [LONG_PROMPT, LONG_PROMPT], sequential=True)
    hits = [e["page_hits"] for e in res["after_each"]]
    res["second_admission_cached_pages"] = hits[1] - hits[0] if len(hits) == 2 else None
    res["ok"] = res["ok"] and (res["second_admission_cached_pages"] or 0) > 0
    return res


# ---------------------------------------------------------------- phase 5d

# two batch-class requests fill both slots; after the first has committed
# QOS_AT tokens an interactive one arrives
QOS_BATCH = [(TEXT * 5)[:700], (TEXT * 5)[40:740]]
QOS_INTERACTIVE = (TEXT * 2)[20:220]
QOS_BATCH_TOKENS, QOS_INTERACTIVE_TOKENS, QOS_AT = 160, 32, 32
QOS_SLOTS = 2


def leading_identical(a: list, b: list) -> int:
    return sum(1 for _ in itertools.takewhile(lambda t: t[0] == t[1], zip(a, b)))


def _wait_for(pred, what: str, timeout: float = 120.0) -> None:
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            raise TimeoutError(f"timed out waiting for {what}")
        time.sleep(0.002)


def qos_run(params, cfg, dev, sched: SchedulerConfig, kv_quant=None,
            deadline_probe: bool = False) -> dict:
    """One 5d run over HTTP: batch request A, then batch request B once A
    decodes (so B prefills alone, as its oracle does), then, when A has
    committed QOS_AT tokens and B decodes, the interactive request.  With
    ``deadline_probe`` a batch request with ``deadline_s=0.05`` is posted
    while both slots are held: it must come back 504."""
    ec = EngineConfig(max_slots=QOS_SLOTS, scheduler=sched, kv_quant=kv_quant)
    with Served(params, cfg, dev, ec) as srv:
        eng = srv.engine
        srv.warm(QOS_BATCH + [QOS_INTERACTIVE])
        out: dict = {}

        def run(name, prompt, n, prio):
            t0 = time.perf_counter()
            out[name] = srv.post(prompt, n, priority=prio)
            out[name + "_wall_s"] = time.perf_counter() - t0

        def decoding(n_slots):
            return eng.stats["active_slots"] == n_slots and not eng._prefilling

        # which batch request each preemption evicts (the HTTP result does
        # not carry the preemption count): the victim's prompt bytes
        victims: list = []
        preempt = eng._preempt_slot

        def spy(slot, reason):
            p = eng._requests.get(eng._slot_req.get(slot))
            if p is not None:
                victims.append("AB"[bytes(p.tokens[:64]) != QOS_BATCH[0][:64].encode()])
            return preempt(slot, reason)

        eng._preempt_slot = spy
        threads = []
        with KernelWatch() as watch:
            s0 = eng.stats["decode_steps"]
            for name, prompt in zip("AB", QOS_BATCH):
                threads.append(threading.Thread(target=run, args=(
                    name, prompt, QOS_BATCH_TOKENS, "batch")))
                threads[-1].start()
                _wait_for(lambda: decoding(len(threads)), f"{name} decoding")
                if name == "A":
                    a_steps = eng.stats["decode_steps"]
            _wait_for(lambda: eng.stats["decode_steps"] >= a_steps + QOS_AT, "A's tokens")
            threads.append(threading.Thread(target=run, args=(
                "I", QOS_INTERACTIVE, QOS_INTERACTIVE_TOKENS, "interactive")))
            threads[-1].start()
            if deadline_probe:
                out["deadline_probe"] = srv.post(QOS_INTERACTIVE, 4, priority="batch",
                                                 deadline_s=0.05)
            for t in threads:
                t.join(timeout=600)
        stats = srv.idle()
        steps = stats["decode_steps"] - s0
    res = {name: out.get(name) for name in "ABI"}
    served = all(r is not None and r[0] == 200 for r in res.values())
    rec = {"policy": sched.policy, "swap_policy": sched.swap_policy,
           "preemption": sched.preemption, "kv_quant": kv_quant,
           "statuses": {n: r[0] if r else None for n, r in res.items()},
           "token_ids": {n: r[1].get("token_ids") if r else None for n, r in res.items()},
           "ttft_s": {n: r[1].get("ttft_s") if r else None for n, r in res.items()},
           "latency_s": {n: r[1].get("latency_s") if r else None for n, r in res.items()},
           "victims": victims,
           "preemptions": stats["preemptions"],
           "preemption_modes": stats["preemption_modes"],
           "preemption_reasons": stats["preemption_reasons"],
           "swapped_bytes": stats["swap_bytes_out"], "swap_out_ms": stats["swap_out_ms"],
           "swap_in_ms": stats["swap_in_ms"],
           "store_host_bytes_at_drain": stats["kv_host_used_bytes"],
           "swap_bytes_at_drain": stats["swap_used_bytes"],
           "leaked_pages": leaked_pages(stats, ec),
           "launches": watch.launches, "launches_by_k": watch.by_k,
           "plain_calls": watch.plain_calls, "decode_steps": steps}
    if deadline_probe:
        code, body = out["deadline_probe"]
        rec["deadline_probe"] = {"status": code, "reason": body.get("reason")}
    rec["ok"] = (served and rec["leaked_pages"] == 0
                 and rec["store_host_bytes_at_drain"] == 0 and rec["swap_bytes_at_drain"] == 0
                 and watch.plain_calls == 0 and watch.launches == cfg.n_layers * steps > 0
                 and all(res[n][1]["tokens"] == QOS_BATCH_TOKENS for n in "AB")
                 and res["I"][1]["tokens"] == QOS_INTERACTIVE_TOKENS
                 and (not deadline_probe or rec["deadline_probe"]["status"] == 504))
    return rec


def oracle_tokens(params, cfg, dev, prompt: str, kv_quant=None) -> list:
    """The batch request alone on a fresh engine of the 5d geometry."""
    with Served(params, cfg, dev, EngineConfig(max_slots=QOS_SLOTS, kv_quant=kv_quant)) as srv:
        srv.warm([prompt])
        code, body = srv.post(prompt, QOS_BATCH_TOKENS, priority="batch")
    assert code == 200, body
    return body["token_ids"]


def qos(params, cfg, dev) -> dict:
    """Phase 5d: the interactive request's TTFT under priority scheduling
    with swap and with recompute preemption (and swap on the int8 pool)
    against the fifo baseline without preemption; the victim's tokens
    against its run alone (all identical under swap: the same KV bytes come
    back; recompute re-derives the KV by prefill, so it is held to the
    oracle bound); every served token's oracle lag; no page or store byte
    left at drain; a doomed request shed with 504."""
    victim_prompt = QOS_BATCH[1]  # B: the later-submitted batch slot
    oracles = {q: oracle_tokens(params, cfg, dev, victim_prompt, q) for q in (None, "int8")}
    runs = {}
    for name, sched, kw in (
            ("swap", SchedulerConfig(swap_policy="swap"), {}),
            ("recompute", SchedulerConfig(swap_policy="recompute"), {}),
            ("fifo", SchedulerConfig(policy="fifo", preemption=False), {"deadline_probe": True}),
            ("int8_swap", SchedulerConfig(swap_policy="swap"), {"kv_quant": "int8"})):
        runs[name] = qos_run(params, cfg, dev, sched, **kw)
        gc.collect()
        torch.cuda.empty_cache()
    prompts = {"A": QOS_BATCH[0], "B": QOS_BATCH[1], "I": QOS_INTERACTIVE}
    for name, run in runs.items():
        ids = run["token_ids"]
        if all(ids.values()):
            run["oracle_max_logit_lag"] = {n: oracle_lag(params, cfg, dev, prompts[n], ids[n])
                                           for n in "ABI"}
            run["victim_identical_leading_tokens"] = leading_identical(
                ids["B"], oracles[run["kv_quant"]])
        preempting = run["preemption"]
        mode = run["swap_policy"]
        run["ok"] = run["ok"] and "oracle_max_logit_lag" in run and (
            run["victims"] == ["B"] and run["preemptions"] == 1
            and run["preemption_modes"][mode] == 1 if preempting
            else run["victims"] == [] and run["preemptions"] == 0)
        if run["kv_quant"] is None:
            # int8 KV rounds the pool: the bf16 oracle bound does not apply
            run["ok"] = run["ok"] and max(run["oracle_max_logit_lag"].values()) <= ORACLE_TIE_EPS
        if mode == "swap" and preempting:
            run["ok"] = (run["ok"] and run["swapped_bytes"] > 0
                         and run["victim_identical_leading_tokens"] == QOS_BATCH_TOKENS)
    fifo_ttft = runs["fifo"]["ttft_s"]["I"] or 0.0
    ok = all(r["ok"] for r in runs.values()) and all(
        (runs[n]["ttft_s"]["I"] or 1e9) < fifo_ttft for n in ("swap", "recompute"))
    return {"ok": ok, "runs": runs,
            "interactive_ttft_s": {n: r["ttft_s"]["I"] for n, r in runs.items()},
            "launches": sum(r["launches"] for r in runs.values())}


# ---------------------------------------------------------------- phase 5e

SESSION_TOKENS = 16
SESSION_TURN_BYTES = (600, 900, 1200)


def session_turns(replies: list) -> list:
    """The three turns' contexts: turn 1 a 600-byte prompt; each later turn
    the previous context, the reply's text and new bytes, about 900 and
    1200 bytes in all."""
    ctx = [(TEXT * 8)[:SESSION_TURN_BYTES[0]]]
    for i, reply in enumerate(replies[:2]):
        base = ctx[-1] + reply
        extra = (TEXT * 8)[100:100 + max(8, SESSION_TURN_BYTES[i + 1] - len(base.encode()))]
        ctx.append(base + extra)
    return ctx


def session_run(params, cfg, dev, kv: KVStoreConfig, contexts: list = None,
                drop: bool = True) -> dict:
    """Session turns over HTTP under one session id on one engine, counting
    the paged kernel's launches.  ``contexts=None`` builds each turn's
    context from the replies as it goes (session_turns).  Per turn: the
    response and the pages and bytes the engine restored from the store.
    ``drop``: unpin the session at the end, so every tier reads zero."""
    ec = EngineConfig(kv_store=kv)
    turns, restored, replies = [], [], []
    with Served(params, cfg, dev, ec) as srv:
        eng = srv.engine
        before_sessions = sorted(eng.sessions())
        with KernelWatch() as watch:
            s0 = eng.stats["decode_steps"]
            for i in range(len(contexts) if contexts else 3):
                ctx = contexts[i] if contexts else session_turns(replies)[i]
                r0 = eng.stats
                code, body = srv.post(ctx, SESSION_TOKENS, session_id="chat")
                r1 = eng.stats
                turns.append((ctx, code, body))
                replies.append(body.get("text_output", ""))
                restored.append({k: r1[k] - r0[k] for k in ("session_restored_pages",
                                                            "session_restored_bytes")})
        stats = srv.idle()
        steps = stats["decode_steps"] - s0
        if drop:
            eng.drop_session("chat")
        drained = eng.stats
    return {"turns": turns, "restored": restored, "sessions_at_boot": before_sessions,
            "launches": watch.launches, "plain_calls": watch.plain_calls,
            "kernel_ok": watch.plain_calls == 0 and watch.launches == cfg.n_layers * steps > 0,
            "leaked_pages": leaked_pages(drained, ec),
            "host_bytes_at_drain": drained["kv_host_used_bytes"],
            "store_bytes_at_drain": drained["kv_host_used_bytes"] + drained["kv_disk_used_bytes"]}


def sessions(params, cfg, dev) -> dict:
    """Phase 5e: a three-turn session over HTTP on the host tier; the same
    conversation on the disk tier (host budget 1 byte); then turns 2-3
    again on a fresh engine booted on the disk run's directory, which
    restores them from its manifest; each turn's context also run cold on a
    fresh engine, the reference.  Per turn: the restore tier, the pages and
    bytes restored, warm vs cold TTFT, identical leading tokens against the
    cold run and the oracle lag."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        host = session_run(params, cfg, dev, KVStoreConfig(disk_dir=os.path.join(tmp, "h")))
        contexts = [ctx for ctx, _, _ in host["turns"]]
        disk_kv = KVStoreConfig(host_max_bytes=1, disk_dir=os.path.join(tmp, "d"))
        disk = session_run(params, cfg, dev, disk_kv, contexts, drop=False)
        manifest = session_run(params, cfg, dev, disk_kv, contexts[1:])
    cold = []
    for ctx in contexts:
        with Served(params, cfg, dev, EngineConfig()) as srv:
            cold.append(srv.post(ctx, SESSION_TOKENS)[1])
    gc.collect()
    torch.cuda.empty_cache()
    runs = {"host": host, "disk": disk, "manifest": manifest}
    want = {"host": ["cold", "host", "host"], "disk": ["cold", "disk", "disk"],
            "manifest": ["disk", "disk"]}
    ok = manifest["sessions_at_boot"] == ["chat"]
    report = {}
    for name, run in runs.items():
        rows = []
        for (ctx, code, body), rest, cbody in zip(run["turns"], run["restored"],
                                                  cold[3 - len(run["turns"]):]):
            ids = body.get("token_ids") or []
            sess = body.get("session", {})
            rows.append({
                "context_bytes": len(ctx.encode()), "status": code,
                "restore": sess.get("restore"), "pinned": sess.get("pinned"),
                "restored_pages": rest["session_restored_pages"],
                "restored_bytes": rest["session_restored_bytes"],
                "ttft_s": body.get("ttft_s"), "cold_ttft_s": cbody.get("ttft_s"),
                "identical_leading_tokens": leading_identical(ids, cbody.get("token_ids") or []),
                "oracle_max_logit_lag": (oracle_lag(params, cfg, dev, ctx, ids)
                                         if len(ids) == SESSION_TOKENS else None)})
        report[name] = {"turns": rows, "launches": run["launches"],
                        "leaked_pages": run["leaked_pages"],
                        "host_bytes_at_drain": run["host_bytes_at_drain"],
                        "store_bytes_at_drain": run["store_bytes_at_drain"],
                        "kernel_ok": run["kernel_ok"]}
        ok = (ok and run["kernel_ok"] and run["leaked_pages"] == 0
              and run["host_bytes_at_drain"] == 0
              and (name == "disk" or run["store_bytes_at_drain"] == 0)
              and [r["restore"] for r in rows] == want[name]
              and all(r["status"] == 200 and r["pinned"] for r in rows)
              and all(r["restored_pages"] > 0 for r in rows if r["restore"] != "cold")
              and all(r["oracle_max_logit_lag"] is not None
                      and r["oracle_max_logit_lag"] <= ORACLE_TIE_EPS for r in rows))
    return {"ok": ok, "runs": report, "context_bytes": [len(c.encode()) for c in contexts],
            "manifest_sessions_at_boot": manifest["sessions_at_boot"],
            "launches": sum(r["launches"] for r in runs.values())}


# ---------------------------------------------------------------- phase 5f

STREAM_PATH = "/v2/models/llama3-8b/generate_stream"
# the failover client: closes after this many events, then resumes
RESUME_AFTER = 8
# the stream stop() drains while /engine/health is polled
DRAIN_TOKENS = 48


def sse(port: int, path: str, body: dict, headers: dict = None, stop_after: int = None):
    """One SSE request over its own connection: (status, events, seconds
    from the request to each event).  ``data: [DONE]`` is kept as the string
    "[DONE]"; a non-200 answer gives its JSON body as ``events``.
    ``stop_after``: close the connection after that many events."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    t0 = time.perf_counter()
    conn.request("POST", path, json.dumps(body),
                 {"Content-Type": "application/json", **(headers or {})})
    resp = conn.getresponse()
    try:
        if resp.status != 200:
            return resp.status, json.loads(resp.read()), []
        events, times = [], []
        while stop_after is None or len(events) < stop_after:
            line = resp.readline()
            if not line:
                break
            if not line.startswith(b"data: "):
                continue
            data = line[len(b"data: "):].strip()
            times.append(time.perf_counter() - t0)
            events.append("[DONE]" if data == b"[DONE]" else json.loads(data))
        return resp.status, events, times
    finally:
        resp.close()
        conn.close()


def get_json(port: int, path: str) -> tuple:
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def parse_metrics(text: str) -> dict:
    """Prometheus text exposition -> {series: value} (the script cannot use
    the JAX package's scraper)."""
    out = {}
    for line in text.splitlines():
        if line.startswith("#") or not line.strip():
            continue
        name, _, value = line.rpartition(" ")
        out[name] = float(value)
    return out


def quantile(xs: list, q: float):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * len(xs)))] if xs else None


def stream_run(srv, prompts: list) -> dict:
    """``prompts`` as concurrent generate_stream requests with
    ``X-Stream-Resume: 1``; per stream the token ids, text, final record,
    client time to the first event and gaps between token events."""
    results: list = [None] * len(prompts)

    def run(i):
        body = {"text_input": prompts[i], "parameters": {"max_tokens": MAX_TOKENS}}
        results[i] = sse(srv.server.port, STREAM_PATH, body, {"X-Stream-Resume": "1"})

    s0 = srv.engine.stats["decode_steps"]
    t0 = time.perf_counter()
    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    steps = srv.engine.stats["decode_steps"] - s0
    decode = srv.model.tokenizer.decode
    out = []
    for code, events, times in results:
        tok = [(e, t) for e, t in zip(events, times) if not e.get("done")]
        ids = [i for e, _ in tok for i in e.get("token_ids", ())]
        text = "".join(e["text_output"] for e in events)
        final = events[-1] if events and events[-1].get("done") else {}
        out.append({"status": code, "token_ids": ids, "events": len(events),
                     "text_ok": text == decode(ids), "tokens": final.get("tokens"),
                     "engine_ttft_s": final.get("ttft_s"),
                     "client_first_event_s": tok[0][1] if tok else None,
                     "gaps_s": [b[1] - a[1] for a, b in zip(tok, tok[1:])]})
    gaps = [g for r in out for g in r.pop("gaps_s")]
    return {"streams": out, "wall_s": wall, "decode_steps": steps,
            "engine_ms_per_step": wall / steps * 1e3 if steps else None,
            "event_gap_p50_ms": quantile(gaps, 0.5) * 1e3 if gaps else None,
            "event_gap_p99_ms": quantile(gaps, 0.99) * 1e3 if gaps else None}


def streaming_checks(params, cfg, dev, run: dict, prompts: list, unary: list = None) -> bool:
    """The stream gates: 200, text == decode(ids), ``tokens`` ==
    MAX_TOKENS, every token within the oracle bound; with ``unary``, the
    identical leading tokens against those ids (reported)."""
    ok = True
    for i, (p, r) in enumerate(zip(prompts, run["streams"])):
        r["oracle_max_logit_lag"] = (oracle_lag(params, cfg, dev, p, r["token_ids"])
                                     if len(r["token_ids"]) == MAX_TOKENS else None)
        if unary is not None:
            r["identical_leading_vs_unary"] = leading_identical(r["token_ids"], unary[i])
        ok = (ok and r["status"] == 200 and r["text_ok"] and r["tokens"] == MAX_TOKENS
              and r["oracle_max_logit_lag"] is not None
              and r["oracle_max_logit_lag"] <= ORACLE_TIE_EPS)
    return ok


class Replica(Served):
    """``Served`` whose engine this phase stops itself (the drain probe)."""

    def __init__(self, params, cfg, dev, ec: EngineConfig):
        super().__init__(params, cfg, dev, ec)
        self.model = self.server.models["llama3-8b"]

    def __exit__(self, *exc):
        self.server.stop()
        if not self.engine._stopped:
            self.engine.stop()


def streaming(params, cfg, dev) -> dict:
    """Phase 5f: the serving surfaces the ingress calls, at full Llama-3-8B
    on ``EngineConfig()`` over HTTP: 4 concurrent SSE streams (against the
    same prompts' unary run), the same speculative (K = 5 inside a stream), a
    client that disconnects after RESUME_AFTER events and re-submits with
    ``resume_token_ids``, one OpenAI chat stream, ``/metrics``, and
    ``/engine/health`` through SERVING, DRAINING (while ``stop()`` drains a
    stream) and DEAD."""
    out: dict = {}
    with Replica(params, cfg, dev, EngineConfig()) as srv:
        srv.warm(PROMPTS)
        eng, port = srv.engine, srv.server.port
        unary: list = [None] * len(PROMPTS)
        with ThreadPoolExecutor(len(PROMPTS)) as pool:
            for i, (code, body) in enumerate(pool.map(lambda p: srv.post(p, MAX_TOKENS),
                                                      PROMPTS)):
                unary[i] = body.get("token_ids") if code == 200 else None
        with KernelWatch() as watch:
            run = stream_run(srv, PROMPTS)
        run.update(launches=watch.launches, launches_by_k=watch.by_k,
                   plain_calls=watch.plain_calls)
        ok = (streaming_checks(params, cfg, dev, run, PROMPTS, unary) and all(unary)
              and watch.plain_calls == 0
              and watch.launches == cfg.n_layers * run["decode_steps"] > 0)
        out["streams"] = run
        # failover: the client goes away after RESUME_AFTER events, then
        # re-submits with the ids it received
        victim = PROMPTS[3]
        body = {"text_input": victim, "parameters": {"max_tokens": MAX_TOKENS}}
        with KernelWatch() as watch:
            code, events, _ = sse(port, STREAM_PATH, body, {"X-Stream-Resume": "1"},
                                  stop_after=RESUME_AFTER)
            got = [i for e in events for i in e.get("token_ids", ())]
            _wait_for(lambda: not eng._slot_req, "the cancel")
            h0 = eng.stats["page_hits"]
            rbody = {"text_input": victim,
                     "parameters": {"max_tokens": MAX_TOKENS, "resume_token_ids": got}}
            rcode, revents, rtimes = sse(port, STREAM_PATH, rbody, {"X-Stream-Resume": "1"})
            hits = eng.stats["page_hits"] - h0
        cont = [i for e in revents if isinstance(e, dict) for i in e.get("token_ids", ())]
        final = revents[-1] if revents and isinstance(revents[-1], dict) else {}
        whole = got + cont
        resume = {"status": [code, rcode], "received": len(got), "continued": len(cont),
                  "final_tokens": final.get("tokens"), "resumed_ttft_s": final.get("ttft_s"),
                  "client_first_event_s": rtimes[0] if rtimes else None,
                  "page_hits": hits, "launches": watch.launches,
                  "plain_calls": watch.plain_calls,
                  "identical_leading_vs_unbroken": leading_identical(whole, unary[3] or []),
                  "oracle_max_logit_lag": (oracle_lag(params, cfg, dev, victim, whole)
                                           if len(whole) == MAX_TOKENS else None)}
        ok = (ok and code == rcode == 200 and len(got) == RESUME_AFTER
              and final.get("tokens") == MAX_TOKENS and len(whole) == MAX_TOKENS
              and resume["oracle_max_logit_lag"] is not None
              and resume["oracle_max_logit_lag"] <= ORACLE_TIE_EPS
              and watch.plain_calls == 0 and watch.launches > 0)
        out["resume"] = resume
        # the OpenAI surface, streamed
        code, chunks, _ = sse(port, "/openai/v1/chat/completions", {
            "model": "llama3-8b", "messages": [{"role": "user", "content": PROMPTS[1]}],
            "max_tokens": 8, "stream": True})
        first = chunks[0] if chunks and isinstance(chunks[0], dict) else {}
        out["openai"] = {"status": code, "chunks": len(chunks),
                         "first_delta": (first.get("choices") or [{}])[0].get("delta"),
                         "done": bool(chunks) and chunks[-1] == "[DONE]"}
        ok = (ok and code == 200 and out["openai"]["done"]
              and (out["openai"]["first_delta"] or {}).get("role") == "assistant")
        # /metrics and /engine/health, then a drain
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=60) as r:
            metrics = parse_metrics(r.read().decode())
        gauges = ("engine_queue_depth", "engine_active_slots", "inflight_requests")
        out["metrics"] = {k: metrics.get(k) for k in gauges}
        ok = ok and all(isinstance(metrics.get(k), float) for k in gauges)
        stats = srv.idle()
        out["leaked_pages"] = leaked_pages(stats, eng.ec)
        ok = ok and out["leaked_pages"] == 0
        code, hb = get_json(port, "/engine/health")
        health = [(code, hb["state"])]
        held: dict = {}
        body = {"text_input": PROMPTS[2], "parameters": {"max_tokens": DRAIN_TOKENS}}
        t = threading.Thread(target=lambda: held.update(r=sse(port, STREAM_PATH, body)))
        t.start()
        _wait_for(lambda: eng._slot_req and not eng._prefilling, "the drained stream")
        stopper = threading.Thread(target=eng.stop)
        stopper.start()
        while stopper.is_alive():
            code, hb = get_json(port, "/engine/health")
            if (code, hb["state"]) != health[-1]:
                health.append((code, hb["state"]))
            time.sleep(0.02)
        stopper.join()
        t.join(timeout=600)
        code, hb = get_json(port, "/engine/health")
        health.append((code, hb["state"]))
        drained = held["r"][1]
        out["health"] = health
        out["drained_stream_tokens"] = drained[-1].get("tokens") if drained else None
        ok = (ok and health[0] == (200, "SERVING") and (503, "DRAINING") in health
              and health[-1] == (503, "DEAD")
              and out["drained_stream_tokens"] == DRAIN_TOKENS)
    gc.collect()
    torch.cuda.empty_cache()
    # the same streams, speculative: the K = 5 kernel inside a stream
    with Replica(params, cfg, dev, EngineConfig(speculative="prompt_lookup")) as srv:
        srv.warm(PROMPTS)
        with KernelWatch() as watch:
            run = stream_run(srv, PROMPTS)
        stats = srv.idle()
        run.update(launches=watch.launches, launches_by_k=watch.by_k,
                   plain_calls=watch.plain_calls, leaked_pages=leaked_pages(stats, srv.engine.ec),
                   spec_proposed=stats["spec_proposed"], spec_accepted=stats["spec_accepted"])
        ok = (ok and streaming_checks(params, cfg, dev, run, PROMPTS)
              and watch.plain_calls == 0 and watch.by_k.get(5, 0) > 0
              and run["leaked_pages"] == 0)
        out["speculative"] = run
    gc.collect()
    torch.cuda.empty_cache()
    out["launches"] = (out["streams"]["launches"] + out["resume"]["launches"]
                       + out["speculative"]["launches"])
    out["ok"] = ok
    return out


# ---------------------------------------------------------------- phase 5g

# the on-demand profile: work ticks captured, and a decode budget that keeps
# all four requests decoding through the window
PROFILE_TICKS, PROFILE_TOKENS = 8, 64
# the watchdog drive: the tick the loop dies at (every prompt is admitted
# at tick 1 and the longest one's chunked prefill ends at tick 3, so this
# lands mid-decode), and the stalled tick of the hang drive
DIE_TICK, HANG_TICK, HANG_TIMEOUT_S, HANG_S = 8, 6, 2.0, 4.0
# the request id the NaN drive poisons, and the HTTP probe after the four
NAN_VICTIM, NAN_PROBE = 1, 4
PHASE_ORDER = ["queued", "admitted", "prefill", "first_token", "done"]


def wait_for(pred, timeout: float = 60.0, step: float = 0.005) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(step)
    return False


def phase_order(trace: dict) -> list:
    """A span's phases with repeats (one ``prefill`` per chunk) folded."""
    out = []
    for e in trace["events"]:
        if not out or out[-1] != e["phase"]:
            out.append(e["phase"])
    return out


def paged_records(trace_path: str) -> int:
    """Device records of the paged kernels (split + merge) in a Chrome trace."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    return sum(1 for e in events
               if e.get("cat") == "kernel" and e.get("ph") == "X"
               and any(m in e.get("name", "") for m in PAGED_MARKERS))


def timeline_medians(engine) -> dict:
    """Median host ms per tick of each timeline phase, over the ticks that
    ran it."""
    per: dict = {}
    for r in engine.timeline.snapshot(last=256):
        for ph, dur in r["segments"].items():
            per.setdefault(ph, []).append(dur * 1e3)
    return {ph: float(np.median(v)) for ph, v in sorted(per.items())}


def direct_run(params, cfg, dev, ec: EngineConfig, prompts=PROMPTS,
               max_tokens: int = MAX_TOKENS) -> dict:
    """``prompts`` submitted before the loop starts (so every run ticks the
    same schedule and gives the same tokens), after a warm-up on the same
    engine; results or exception names, wall, decode steps, host ms per
    tick and tokens/s of the timed run."""
    engine = Engine(params, cfg, ec, device=dev)
    warm = [engine.generate_async(list(p[::-1].swapcase().encode()), 2) for p in prompts]
    engine.start()
    try:
        for f in warm:
            f.result(timeout=600)
        assert wait_for(lambda: engine.stats["active_slots"] == 0)
        engine.stop()
        engine = Engine(params, cfg, ec, device=dev)
        futs = [engine.generate_async(list(p.encode()), max_tokens) for p in prompts]
        t0 = time.perf_counter()
        engine.start()
        out = []
        for f in futs:
            try:
                out.append(f.result(timeout=600)["tokens"])
            except Exception as e:  # noqa: BLE001 — the typed failure is the result
                out.append(f"{type(e).__name__}: {e}")
        wall = time.perf_counter() - t0
        stats = engine.stats
    finally:
        engine.stop()
    n_tok = sum(len(t) for t in out if isinstance(t, list))
    return {"tokens": out, "wall_s": wall, "decode_steps": stats["decode_steps"],
            "ticks": stats["ticks"],
            "host_ms_per_tick": wall / stats["ticks"] * 1e3 if stats["ticks"] else None,
            "tokens_per_s": n_tok / wall, "leaked_pages": leaked_pages(stats, ec)}


def obs_traced(params, cfg, dev, kind: str) -> dict:
    """5g (a) traced requests, (b) the perf plane and (c) an on-demand
    profile, on one ``EngineConfig()`` server."""
    out: dict = {}
    with Served(params, cfg, dev, EngineConfig()) as srv:
        srv.warm(PROMPTS)
        port, engine = srv.server.port, srv.engine
        ctxs = [tracing.TraceContext.mint() for _ in PROMPTS]
        results: list = [None] * len(PROMPTS)

        def run(i):
            results[i] = post(port, {"text_input": PROMPTS[i],
                                     "parameters": {"max_tokens": MAX_TOKENS}},
                              {"X-Request-Trace": "1", "traceparent": ctxs[i].traceparent()})

        with KernelWatch() as watch:
            with ThreadPoolExecutor(len(PROMPTS)) as pool:
                list(pool.map(run, range(len(PROMPTS))))
        # (a) spans, the trace route, waterfalls, latency, /metrics
        reqs, ok_a = [], True
        for ctx, (code, body), p in zip(ctxs, results, PROMPTS):
            tr = body.get("trace") or {}
            st, spans = get_json(port, f"/engine/trace/{ctx.trace_id}")
            ws, wf = get_json(port, f"/engine/waterfall/{tr.get('rid')}")
            seg_sum = sum(sg["dur_s"] for sg in wf.get("segments", ())) if ws == 200 else None
            r = {"status": code, "tokens": body.get("tokens"), "phases": phase_order(tr) if tr else None,
                 "trace_id_adopted": tr.get("trace_id") == ctx.trace_id
                 and tr.get("parent_id") == ctx.span_id,
                 "trace_route": st == 200 and tr.get("span_id") in
                 {sp["span_id"] for sp in spans.get("spans", ())},
                 "waterfall_wall_s": wf.get("wall_s") if ws == 200 else None,
                 "waterfall_gap_s": abs(seg_sum - wf["wall_s"]) if ws == 200 else None,
                 "oracle_max_logit_lag": (oracle_lag(params, cfg, dev, p, body["token_ids"])
                                          if code == 200 else None)}
            ok_a = (ok_a and code == 200 and r["tokens"] == MAX_TOKENS
                    and r["phases"] == PHASE_ORDER and r["trace_id_adopted"]
                    and r["trace_route"] and r["waterfall_gap_s"] is not None
                    and r["waterfall_gap_s"] <= 1e-3
                    and r["oracle_max_logit_lag"] <= ORACLE_TIE_EPS)
            reqs.append(r)
        ls, lat = get_json(port, "/engine/latency")
        classes = sorted(lat["models"]["llama3-8b"]["classes"]) if ls == 200 else []
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=60) as r:
            metrics = parse_metrics(r.read().decode())
        ttft_count = sum(v for k, v in metrics.items() if k.startswith("engine_ttft_seconds_count"))
        served = 2 * len(PROMPTS)  # the warm-up and the traced requests
        ok_a = (ok_a and "interactive" in classes and ttft_count == served
                and watch.launches > 0 and watch.plain_calls == 0)
        out["a_traced"] = {"ok": ok_a, "requests": reqs, "latency_classes": classes,
                           "ttft_count": ttft_count, "served": served,
                           "launches": watch.launches, "plain_calls": watch.plain_calls}
        # (b) the perf plane
        _, perf = get_json(port, "/engine/perf")
        snap = perf["models"]["llama3-8b"]
        want = next(((name, flops) for needle, name, flops in CUDA_PEAKS if needle in kind),
                    (CUDA_PEAKS[-1][1] + "?", CUDA_PEAKS[-1][2]))
        ok_b = (snap["platform"] == want[0] and "h100" in snap["platform"]
                and snap["peak_flops"] == want[1] and snap["mfu"] > 0
                and 0 < snap["goodput_ratio"] <= 1)
        out["b_perf"] = {"ok": ok_b, "platform": snap["platform"], "peak_flops": snap["peak_flops"],
                         "mfu": snap["mfu"], "goodput_ratio": snap["goodput_ratio"],
                         "waste_flops": snap["waste_flops"],
                         "timeline_median_ms": timeline_medians(engine)}
        log(f"5g perf: platform {snap['platform']} peak {snap['peak_flops']:.4g} "
            f"MFU {snap['mfu']} goodput {snap['goodput_ratio']}; median host ms per "
            f"tick by phase {out['b_perf']['timeline_median_ms']}")
        # (c) an on-demand profile while the four requests decode
        presults: list = [None] * len(PROMPTS)

        def prun(i):
            presults[i] = post(port, {"text_input": PROMPTS[i],
                                      "parameters": {"max_tokens": PROFILE_TOKENS}})

        with KernelWatch() as pwatch:
            steps0 = engine.stats["decode_steps"]
            threads = [threading.Thread(target=prun, args=(i,)) for i in range(len(PROMPTS))]
            for t in threads:
                t.start()
            decoding = wait_for(lambda: engine.stats["active_slots"] == len(PROMPTS)
                                and not engine._prefilling
                                and engine.stats["decode_steps"] >= steps0 + 3)
            code, armed = post_json(port, "/engine/profile", {"ticks": PROFILE_TICKS})
            done = wait_for(lambda: not get_json(port, "/engine/perf")[1]["models"][
                "llama3-8b"]["profiler"]["active"], timeout=120, step=0.05)
            prof = get_json(port, "/engine/perf")[1]["models"]["llama3-8b"]["profiler"]
            window = engine._profiler.window
            decode_ticks = (sum(1 for r in engine.timeline.snapshot(last=256)
                                if window[0] <= r["tick"] <= window[1]
                                and "decode_dispatch" in r["segments"]) if window else 0)
            for t in threads:
                t.join(timeout=600)
        traces = sorted(glob.glob(os.path.join(prof["runs"][-1]["dir"], "*.json"))) \
            if prof["runs"] else []
        found = paged_records(traces[-1]) if traces else 0
        expected = 2 * cfg.n_layers * decode_ticks
        ok_c = (decoding and code == 200 and done and prof["last_error"] is None
                and prof["captures"] == 1 and decode_ticks > 0 and found == expected
                and all(r is not None and r[0] == 200 for r in presults)
                and pwatch.launches > 0 and pwatch.plain_calls == 0)
        out["c_profile"] = {"ok": ok_c, "armed": armed, "last_error": prof["last_error"],
                            "window": window, "decode_ticks": decode_ticks,
                            "paged_records": found, "expected_records": expected,
                            "trace_mb": os.path.getsize(traces[-1]) / 2**20 if traces else None,
                            "launches": pwatch.launches, "plain_calls": pwatch.plain_calls}
        log(f"5g profile: {found} paged kernel records for {decode_ticks} decode ticks "
            f"(expected {expected} = 2 x {cfg.n_layers} layers x ticks), last_error "
            f"{prof['last_error']}")
        out["leaked_pages"] = leaked_pages(srv.idle(), engine.ec)
    out["launches"] = out["a_traced"]["launches"] + out["c_profile"]["launches"]
    return out


def post_json(port: int, path: str, body: dict) -> tuple:
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def obs_telemetry_cost(params, cfg, dev) -> dict:
    """5g (d): the four prompts with telemetry off and on, in turns (off,
    on, on, off), each submitted before its loop starts: identical tokens;
    host ms per tick and tokens/s beside each other (measured, not gated)."""
    runs = []
    with KernelWatch() as watch:
        for on in (False, True, True, False):
            r = direct_run(params, cfg, dev, EngineConfig(telemetry=on))
            r["telemetry"] = on
            runs.append(r)
            gc.collect()
            torch.cuda.empty_cache()
    identical = all(r["tokens"] == runs[0]["tokens"] for r in runs)
    mean = lambda key, on: float(np.mean([r[key] for r in runs if r["telemetry"] == on]))  # noqa: E731
    out = {"runs": [{k: v for k, v in r.items() if k != "tokens"} for r in runs],
           "tokens": runs[1]["tokens"], "identical_tokens": identical,
           "host_ms_per_tick_off": mean("host_ms_per_tick", False),
           "host_ms_per_tick_on": mean("host_ms_per_tick", True),
           "tokens_per_s_off": mean("tokens_per_s", False),
           "tokens_per_s_on": mean("tokens_per_s", True),
           "launches": watch.launches, "plain_calls": watch.plain_calls}
    out["cost_pct"] = (out["host_ms_per_tick_on"] / out["host_ms_per_tick_off"] - 1) * 100
    out["ok"] = (identical and all(r["leaked_pages"] == 0 for r in runs)
                 and all(len(t) == MAX_TOKENS for t in runs[0]["tokens"])
                 and watch.launches > 0 and watch.plain_calls == 0)
    log(f"5g telemetry cost: host ms/tick off {out['host_ms_per_tick_off']:.3f} on "
        f"{out['host_ms_per_tick_on']:.3f} ({out['cost_pct']:+.2f}%), tokens/s off "
        f"{out['tokens_per_s_off']:.2f} on {out['tokens_per_s_on']:.2f}")
    return out


def supervised(srv) -> list:
    """Wrap the engine's watchdog action: each call records the health the
    watchdog found, the dead loop's last tick time and its own time."""
    seen = []
    engine = srv.engine
    real = engine._supervise

    def supervise(reason):
        seen.append({"state": engine.health()["state"], "reason": reason,
                     "last_tick_ts": engine._last_tick_ts, "ticks": engine._ticks,
                     "at": time.monotonic()})
        real(reason)

    engine._supervise = supervise
    return seen


def after_restart(params, cfg, dev, srv, seen) -> dict:
    """The revived loop: the time from the dead loop's last tick to the new
    loop's first, then one request over HTTP through the kernel."""
    engine = srv.engine
    # the revived loop's first tick advances the tick counter
    revived = wait_for(lambda: seen and engine._ticks > seen[0]["ticks"], timeout=60,
                       step=0.001)
    first_tick = time.monotonic()
    health_ok = wait_for(lambda: engine.health()["state"] == "SERVING"
                         and engine.health()["restarts"] == 1, timeout=60)
    before = PA.paged_attention.launches
    code, body = srv.post(PROMPTS[0], MAX_TOKENS)
    lag = oracle_lag(params, cfg, dev, PROMPTS[0], body["token_ids"]) if code == 200 else None
    return {"revived": revived, "health_ok": health_ok, "health": engine.health(),
            "restart_s": (first_tick - seen[0]["last_tick_ts"]) if seen else None,
            "detect_s": (seen[0]["at"] - seen[0]["last_tick_ts"]) if seen else None,
            "status": code, "tokens": body.get("tokens"), "oracle_max_logit_lag": lag,
            "launches_after": PA.paged_attention.launches - before,
            "ok": (revived and health_ok and code == 200 and body.get("tokens") == MAX_TOKENS
                   and lag <= ORACLE_TIE_EPS and PA.paged_attention.launches > before)}


def obs_watchdog(params, cfg, dev, scratch: str) -> dict:
    """5g (e) die-on-tick and hang restarts, (g) the incident they open."""
    out = {}
    flight, incidents = os.path.join(scratch, "flight"), os.path.join(scratch, "incidents")
    ec = EngineConfig(chaos=FaultConfig(die_on_tick=DIE_TICK), incidents=True,
                      flight_dir=flight, incident_dir=incidents)
    with KernelWatch() as watch:
        srv = Served(params, cfg, dev, ec)
        seen = supervised(srv)
        futs = [srv.engine.generate_async(list(p.encode()), MAX_TOKENS) for p in PROMPTS]
        with srv:
            errors = []
            for f in futs:
                try:
                    f.result(timeout=600)
                    errors.append(None)
                except Exception as e:  # noqa: BLE001 — the typed failure
                    errors.append(type(e).__name__)
            rec = after_restart(params, cfg, dev, srv, seen)
            dumps = sorted(glob.glob(os.path.join(flight, "*.jsonl")))
            header = json.loads(open(dumps[-1]).readline()) if dumps else {}
            inc_ok = wait_for(lambda: any(i.get("bundle_path") for i in get_json(
                srv.server.port, "/engine/incidents")[1]["incidents"]), timeout=30, step=0.05)
            incs = get_json(srv.server.port, "/engine/incidents")[1]["incidents"]
            leaked = leaked_pages(srv.idle(), ec)
    rec.update(errors=errors, supervised=[s["state"] for s in seen],
               dump_reason=header.get("reason"), leaked_pages=leaked,
               launches=watch.launches, plain_calls=watch.plain_calls)
    rec["ok"] = (rec["ok"] and errors == ["TickFailure"] * len(PROMPTS)
                 and header.get("reason") == "watchdog_restart" and leaked == 0
                 and watch.plain_calls == 0)
    out["e_die_on_tick"] = rec
    out["g_incidents"] = {
        "ok": inc_ok and len(incs) == 1 and incs[0]["cause"] == "replica_death"
        and os.path.exists(incs[0]["bundle_path"]),
        "incidents": [{k: i.get(k) for k in ("id", "cause", "detector", "bundle_path")}
                      for i in incs]}
    log(f"5g watchdog: died at tick {DIE_TICK}, detected {rec['detect_s']:.3f} s after "
        f"the last tick, next tick {rec['restart_s']:.3f} s after it; incidents "
        f"{out['g_incidents']['incidents']}")
    gc.collect()
    torch.cuda.empty_cache()
    # the hang: one stalled tick past hang_timeout_s
    ec = EngineConfig(hang_timeout_s=HANG_TIMEOUT_S,
                      chaos=FaultConfig(slow_tick_on=HANG_TICK, slow_tick_s=HANG_S))
    with KernelWatch() as watch:
        srv = Served(params, cfg, dev, ec)
        seen = supervised(srv)
        fut = srv.engine.generate_async(list(PROMPTS[1].encode()), MAX_TOKENS)
        with srv:
            old = srv.engine._thread
            degraded = wait_for(lambda: srv.engine.health()["state"] == "DEGRADED", timeout=60)
            try:
                fut.result(timeout=600)
                error = None
            except Exception as e:  # noqa: BLE001
                error = type(e).__name__
            rec = after_restart(params, cfg, dev, srv, seen)
            stale_exited = wait_for(lambda: not old.is_alive(), timeout=30)
            leaked = leaked_pages(srv.idle(), ec)
    rec.update(error=error, polled_degraded=degraded, supervised=[s["state"] for s in seen],
               stale_thread_exited=stale_exited, leaked_pages=leaked,
               launches=watch.launches, plain_calls=watch.plain_calls)
    rec["ok"] = (rec["ok"] and error == "TickFailure" and degraded
                 and rec["supervised"] == ["DEGRADED"] and stale_exited and leaked == 0
                 and watch.plain_calls == 0)
    out["e_hang"] = rec
    gc.collect()
    torch.cuda.empty_cache()
    out["launches"] = out["e_die_on_tick"]["launches"] + out["e_hang"]["launches"]
    return out


def obs_dispatch_faults(params, cfg, dev, clean_tokens: list, scratch: str) -> dict:
    """5g (f): a NaN aimed at one request's decode rows fails only it (the
    others give their unpoisoned run's tokens), and an HTTP probe it also
    poisons answers 500; a dispatch error on every tick escalates to
    TickFailure after max_consecutive_failures with a flight dump."""
    out = {}
    flight = os.path.join(scratch, "nan_flight")
    ec = EngineConfig(chaos=FaultConfig(nan_logit_rate=1.0, target_rids=(NAN_VICTIM, NAN_PROBE),
                                        nan_phase="decode"), flight_dir=flight)
    with KernelWatch() as watch:
        srv = Served(params, cfg, dev, ec)
        futs = [srv.engine.generate_async(list(p.encode()), MAX_TOKENS) for p in PROMPTS]
        with srv:
            got = []
            for f in futs:
                try:
                    got.append(f.result(timeout=600)["tokens"])
                except Exception as e:  # noqa: BLE001
                    got.append(type(e).__name__)
            code, body = srv.post(PROMPTS[0], MAX_TOKENS)  # rid NAN_PROBE
            leaked = leaked_pages(srv.idle(), ec)
    others = [i for i in range(len(PROMPTS)) if i != NAN_VICTIM]
    out["nan"] = {"victim_result": got[NAN_VICTIM],
                  "others_identical": all(got[i] == clean_tokens[i] for i in others),
                  "probe_status": code, "probe_error": body.get("error"),
                  "dumps": len(glob.glob(os.path.join(flight, "*.jsonl"))),
                  "leaked_pages": leaked, "launches": watch.launches,
                  "plain_calls": watch.plain_calls}
    out["nan"]["ok"] = (got[NAN_VICTIM] == "NonFiniteLogits" and out["nan"]["others_identical"]
                        and code == 500 and "NonFiniteLogits" in (body.get("error") or "")
                        and out["nan"]["dumps"] >= 1 and leaked == 0
                        and watch.launches > 0 and watch.plain_calls == 0)
    gc.collect()
    torch.cuda.empty_cache()
    flight = os.path.join(scratch, "escalation_flight")
    ec = EngineConfig(chaos=FaultConfig(dispatch_error_rate=1.0), flight_dir=flight)
    engine = Engine(params, cfg, ec, device=dev)
    futs = [engine.generate_async(list(PROMPTS[0].encode()), MAX_TOKENS)]
    engine.start()
    try:
        errors = []
        for f in futs:
            try:
                f.result(timeout=600)
                errors.append(None)
            except Exception as e:  # noqa: BLE001
                errors.append(f"{type(e).__name__}: {e}")
        stats = engine.stats
    finally:
        engine.stop()
    dumps = sorted(glob.glob(os.path.join(flight, "*.jsonl")))
    header = json.loads(open(dumps[-1]).readline()) if dumps else {}
    out["escalation"] = {
        "errors": errors, "ticks_failed": stats["ticks_failed"],
        "dump_reason": header.get("reason"),
        # every dispatch fails before it reaches the device: no kernel runs
        "ok": (all(e and e.startswith("TickFailure: rejected after 3 consecutive")
                   for e in errors)
               and stats["ticks_failed"] == ec.max_consecutive_failures
               and header.get("reason") == "tick_failure_escalation")}
    out["launches"] = out["nan"]["launches"]
    return out


def observability(params, cfg, dev, kind: str) -> dict:
    """Phase 5g: the observability and supervision planes at full
    Llama-3-8B: (a) traced requests, (b) the perf plane, (c) an on-demand
    profile, (d) telemetry's cost, (e) the watchdog, (f) dispatch faults,
    (g) incidents."""
    scratch = tempfile.mkdtemp(prefix="chip_smoke_obs_")
    out = {"traced": obs_traced(params, cfg, dev, kind)}
    gc.collect()
    torch.cuda.empty_cache()
    out["telemetry_cost"] = obs_telemetry_cost(params, cfg, dev)
    out["telemetry_cost"]["oracle_max_logit_lag"] = max(
        oracle_lag(params, cfg, dev, p, t)
        for p, t in zip(PROMPTS, out["telemetry_cost"]["tokens"]))
    out["watchdog"] = obs_watchdog(params, cfg, dev, scratch)
    out["dispatch_faults"] = obs_dispatch_faults(
        params, cfg, dev, out["telemetry_cost"]["tokens"], scratch)
    parts = (out["traced"]["a_traced"], out["traced"]["b_perf"], out["traced"]["c_profile"],
             out["telemetry_cost"], out["watchdog"]["e_die_on_tick"], out["watchdog"]["e_hang"],
             out["watchdog"]["g_incidents"], out["dispatch_faults"]["nan"],
             out["dispatch_faults"]["escalation"])
    out["ok"] = (all(p["ok"] for p in parts) and out["traced"]["leaked_pages"] == 0
                 and out["telemetry_cost"]["oracle_max_logit_lag"] <= ORACLE_TIE_EPS)
    out["launches"] = sum(out[k]["launches"] for k in
                          ("traced", "telemetry_cost", "watchdog", "dispatch_faults"))
    return out


# ---------------------------------------------------------------- phase 5h

# 5h (b): the fault replicas.  A2 (prefill) pre-expires its 4th export; B2
# (decode) tears its 1st handoff pull, drops the link on its 2nd and sleeps
# through its 3rd.  The handoff pull has no budget past its socket timeout
# (in the JAX package too), so the slow pull completes as an import.  B2's
# fabric pulls: the 1st torn, the 2nd slower than the pull budget.
HANDOFF_CHAOS = {"torn_pull_on": 1, "dead_link_on": 2, "slow_pull_s": 0.5,
                 "slow_pull_every": 3}
HANDOFF_FAULTS = ("torn", "dead_link", "slow", "expired")
FAULT_TOKENS = 8
FABRIC_CHAOS = {"torn_pull_on": 1, "slow_pull_s": 0.5, "slow_pull_every": 2}
FABRIC_PULL_BUDGET_S = 0.2
# 5h (c): 5c's 1000-byte prompt, case-swapped so that no page of it is in B's
# prefix cache after (a) (phase 5's prompts share 5c's prefix); 16 tokens
# leave 31 full pages of committed KV to publish (L - 1 = 1014 positions)
FABRIC_PROMPT = LONG_PROMPT.swapcase()
FABRIC_TOKENS = 16
FABRIC_PAGES = 31
# cold runs of the same length on B, sharing no page with anything B served
FABRIC_COLD = (LONG_PROMPT[::-1], LONG_PROMPT[::-1].swapcase())


def flight(engine, phase: str) -> list:
    """The flight recorder's ``phase`` events: (seconds, shape)."""
    return [(e["duration_s"], e.get("shape")) for e in engine.flight.snapshot()
            if e.get("phase") == phase]


def outcomes(counter) -> dict:
    return {dict(k)["outcome"]: v for k, v in counter.series().items()}


def parked_fabric_bytes(engine) -> int:
    with engine._lock:
        return sum(p.fabric_import[2] for p in engine._requests.values()
                   if p.fabric_import is not None)


def hand_params(pre: dict, port: int) -> dict:
    """The decode phase's ``handoff`` block, as the reference ingress
    (``ServiceProxy._disagg_prefill``) builds it from the prefill phase."""
    return {"handoff": {"handle": (pre.get("handoff") or {}).get("handle"),
                        "source_port": port, "token_ids": pre["token_ids"],
                        "phase_ttft_s": pre["ttft_s"],
                        "phase_latency_s": pre["latency_s"]}}


def decode_stream(b, prompt: str, params: dict, max_tokens: int) -> dict:
    """The decode phase as an SSE stream on B: its ids, final record, client
    time to the first token event, and the span's pull wall."""
    body = {"text_input": prompt, "parameters": {"max_tokens": max_tokens, **params}}
    code, events, times = sse(b.server.port, STREAM_PATH, body,
                              {"X-Stream-Resume": "1", "X-Request-Trace": "1"})
    tok = [(e, t) for e, t in zip(events, times) if not e.get("done")]
    final = events[-1] if code == 200 and events and events[-1].get("done") else {}
    hints = (final.get("trace") or {}).get("hints") or {}
    return {"status": code, "token_ids": [i for e, _ in tok for i in e.get("token_ids", ())],
            "tokens": final.get("tokens"), "client_first_event_s": tok[0][1] if tok else None,
            "pull_ms": hints.get("pre_handoff_import", 0.0) * 1e3}


def disagg_handoff(params, cfg, dev, a, b) -> dict:
    """5h (a): phase 5's four prompts unified on B (SSE, the baseline), then
    split by hand: each prefill phase on A (``kv_handoff``, concurrent),
    then each decode phase on B (``handoff``, concurrent SSE)."""
    a.warm(PROMPTS)
    b.warm(PROMPTS)
    with KernelWatch() as uw:
        unified = stream_run(b, PROMPTS)["streams"]
    pres: list = [None] * len(PROMPTS)

    def prefill(i):
        pres[i] = a.post(PROMPTS[i], MAX_TOKENS, kv_handoff=True)

    threads = [threading.Thread(target=prefill, args=(i,)) for i in range(len(PROMPTS))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    assert all(r is not None and r[0] == 200 for r in pres), pres
    pres = [r[1] for r in pres]
    before, imports0 = b.engine.stats, outcomes(b.engine.telemetry.kv_handoff).get("import", 0)
    splits: list = [None] * len(PROMPTS)

    def decode(i):
        splits[i] = decode_stream(b, PROMPTS[i], hand_params(pres[i], a.server.port),
                                  MAX_TOKENS)

    with KernelWatch() as dw:
        threads = [threading.Thread(target=decode, args=(i,)) for i in range(len(PROMPTS))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
    after = b.idle()
    steps = after["decode_steps"] - before["decode_steps"]
    imports = outcomes(b.engine.telemetry.kv_handoff).get("import", 0) - imports0
    lags = [oracle_lag(params, cfg, dev, p, s["token_ids"]) if s["token_ids"] else None
            for p, s in zip(PROMPTS, splits)]
    identical = [leading_identical(s["token_ids"], u["token_ids"])
                 for s, u in zip(splits, unified)]
    out = {"prompt_bytes": [len(p) for p in PROMPTS],
           "frame_bytes": [(pr.get("handoff") or {}).get("nbytes") for pr in pres],
           "frame_pages": [(pr.get("handoff") or {}).get("pages") for pr in pres],
           "export_ms": [d * 1e3 for d, _ in flight(a.engine, "handoff_export")],
           "pull_ms": [s["pull_ms"] for s in splits],
           "import_scatter_ms": [d * 1e3 for d, _ in flight(b.engine, "handoff_import")],
           "prefill_phase_ttft_s": [pr["ttft_s"] for pr in pres],
           "decode_phase_first_event_s": [s["client_first_event_s"] for s in splits],
           "unified_first_event_s": [u["client_first_event_s"] for u in unified],
           "unified_engine_ttft_s": [u["engine_ttft_s"] for u in unified],
           "tokens": [s["tokens"] for s in splits], "token_ids": [s["token_ids"] for s in splits],
           "identical_leading_tokens": identical,
           "byte_identical": sum(1 for s, u in zip(splits, unified)
                                 if s["token_ids"] == u["token_ids"]),
           "oracle_max_logit_lag": lags,
           "b_prefill_dispatches": after["prefill_dispatches"] - before["prefill_dispatches"],
           "b_imports": imports, "b_decode_steps": steps,
           "launches": dw.launches, "plain_calls": dw.plain_calls + uw.plain_calls,
           "unified_launches": uw.launches,
           "handles": [(pr.get("handoff") or {}).get("handle") for pr in pres]}
    out["ok"] = (all(s["status"] == 200 and s["tokens"] == MAX_TOKENS for s in splits)
                 and all(lag is not None and lag <= ORACLE_TIE_EPS for lag in lags)
                 and out["b_prefill_dispatches"] == 0 and imports == len(PROMPTS)
                 and dw.launches == cfg.n_layers * steps > 0 and out["plain_calls"] == 0)
    return out


def disagg_faults(params, cfg, dev, a, a2, b2, handle: str) -> dict:
    """5h (b): a repull of an (a) handle answers 404; then, one after
    another, a prefill phase on A2 and a decode phase on B2 per handoff
    fault class; each completes within the oracle bound."""
    code, _ = get_json(a.server.port, f"/engine/kv_handoff/{handle}")
    out = {"repull_status": code, "faults": {}}
    ok = code == 404
    for name in HANDOFF_FAULTS:
        deg0 = outcomes(b2.engine.telemetry.kv_handoff).get("degraded", 0)
        w0 = b2.engine.perf.snapshot()["waste_positions"].get("handoff_degraded", 0)
        c1, pre = a2.post(PROMPTS[1], FAULT_TOKENS, kv_handoff=True)
        c2, r = b2.post(PROMPTS[1], FAULT_TOKENS, **hand_params(pre, a2.server.port))
        deg = outcomes(b2.engine.telemetry.kv_handoff).get("degraded", 0) - deg0
        waste = b2.engine.perf.snapshot()["waste_positions"].get("handoff_degraded", 0) - w0
        lag = oracle_lag(params, cfg, dev, PROMPTS[1], r["token_ids"]) if c2 == 200 else None
        rec = {"status": [c1, c2], "tokens": r.get("tokens"), "degraded": deg,
               "waste_handoff_degraded_positions": waste, "oracle_max_logit_lag": lag}
        # the slow pull completes as an import; every other class re-prefills
        want = 0 if name == "slow" else 1
        rec["ok"] = (c1 == c2 == 200 and r["tokens"] == FAULT_TOKENS and deg == want
                     and (waste > 0) == bool(want) and lag <= ORACLE_TIE_EPS)
        out["faults"][name] = rec
        ok = ok and rec["ok"]
    out["b2_chaos"] = b2.engine.stats["handoff_chaos"]
    out["a2_chaos"] = a2.engine.stats["handoff_chaos"]
    out["ok"] = ok
    return out


def disagg_fabric(params, cfg, dev, a, b, b2) -> dict:
    """5h (c): A serves a 31-page prompt and publishes it; B serves cold
    prompts of the same length around the same prompt with the fabric hint
    (cold, hit, cold); B2's torn and slow pulls degrade."""
    c, first = a.post(FABRIC_PROMPT, FABRIC_TOKENS)
    key = fabric_key(_page_hashes(list(FABRIC_PROMPT.encode()), 32)[FABRIC_PAGES - 1])
    _, perf = get_json(a.server.port, "/engine/perf")
    listed = [e for e in perf["models"]["llama3-8b"]["cache"]["fabric"] if e["key"] == key]
    hint = {"fabric": {"key": key, "source_port": a.server.port, "pages": FABRIC_PAGES}}
    runs = []
    for prompt, params_ in ((FABRIC_COLD[0], {}), (FABRIC_PROMPT, hint), (FABRIC_COLD[1], {})):
        code, r = b.post(prompt, FABRIC_TOKENS, **params_, headers={"X-Request-Trace": "1"})
        hints = (r.get("trace") or {}).get("hints") or {}
        runs.append({"status": code, "tokens": r.get("tokens"), "ttft_s": r.get("ttft_s"),
                     "fabric": r.get("fabric"), "pull_ms": hints.get("pre_fabric_pull", 0.0) * 1e3,
                     "oracle_max_logit_lag": oracle_lag(params, cfg, dev, prompt, r["token_ids"])})
        if params_:  # read before later ticks push it out of the flight ring
            restore = flight(b.engine, "fabric_restore")
    faults = {}
    for name in ("torn", "slow"):
        if name == "slow":
            b2.model._FABRIC_PULL_TIMEOUT_S = FABRIC_PULL_BUDGET_S
        w0 = b2.engine.perf.snapshot()["waste_positions"].get("fabric_degraded", 0)
        code, r = b2.post(FABRIC_PROMPT, FABRIC_TOKENS, **hint)
        waste = b2.engine.perf.snapshot()["waste_positions"].get("fabric_degraded", 0) - w0
        faults[name] = {"status": code, "fabric": r.get("fabric"), "tokens": r.get("tokens"),
                        "waste_fabric_degraded_positions": waste,
                        "oracle_max_logit_lag": oracle_lag(params, cfg, dev, FABRIC_PROMPT,
                                                           r["token_ids"])}
    publish = [(d, sh) for d, sh in flight(a.engine, "fabric_publish")
               if (sh or {}).get("key") == key]
    out = {"key": key, "listed": listed, "publish_ms": [d * 1e3 for d, _ in publish],
           "publish_shape": [sh for _, sh in publish],
           "restore_ms": [d * 1e3 for d, _ in restore], "restore_shape": [sh for _, sh in restore],
           "cold_ttft_s": [runs[0]["ttft_s"], runs[2]["ttft_s"]], "hit_ttft_s": runs[1]["ttft_s"],
           "runs": runs, "faults": faults, "b_fabric": outcomes(b.engine.telemetry.kv_fabric),
           "b2_fabric": outcomes(b2.engine.telemetry.kv_fabric)}
    out["ok"] = (c == 200 and first["tokens"] == FABRIC_TOKENS
                 and len(listed) == 1 and listed[0]["pages"] == FABRIC_PAGES
                 and all(r["status"] == 200 and r["tokens"] == FABRIC_TOKENS
                         and r["oracle_max_logit_lag"] <= ORACLE_TIE_EPS for r in runs)
                 and runs[1]["fabric"] == {"restore": "hit"}
                 and all(f["status"] == 200 and f["tokens"] == FABRIC_TOKENS
                         and f["fabric"] == {"restore": "degraded"}
                         and f["waste_fabric_degraded_positions"] > 0
                         and f["oracle_max_logit_lag"] <= ORACLE_TIE_EPS
                         for f in faults.values()))
    return out


def disaggregation(params, cfg, dev) -> dict:
    """Phase 5h: disaggregated prefill/decode and the fleet KV fabric at full
    Llama-3-8B on ``EngineConfig()`` geometry: replica A (``role="prefill"``,
    ``fabric=True``) and B (``role="decode"``, ``fabric=True``) share one
    params dict, each behind its own ModelServer, split by hand as the
    reference ingress splits them: (a) handoff, (b) refusals and faults on
    the fault replicas A2 and B2, (c) the fabric, (d) leaks and stores."""
    mk = lambda **kw: Replica(params, cfg, dev, EngineConfig(**kw))  # noqa: E731
    with mk(role="prefill", fabric=True) as a, mk(role="decode", fabric=True) as b, \
            mk(role="prefill", handoff_chaos=HandoffFaultConfig(expire_export_on=4)) as a2, \
            mk(role="decode", fabric=True, handoff_chaos=HandoffFaultConfig(**HANDOFF_CHAOS),
               fabric_chaos=FabricFaultConfig(**FABRIC_CHAOS)) as b2:
        out = {"a_handoff": disagg_handoff(params, cfg, dev, a, b)}
        with KernelWatch() as fw:
            out["b_faults"] = disagg_faults(params, cfg, dev, a, a2, b2,
                                            out["a_handoff"]["handles"][0])
            out["c_fabric"] = disagg_fabric(params, cfg, dev, a, b, b2)
        d = {}
        for name, r in (("a", a), ("b", b), ("a2", a2), ("b2", b2)):
            st = r.idle()
            d[name] = {"leaked_pages": leaked_pages(st, r.engine.ec),
                       "handoff_pending": r.engine._handoffs.sweep(),
                       "parked_fabric_bytes": parked_fabric_bytes(r.engine),
                       "swap_used_bytes": st["swap_used_bytes"],
                       "handoff": outcomes(r.engine.telemetry.kv_handoff),
                       "fabric": outcomes(r.engine.telemetry.kv_fabric)}
        out["d_leaks"] = d
    h, f = out["a_handoff"], out["c_fabric"]
    log(f"5h handoff: frames {h['frame_bytes']} B, export ms {h['export_ms']}, pull ms "
        f"{h['pull_ms']}, scatter ms {h['import_scatter_ms']}; decode-phase first event s "
        f"{h['decode_phase_first_event_s']} vs unified {h['unified_first_event_s']}; "
        f"byte-identical {h['byte_identical']}/{len(PROMPTS)}, B prefills "
        f"{h['b_prefill_dispatches']}, imports {h['b_imports']}, launches {h['launches']}")
    log(f"5h faults: repull {out['b_faults']['repull_status']}, " + ", ".join(
        f"{k} degraded={v['degraded']}" for k, v in out["b_faults"]["faults"].items()))
    log(f"5h fabric: listed {f['listed']}, publish ms {f['publish_ms']}, hit ttft "
        f"{f['hit_ttft_s']} s (pull ms {f['runs'][1]['pull_ms']}, scatter ms "
        f"{f['restore_ms']}) vs cold {f['cold_ttft_s']}; faults "
        f"{ {k: v['fabric'] for k, v in f['faults'].items()} }")
    log(f"5h leaks: {out['d_leaks']}")
    out["launches"] = (out["a_handoff"]["launches"] + out["a_handoff"]["unified_launches"]
                       + fw.launches)
    out["plain_calls"] = out["a_handoff"]["plain_calls"] + fw.plain_calls
    out["ok"] = (out["a_handoff"]["ok"] and out["b_faults"]["ok"] and out["c_fabric"]["ok"]
                 and out["plain_calls"] == 0
                 and all(v["leaked_pages"] == 0 and v["handoff_pending"] == 0
                         and v["parked_fabric_bytes"] == 0 and v["swap_used_bytes"] == 0
                         for v in d.values()))
    return out


# ----------------------------------------------------------------- phase 6


def profile_decode(params, cfg, dev) -> dict:
    """Where a main-path decode step's time goes: the engine's default pool
    and 8 slots, the four served requests at their final lengths, paged and
    gather steps timed on the host clock, then one torch.profiler window
    over paged steps for device busy time by kernel family."""
    ec = EngineConfig()
    shape = (cfg.n_layers, ec.num_pages, cfg.n_kv_heads, ec.page_size, cfg.head_dim)
    k_pool, v_pool = M.make_kv_pool(shape, device=dev), M.make_kv_pool(shape, device=dev)
    lens = [len(p) + MAX_TOKENS for p in PROMPTS] + [0] * (ec.max_slots - len(PROMPTS))
    table = torch.zeros((ec.max_slots, ec.max_pages_per_slot), dtype=torch.int32)
    nxt = 1
    for b, n in enumerate(lens):
        pages = -(-n // ec.page_size)
        table[b, :pages] = torch.arange(nxt, nxt + pages)
        nxt += pages
    table = table.to(dev)
    lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
    toks = torch.zeros(ec.max_slots, dtype=torch.int32, device=dev)

    def steps(paged, n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            M.decode_step(params, cfg, toks, lens_t, table, k_pool, v_pool, paged=paged)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3

    out = {"ok": True, "lens": lens}
    for paged in (True, False, False, True):  # in turns on one card
        steps(paged, 2)
        out.setdefault("paged_step_ms" if paged else "gather_step_ms", []).append(
            steps(paged, 10))
    n = 5
    with torch.profiler.profile(activities=PROFILE_ACTIVITIES, acc_events=True) as prof:
        wall_ms = steps(True, n)
    out.update(device_breakdown(prof, n, wall_ms, "paged_attention", PAGED_MARKERS))
    # the engine's loop at both depths on one card; a tick's device work is
    # the decode step profiled above
    out["engine"] = [profile_engine(params, cfg, dev, depth) for depth in (1, 0)]
    busy = out.get("device_busy_ms_per_step")
    for e in out["engine"]:
        if busy and e["host_ms_per_tick"]:
            e["device_idle_share"] = max(0.0, 1 - busy / e["host_ms_per_tick"])
    out["ok"] = all(e["ok"] for e in out["engine"])
    return out


# host calls that wait on the device, as the profiler names CUDA runtime calls
WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
         "cudaMemcpy")
ENGINE_TICKS, ENGINE_PROFILED_TICKS = 12, 6


def profile_engine(params, cfg, dev, depth: int) -> dict:
    """The engine's own decode loop at ``pipeline_depth`` ``depth``, with the
    four served prompts decoding together: host ms per tick on the wall
    clock over ``ENGINE_TICKS`` ticks, then a torch.profiler window of
    ``ENGINE_PROFILED_TICKS`` ticks counting the host calls that wait on the
    device per tick (``WAITS``; ``cudaMemcpy`` is the blocking copy, not
    ``cudaMemcpyAsync``; the window's closing ``cudaDeviceSynchronize`` is
    the profile's own).  The pipelined loop should wait once per tick (its
    commit-behind's event), the sync loop at every upload and readback.
    (The window's kernel records are not used: on the H100 the profiler has
    dropped every kernel of one of the two engine windows in some runs,
    never the runtime calls.)"""
    engine = Engine(params, cfg, EngineConfig(pipeline_depth=depth), device=dev)
    futs = [engine.generate_async(list(p.encode()), 40) for p in PROMPTS]
    engine.start()

    def ticks_after(n, deadline):
        # a plain counter polled every 2 ms: reading ``stats`` (a lock and
        # C calls) in a tight loop would take the interpreter lock from the
        # engine's thread and slow the very ticks being timed
        s0, t0 = engine._decode_steps, time.perf_counter()
        while engine._decode_steps < s0 + n and time.monotonic() < deadline:
            time.sleep(0.002)
        return engine._decode_steps - s0, time.perf_counter() - t0

    try:
        deadline = time.monotonic() + 120
        # every prompt prefilled and decoding
        while ((engine._prefilling or engine._decode_steps < 2)
               and time.monotonic() < deadline):
            time.sleep(0.002)
        n, wall = ticks_after(ENGINE_TICKS, deadline)
        with torch.profiler.profile(activities=PROFILE_ACTIVITIES) as prof:
            n_prof, _ = ticks_after(ENGINE_PROFILED_TICKS, deadline)
            torch.cuda.synchronize()
        results = [f.result(timeout=300) for f in futs]
    finally:
        engine.stop()
    waits = {w: 0 for w in WAITS}
    for e in prof.events():
        if e.name in waits:
            waits[e.name] += 1
    per_tick = {k: v / n_prof for k, v in waits.items()} if n_prof else {}
    return {"pipeline_depth": depth, "ticks": n, "profiled_ticks": n_prof,
            "host_ms_per_tick": wall / n * 1e3 if n else None,
            "waits_per_tick": per_tick,
            # the pipelined loop never blocks on a copy or a stream
            "ok": (n > 0 and n_prof > 0 and all(r["num_tokens"] == 40 for r in results)
                   and (depth == 0 or (per_tick["cudaStreamSynchronize"] == 0
                                       and per_tick["cudaMemcpy"] == 0)))}


PROFILE_ACTIVITIES = [torch.profiler.ProfilerActivity.CPU,
                      torch.profiler.ProfilerActivity.CUDA]


def device_breakdown(prof, n: int, wall_ms: float, family: str, markers: tuple) -> dict:
    """Device busy time, idle share and device ms per step by kernel family
    (``family`` = kernels whose name holds one of ``markers``, then GEMMs,
    then the rest) from a profiler window of ``n`` steps of ``wall_ms``
    each."""
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kern:
        return {"device_time": "not measured (the profiler recorded no device events)"}
    spans = sorted((e.time_range.start, e.time_range.end) for e in kern)
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s0, e0 in spans[1:]:
        if s0 > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s0, e0
        else:
            cur_e = max(cur_e, e0)
    busy += cur_e - cur_s
    fam: dict = {}
    by_name: dict = {}
    for e in kern:
        name = e.name.lower()
        key = (family if any(m in name for m in markers) else
               "gemm" if any(t in name for t in ("gemm", "gemv", "nvjet", "xmma", "cutlass")) else
               "other")
        dt = e.time_range.end - e.time_range.start
        fam[key] = fam.get(key, 0.0) + dt
        by_name[e.name[:100]] = by_name.get(e.name[:100], 0.0) + dt
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return {"profiled_step_ms": wall_ms, "device_busy_ms_per_step": busy / n / 1e3,
            "device_idle_share": max(0.0, 1 - busy / 1e3 / (wall_ms * n)),
            "kernels_per_step": len(kern) / n,
            "device_ms_per_step": {k: v / n / 1e3 for k, v in sorted(fam.items())},
            "top_kernels_ms_per_step": [[k, v / n / 1e3] for k, v in top]}


# ----------------------------------------------------------------- phase 7

# BERT-base attention: B*H = 32*12 rows, S = T = 512, d = 64; the JAX
# package's default blocks (128) as the encoder calls them
FB, FH, FS, FD, FBLOCK = 32, 12, 512, 64, 128
# kernel vs plain, f32: both in f32, summation order only (the reference's
# f32 kernel bound); lse is f32 on both sides in every case
FLASH_F32_TOL = 1e-5


def flash_case(name, dtype, S, causal, key_mask, rng, dev, flush) -> dict:
    """One ``flash_attention`` forward case: kernel vs plain (out and lse),
    times of the kernel, the plain version and SDPA with the same boolean
    mask, and the bound.  ``key_mask``: None, "ragged" (batch row 0 keeps
    300 keys) or "left" (batch row 1's first 200 keys padded: under causal,
    its first 200 query rows see no key)."""
    bh, scale = FB * FH, FD ** -0.5
    q, k, v = (torch.from_numpy(rng.standard_normal((bh, S, FD), dtype=np.float32)).to(
        dev, dtype) for _ in range(3))
    am = torch.ones((FB, S), device=dev)
    if key_mask == "ragged":
        am[0, 300:] = 0
    elif key_mask == "left":
        am[1, :200] = 0
    mask = am.reshape(FB, 1, S) if key_mask else None
    block = min(FBLOCK, S)
    args = (q, k, v, mask, scale, causal, block, block)

    out, lse = FA._flash_fwd(*args, FH)
    ref, ref_lse = FA.flash_attention_plain(*args)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs()
    rtol, atol = ((KERNEL_RTOL, KERNEL_ATOL) if dtype == torch.bfloat16
                  else (FLASH_F32_TOL, FLASH_F32_TOL))
    lse_err = (lse - ref_lse).abs()
    ok = (bool(torch.all(err <= atol + rtol * ref.float().abs()))
          and bool(torch.all(lse_err <= FLASH_F32_TOL + FLASH_F32_TOL * ref_lse.abs()))
          and bool(torch.isfinite(out).all()))
    if key_mask == "left" and causal:
        # batch row 1, head 0, query row 5 sees no key: it averages V over
        # the keys its block visits (0..block-1), as the TPU kernel does
        want = v[FH, :block].float().mean(0)
        ok = ok and bool(torch.allclose(out[FH, 5].float(), want, rtol=rtol, atol=atol))

    # the yardstick: one library call, the same boolean mask
    bm = am[:, None, None, :] > 0.5
    if causal:
        bm = bm & torch.ones((S, S), dtype=torch.bool, device=dev).tril()
    qs, ks, vs = (t.view(FB, FH, S, FD) for t in (q, k, v))

    def library():
        return torch.nn.functional.scaled_dot_product_attention(qs, ks, vs, attn_mask=bm)

    kernel_ms = time_ms(lambda: FA._flash_fwd(*args, FH), flush)
    device_ms = profiled_ms(lambda: FA._flash_fwd(*args, FH), flush, FLASH_MARKERS)["total"]
    plain_ms = time_ms(lambda: FA.flash_attention_plain(*args), flush)
    library_ms = time_ms(library, flush)
    # the backward the training path pairs with the kernel: the JAX
    # package's blockwise recompute in f32 torch (no kernel on either side)
    do = torch.randn_like(out)
    backward_ms = time_ms(lambda: FA._flash_bwd(q, k, v, mask, out, lse, do, scale, causal,
                                                block, FH), flush)

    # the bound: q, k, v (and the mask) read once, out and lse written once;
    # the operations of QK^T and PV over the keys each row visits
    visited = int(FA._visited(S, S, causal, block, block, dev).sum()) * bh
    io_bytes = (4 * q.numel() * q.element_size() + lse.numel() * 4
                + (mask.numel() * 4 if mask is not None else 0))
    flops = 4 * FD * visited
    peak = BF16_FLOPS_PER_S if dtype == torch.bfloat16 else F32_FLOPS_PER_S
    t_bytes, t_ops = io_bytes / HBM_BYTES_PER_S, flops / peak
    return {"case": name, "dtype": str(dtype).removeprefix("torch."), "S": S,
            "causal": causal, "key_mask": key_mask, "max_abs_err": float(err.max()),
            "max_lse_err": float(lse_err.max()), "ok": ok, "kernel_ms": kernel_ms,
            "device_ms": device_ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "kernel_over_library": kernel_ms / library_ms, "backward_ms": backward_ms,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "io_bytes": io_bytes, "flops": flops}


# ----------------------------------------------------------------- phase 8

TRAIN_B, TRAIN_S = 32, 512
TRAIN_P = 20 * TRAIN_S // 128  # benchmarks/mfu_sweep.py's max_predictions
TRAIN_WARM, TRAIN_TIMED, TRAIN_PROFILED, TRAIN_DENSE = 2, 10, 3, 5
# flash vs dense loss and gradient global norm on one batch from the same
# weights, rtol.  The reference holds the two paths at 1e-4 (loss) and 5e-3
# (gradients) over 2 layers (tests/test_longcontext.py:143-145).  Dense rounds
# its softmax probabilities to bf16 before the PV product and the kernel
# keeps them in f32, so each of the 12 layers adds one such rounding
# difference to the residual stream and the two drift apart like a random
# walk: the 2-layer bounds scaled by sqrt(12 / 2), as phase 4 scales its
# decode bound with depth.
TRAIN_LOSS_RTOL = 1e-4 * (12 / 2) ** 0.5
TRAIN_GRAD_RTOL = 5e-3 * (12 / 2) ** 0.5


def train_batches(vocab: int, n: int, seed: int = 0) -> list:
    """``n`` synthetic MLM batches (the JAX package's generator) with ragged
    padding: row 0 full, the others 256..512 real tokens, padded positions
    masked out of attention and the loss."""
    gen = synthetic_mlm_batches(vocab, TRAIN_B, TRAIN_S, seed=seed)
    rng = np.random.default_rng(seed + 1)
    out = []
    for _ in range(n):
        b = next(gen)
        lens = rng.integers(TRAIN_S // 2, TRAIN_S + 1, TRAIN_B)
        lens[0] = TRAIN_S
        pad = np.arange(TRAIN_S)[None, :] >= lens[:, None]
        b["attention_mask"][pad] = 0
        b["labels"][pad] = -100
        out.append(b)
    return out


def train(dev) -> dict:
    cfg = bert.BertConfig(attention="flash")
    dense_cfg = dataclasses.replace(cfg, attention="dense")
    t0 = time.perf_counter()
    model = bert.init(cfg, dev, seed=0)
    init_s = time.perf_counter() - t0
    batches = train_batches(cfg.vocab_size, 1 + TRAIN_WARM + TRAIN_TIMED + TRAIN_PROFILED)
    out: dict = {"config": "BERT-base (BertConfig defaults), attention=flash",
                 "batch": TRAIN_B, "seq": TRAIN_S, "max_predictions": TRAIN_P,
                 "init_s": init_s, "num_params": cfg.num_params}

    # flash vs dense on one batch, same weights
    def loss_and_norm(c):
        b = to_device(batches[0], dev)
        loss = bert.mlm_loss(model, c, b["input_ids"], b["labels"], b["attention_mask"],
                             max_predictions=TRAIN_P)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        return float(loss.detach()), float(global_norm(grads))

    lf, gf = loss_and_norm(cfg)
    ld, gd = loss_and_norm(dense_cfg)
    loss_rel, grad_rel = abs(lf - ld) / abs(ld), abs(gf - gd) / abs(gd)
    out["vs_dense"] = {"flash_loss": lf, "dense_loss": ld, "loss_rel": loss_rel,
                       "flash_grad_norm": gf, "dense_grad_norm": gd, "grad_rel": grad_rel,
                       "loss_rtol": TRAIN_LOSS_RTOL, "grad_rtol": TRAIN_GRAD_RTOL}
    parity_ok = loss_rel <= TRAIN_LOSS_RTOL and grad_rel <= TRAIN_GRAD_RTOL
    torch.cuda.empty_cache()

    def loss_fn(m, b):
        return bert.mlm_loss(m, cfg, b["input_ids"], b["labels"], b["attention_mask"],
                             max_predictions=TRAIN_P)

    flops = cfg.train_flops(TRAIN_B, TRAIN_S, TRAIN_P)
    trainer = Trainer(loss_fn, model,
                      TrainerConfig(learning_rate=1e-4, warmup_steps=2, total_steps=16),
                      flops_per_batch=flops, device=dev)
    it = iter(batches[1:])
    warm = [trainer.train_step(next(it)) for _ in range(TRAIN_WARM)]

    # the main path's run: counts from zero, the plain version watched
    plain_calls = [0]
    plain = FA.flash_attention_plain

    def counting_plain(*a, **kw):
        plain_calls[0] += 1
        return plain(*a, **kw)

    FA.flash_attention_plain = counting_plain
    torch.cuda.reset_peak_memory_stats(dev)
    try:
        FA.flash_attention.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = [trainer.train_step(next(it), sync=False) for _ in range(TRAIN_TIMED)]
        trainer.block_until_ready()
        wall = time.perf_counter() - t0
        launches = FA.flash_attention.launches
    finally:
        FA.flash_attention_plain = plain
    losses = [float(m["loss"]) for m in metrics]
    norms = [float(m["grad_norm"]) for m in metrics]
    step_s = wall / TRAIN_TIMED
    real_tokens = sum(int(b["attention_mask"].sum())
                      for b in batches[1 + TRAIN_WARM:1 + TRAIN_WARM + TRAIN_TIMED])
    finite = all(math.isfinite(x) for x in losses + norms + [m["loss"] for m in warm])
    out.update({
        "warmup_losses": [m["loss"] for m in warm], "losses": losses, "grad_norms": norms,
        "launches": launches, "launches_per_step": launches / TRAIN_TIMED,
        "plain_calls": plain_calls[0], "step_ms": step_s * 1e3,
        "samples_per_s": TRAIN_B / step_s, "tokens_per_s": TRAIN_B * TRAIN_S / step_s,
        "real_tokens_per_s": real_tokens / wall, "train_flops_per_step": flops,
        "tflops_per_s": flops / step_s / 1e12, "mfu": flops / step_s / BF16_FLOPS_PER_S,
        "peak_memory_gib": torch.cuda.max_memory_allocated(dev) / 2**30})
    out["ok"] = (parity_ok and finite and plain_calls[0] == 0
                 and launches == cfg.num_layers * TRAIN_TIMED)

    # where a step's device time goes
    with torch.profiler.profile(activities=PROFILE_ACTIVITIES, acc_events=True) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(TRAIN_PROFILED):
            trainer.train_step(next(it), sync=False)
        trainer.block_until_ready()
        wall_ms = (time.perf_counter() - t0) / TRAIN_PROFILED * 1e3
    out["profile"] = device_breakdown(prof, TRAIN_PROFILED, wall_ms, "flash_attention",
                                      FLASH_MARKERS)

    # the same steps on the dense path (same trainer, another loss), for
    # the end-to-end comparison
    def dense_loss(m, b):
        return bert.mlm_loss(m, dense_cfg, b["input_ids"], b["labels"], b["attention_mask"],
                             max_predictions=TRAIN_P)

    trainer.loss_fn = dense_loss
    trainer.train_step(batches[1])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches[2:2 + TRAIN_DENSE]:
        trainer.train_step(b, sync=False)
    trainer.block_until_ready()
    out["dense_step_ms"] = (time.perf_counter() - t0) / TRAIN_DENSE * 1e3
    return out


# ---------------------------------------------------------------- phase 6b

RUNTIME_READY_S = 600


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def runtime(cfg) -> dict:
    """Phase 6b: the pod entry point, ``python -m
    kubeflow_tpu_torch.serving.runtime_main --loader jetstream``, on a
    model dir holding Llama-3-8B's ``config.json`` (no weights: random init
    on the card) and an ``engine.json`` with ``scheduler`` and ``kv_store``
    blocks; time to ``/v2/health/ready``, one unary generate, one stream
    and ``/engine/health``, then terminate.  The subprocess's kernel
    launches cannot be read from here."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        with open(os.path.join(tmp, "config.json"), "w") as f:
            json.dump(dataclasses.asdict(cfg), f)
        with open(os.path.join(tmp, "engine.json"), "w") as f:
            json.dump({"scheduler": {"policy": "priority", "swap_policy": "swap",
                                     "adapter_weights": []},
                       "kv_store": {"host_max_bytes": 1 << 30,
                                    "disk_dir": os.path.join(tmp, "kv")}}, f)
        port = free_port()
        env = dict(os.environ, PYTHONPATH=REPO)
        env.pop("TORCH_DEVICE", None)  # the entry point's default: the card
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", "kubeflow_tpu_torch.serving.runtime_main",
             "--loader", "jetstream", "--model-name", "llama3-8b", "--model-dir", tmp,
             "--port", str(port)], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        out: dict = {}
        try:
            ready = None
            while time.perf_counter() - t0 < RUNTIME_READY_S and proc.poll() is None:
                try:
                    with urllib.request.urlopen(f"http://127.0.0.1:{port}/v2/health/ready",
                                                timeout=5) as r:
                        if r.status == 200:
                            ready = time.perf_counter() - t0
                            break
                except OSError:
                    pass
                time.sleep(0.2)
            out["ready_s"] = ready
            if ready is not None:
                code, body = post(port, {"text_input": PROMPTS[1],
                                         "parameters": {"max_tokens": MAX_TOKENS}})
                out["generate"] = {"status": code, "tokens": body.get("tokens"),
                                   "ttft_s": body.get("ttft_s")}
                code, events, times = sse(port, STREAM_PATH,
                                          {"text_input": PROMPTS[2],
                                           "parameters": {"max_tokens": MAX_TOKENS}})
                final = events[-1] if events and isinstance(events[-1], dict) else {}
                out["stream"] = {"status": code, "tokens": final.get("tokens"),
                                 "ttft_s": final.get("ttft_s"),
                                 "client_first_event_s": times[0] if times else None}
                code, health = get_json(port, "/engine/health")
                out["health"] = {"status": code, "state": health.get("state")}
        finally:
            proc.terminate()
            try:
                stdout, stderr = proc.communicate(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                stdout, stderr = proc.communicate()
        out.update(exit_code=proc.returncode, stdout=stdout.strip().splitlines()[-3:],
                   stderr_tail=stderr[-1500:], traceback="Traceback" in stderr)
    out["ok"] = (out["ready_s"] is not None and not out["traceback"]
                 and out["exit_code"] is not None
                 and out["generate"]["status"] == 200 and out["generate"]["tokens"] == MAX_TOKENS
                 and out["stream"]["status"] == 200 and out["stream"]["tokens"] == MAX_TOKENS
                 and out["health"] == {"status": 200, "state": "SERVING"})
    return out


# ----------------------------------------------------------------- phase 9


def worker(dev) -> dict:
    """The TPUJob worker's auto-resume contract on the card: killed at step
    3 (exit 137), rerun, resumed from the step-2 checkpoint, done at 4."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        env = dict(os.environ, CHECKPOINT_DIR=os.path.join(tmp, "ckpt"), TRAIN_STEPS="4",
                   CHECKPOINT_EVERY="2", FAIL_AT_STEP="3",
                   FAIL_MARKER=os.path.join(tmp, "failed"))
        env.pop("TORCH_DEVICE", None)  # the worker's default: the card
        cmd = [sys.executable, "-m", "kubeflow_tpu_torch.examples.bert_worker"]
        runs = [subprocess.run(cmd, env=env, cwd=REPO, capture_output=True, text=True,
                               timeout=300) for _ in range(2)]
    first, second = runs
    ok = (first.returncode == 137 and "resumed_from=0" in first.stdout
          and "TRAIN-DONE" not in first.stdout
          and second.returncode == 0 and "resumed_from=2" in second.stdout
          and "TRAIN-DONE step=4" in second.stdout)
    return {"ok": ok, "exit_codes": [r.returncode for r in runs],
            "stdout": [r.stdout.strip().splitlines() for r in runs],
            "stderr_tail": [r.stderr[-1500:] for r in runs if r.returncode not in (0, 137)]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None,
                    help="also write every measured number to this JSON file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False — this smoke run needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    report: dict = {"phases": {}}
    failed: list = []

    def phase(name, fn):
        log(f"== phase {name}")
        t0 = time.perf_counter()
        try:
            res = fn()
        except Exception:  # noqa: BLE001 — report the phase and go on
            traceback.print_exc()
            res = {"ok": False, "error": traceback.format_exc(limit=3)}
        res["seconds"] = time.perf_counter() - t0
        report["phases"][name] = res
        log(json.dumps({name: brief(res)}, default=str))
        if not res.get("ok", False):
            failed.append(name)
        return res

    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    report["device"] = {"name": kind, "nvidia_smi": smi,
                        "torch": torch.__version__, "cuda": torch.version.cuda}
    log(f"device: {kind} (torch {torch.__version__}, CUDA {torch.version.cuda})")

    def build():
        # one compiler per source, all started together
        def timed(fn):
            t0 = time.perf_counter()
            fn()
            return time.perf_counter() - t0

        t0 = time.perf_counter()
        with ThreadPoolExecutor(3) as pool:
            futs = {name: pool.submit(timed, fn) for name, fn in (
                ("paged_attention_s", PA.load_kernel), ("flash_attention_s", FA.load_kernel),
                ("core_s", load_library))}
            res = {name: f.result() for name, f in futs.items()}
        return {"ok": True, **res, "wall_s": time.perf_counter() - t0}

    phase("build", build)

    def kernels():
        rng = np.random.default_rng(0)
        flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
        cases = [kernel_case(quant, K, rng, dev, flush)
                 for quant in (None, "int8") for K in (1, 5)]
        return {"ok": all(c["ok"] for c in cases), "cases": cases}

    kres = phase("kernel", kernels)

    cfg = M.DecoderConfig.llama3_8b()
    t0 = time.perf_counter()
    params = M.init(cfg, dev, seed=0)
    torch.cuda.synchronize()
    log(f"init llama3_8b: {cfg.param_count() / 1e9:.2f}B params in "
        f"{time.perf_counter() - t0:.1f}s, {torch.cuda.memory_allocated() / 2**30:.1f} GiB")

    def decode():
        with torch.inference_mode():
            return decode_parity(params, cfg, dev)

    phase("decode", decode)
    served = [phase("main_path", lambda: main_path(params, cfg, dev)),
              phase("speculative", lambda: speculative(params, cfg, dev)),
              phase("prefix_cache", lambda: prefix_cache(params, cfg, dev)),
              phase("qos", lambda: qos(params, cfg, dev)),
              phase("sessions", lambda: sessions(params, cfg, dev)),
              phase("streaming", lambda: streaming(params, cfg, dev)),
              phase("observability", lambda: observability(params, cfg, dev, kind)),
              phase("disagg", lambda: disaggregation(params, cfg, dev))]

    def profile():
        with torch.inference_mode():
            return profile_decode(params, cfg, dev)

    phase("profile", profile)

    # the serving phases are done: free Llama-3-8B before the pod entry
    # point loads its own, and before training
    del params
    gc.collect()
    torch.cuda.empty_cache()
    phase("runtime", lambda: runtime(cfg))

    def flash_kernel():
        rng = np.random.default_rng(0)
        flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
        bf16 = torch.bfloat16
        cases = [flash_case("ragged", bf16, FS, False, "ragged", rng, dev, flush),
                 flash_case("causal", bf16, FS, True, None, rng, dev, flush),
                 flash_case("causal_left_pad", bf16, FS, True, "left", rng, dev, flush),
                 flash_case("f32_causal_left_pad", torch.float32, 128, True, "left", rng,
                            dev, flush)]
        return {"ok": all(c["ok"] for c in cases), "cases": cases}

    fres = phase("flash_kernel", flash_kernel)
    tres = phase("train", lambda: train(dev))
    phase("worker", lambda: worker(dev))

    cases = kres.get("cases") or []
    head = next((c for c in cases if c["pool"] == "bf16" and c["K"] == 1), {})
    record = {"name": "paged_attention", "route": "cuda",
              "source": "kubeflow_tpu_torch/serving/engine/csrc/paged_attention.cu",
              "replaces": "kubeflow_tpu/serving/engine/paged_attention.py:58",
              "tpu_kernel": "kubeflow_tpu/serving/engine/paged_attention.py:_kernel",
              # every served path in this process: phase 5's two loops,
              # speculative, prefix cache, QoS preemption, session restores
              # and the streaming surfaces (the runtime phase's subprocess
              # launches the kernel too, but its counter is not readable here)
              "launches": sum(r.get("launches", 0) for r in served),
              "max_abs_err": max((c["max_abs_err"] for c in cases), default=None),
              "ms": head.get("kernel_ms"), "kernel_ms": head.get("kernel_ms"),
              "device_ms": head.get("device_ms"), "plain_ms": head.get("plain_ms"),
              "bound_ms": head.get("bound_ms"),
              "bound_by": head.get("bound_by"), "library_ms": head.get("library_ms")}
    fcases = fres.get("cases") or []
    fhead = next((c for c in fcases if c["case"] == "ragged"), {})  # the training path's case
    frecord = {"name": "flash_attention", "route": "cuda",
               "source": "kubeflow_tpu_torch/ops/csrc/flash_attention.cu",
               "replaces": "kubeflow_tpu/ops/flash_attention.py:40",
               "tpu_kernel": "kubeflow_tpu/ops/flash_attention.py:_fwd_kernel",
               "launches": tres.get("launches", 0),
               "max_abs_err": max((c["max_abs_err"] for c in fcases), default=None),
               "ms": fhead.get("kernel_ms"), "kernel_ms": fhead.get("kernel_ms"),
               "device_ms": fhead.get("device_ms"), "plain_ms": fhead.get("plain_ms"),
               "bound_ms": fhead.get("bound_ms"),
               "bound_by": fhead.get("bound_by"), "library_ms": fhead.get("library_ms")}
    report["kernels"] = [record, frecord]
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1, default=str)
    print(json.dumps({"kernels": report["kernels"]}), flush=True)
    print(smi, flush=True)
    if failed:
        print(f"FAIL: phases {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
