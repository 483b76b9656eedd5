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
6. profile: one main-path decode step (8 slots, the served lengths), paged
   and gather in turns on the host clock, and a torch.profiler window for
   device busy time by kernel family and the device's idle share; then the
   engine's own loop at ``pipeline_depth`` 1 and 0 with the four prompts
   decoding: host ms per tick, the device idle share (the step's device
   time over the tick), and the host calls that wait on the device per
   tick (the pipelined loop must block on no copy and no stream);
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

The Llama-3-8B weights are freed before phase 7.  The last lines are the
``{"kernels": [...]}`` record, the ``nvidia-smi`` line and
``{"ok": true, "device": {...}}``.  Weights are random (seed 0) at full
width (and, for the phases that serve, full depth).
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib
import itertools
import json
import math
import os
import subprocess
import sys
import tempfile
import threading
import time
import traceback
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from kubeflow_tpu_torch.serving.engine import model as M
from kubeflow_tpu_torch.serving.engine import paged_attention as PA
from kubeflow_tpu_torch.serving.engine.engine import Engine, EngineConfig
from kubeflow_tpu_torch.serving.engine.native import load_library
from kubeflow_tpu_torch.serving.engine.serve import JetStreamModel
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


def post(port: int, body: dict) -> tuple:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v2/models/llama3-8b/generate",
        data=json.dumps(body).encode(), headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        return r.status, json.loads(r.read())


def oracle_lag(params, cfg, dev, prompt: str, got: list) -> float:
    """How far the served tokens fall below the ``forward_full`` max logit
    along their own trajectory (prompt + generation), at the worst step."""
    ids = list(prompt.encode())
    with torch.inference_mode():
        logits = M.forward_full(params, cfg, torch.tensor(
            [ids + got[:-1]], device=dev))[0, len(ids) - 1:]
    picked = logits[torch.arange(len(got), device=dev), torch.tensor(got, device=dev)]
    return (logits.max(-1).values - picked).max().item()


def serve(params, cfg, dev, ec: EngineConfig, prompts: list, sequential=False) -> dict:
    """``Engine(ec)`` -> ``JetStreamModel`` -> ``ModelServer`` on 127.0.0.1:
    a warm-up, then ``prompts`` (concurrently, or one after another
    with the cache counters read after each), with the paged kernel's
    launches counted from zero for this run; every served request checked
    against the ``forward_full`` oracle."""
    engine = Engine(params, cfg, ec, device=dev)
    model = JetStreamModel("llama3-8b", engine=engine)
    server = ModelServer([model], port=0, host="127.0.0.1")
    server.start()
    try:
        # warm-up: prompts of the served lengths with other bytes (the same
        # prefill shapes, no prefix shared with the counted run), so neither
        # run of a phase pays first-use costs the other does not
        with ThreadPoolExecutor(len(prompts)) as pool:
            warm = list(pool.map(lambda p: post(server.port, {
                "text_input": p[::-1].swapcase(), "parameters": {"max_tokens": 2}}),
                prompts))
        assert all(code == 200 for code, _ in warm)
        before = engine.stats
        PA.paged_attention.launches = 0
        PA.paged_attention.launches_by_k = {}
        # the plain version, watched: a CUDA engine must never run it
        plain_calls = [0]
        plain = PA.paged_attention_plain

        def counting_plain(*a, **kw):
            plain_calls[0] += 1
            return plain(*a, **kw)

        PA.paged_attention_plain = counting_plain
        results: list = [None] * len(prompts)
        after_each: list = []

        def run(i):
            results[i] = post(server.port, {"text_input": prompts[i],
                                            "parameters": {"max_tokens": MAX_TOKENS}})

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
        launches = PA.paged_attention.launches
        by_k = dict(PA.paged_attention.launches_by_k)
        deadline = time.monotonic() + 30
        while engine.stats["active_slots"] and time.monotonic() < deadline:
            time.sleep(0.01)
        stats = engine.stats
    finally:
        PA.paged_attention_plain = plain
        server.stop()
        engine.stop()
    served = all(r is not None and r[0] == 200 and r[1]["tokens"] == MAX_TOKENS
                 for r in results)
    leaked = ec.num_pages - 1 - stats["free_pages"] - stats["cached_pages"]
    steps = stats["decode_steps"] - before["decode_steps"]
    out = {"statuses": [r[0] if r else None for r in results],
           "tokens": [r[1]["tokens"] if r else None for r in results],
           "token_ids": [r[1]["token_ids"] if r else None for r in results],
           "prompt_bytes": [len(p) for p in prompts],
           "launches": launches, "launches_by_k": by_k, "plain_calls": plain_calls[0],
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
                 and plain_calls[0] == 0
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
              phase("prefix_cache", lambda: prefix_cache(params, cfg, dev))]

    def profile():
        with torch.inference_mode():
            return profile_decode(params, cfg, dev)

    phase("profile", profile)

    # the serving phases are done: free Llama-3-8B before training
    del params
    gc.collect()
    torch.cuda.empty_cache()

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
              # every served path: phase 5's two loops, speculative, prefix cache
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
