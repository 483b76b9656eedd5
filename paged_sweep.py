"""Sweep the paged decode kernel's pages per split on the card.

At every shape that phase 3 of ``chip_smoke.py`` measures (Llama-3-8B's
32/8 heads over a bf16 and an int8 pool at K 1 and 5, its 16/4 and 8/2
tensor-parallel shards, the Gemma-7B width's 16/16 heads at head_dim 192),
one ``paged_attention`` call is timed at every pages-per-split value the
kernel takes: device ms per kernel in a profiler window and CUDA-event ms,
as ``chip_smoke.py`` times them (same inputs, lengths and L2 flush).  Where
the kernel library reports it (``paged_attention_occupancy``), each point
also carries the blocks one SM holds and the clusters the card holds at
once.  One JSON line a shape, then all of them in ``--out``.  With
``--full`` every slot is at the table's full length (2048 tokens), so no
chunk lies past its slot's horizon.  ``--ptxas`` also compiles the
kernel source to a cubin with ``-Xptxas -v`` and reports each kernel's
registers, and each point the dynamic shared memory of its blocks, so
the blocks an SM holds can be worked out where the library cannot report
them.  ``--pps`` sweeps only the pages-per-split values given.

    python3 paged_sweep.py [--root DIR] [--full] [--ptxas] [--pps N ...] [--out PATH]

``--root`` runs another checkout's package and ``chip_smoke.py`` instead of
this one's (an older commit's tree unpacked there), so two versions of the
kernel are compared within one run on the same card.  Needs one card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

# (kv quantisation, K, (Hq, Hkv), head_dim): phase 3's shapes
SHAPES = [(quant, K, (32, 8), 128) for quant in (None, "int8") for K in (1, 5)] + \
         [(None, K, heads, 128) for heads in ((16, 4), (8, 2)) for K in (1, 5)] + \
         [(None, K, (16, 16), 192) for K in (1, 5)]
PAGES_PER_SPLIT = (1, 2, 4, 8, 16, 32, 64)


def ptxas_registers(src: str) -> dict:
    """Registers of each kernel in the CUDA source ``src``, compiled for
    sm_90a as the package builds it, from ``ptxas -v``."""
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    with tempfile.TemporaryDirectory() as tmp:
        r = subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                            "-cubin", "-Xptxas", "-v", src, "-o", os.path.join(tmp, "k.cubin")],
                           capture_output=True, text=True, check=True)
    out, name = {}, None
    for line in (r.stdout + r.stderr).splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name] = int(m.group(1))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(__file__)),
                    help="the checkout whose package and chip_smoke.py run")
    ap.add_argument("--full", action="store_true",
                    help="every slot at the table's full length instead of phase 3's lengths")
    ap.add_argument("--ptxas", action="store_true",
                    help="also report each kernel's registers and each point's shared memory")
    ap.add_argument("--pps", type=int, nargs="*", default=PAGES_PER_SPLIT,
                    help="the pages-per-split values to sweep")
    ap.add_argument("--out", default=None, help="write every shape's sweep here as JSON")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("paged_sweep: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as CS

    PA, M = CS.PA, CS.M
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    lib = PA.load_kernel()
    occupancy = getattr(lib, "paged_attention_occupancy", None)
    max_splits = getattr(PA, "MAX_SPLITS", None)
    seq_lens = [CS.MAX_PAGES * CS.PS] * CS.B if args.full else CS.SEQ_LENS
    lens = torch.tensor(seq_lens, dtype=torch.int32, device=dev)
    table = torch.from_numpy(
        rng.integers(1, CS.POOL_PAGES, (CS.B, CS.MAX_PAGES)).astype(np.int32)).to(dev)

    out, registers = [], None
    if args.ptxas:
        src = os.path.join(os.path.abspath(args.root), "kubeflow_tpu_torch", "serving", "engine",
                           "csrc", "paged_attention.cu")
        registers = ptxas_registers(src)
        print(json.dumps({"ptxas": registers}), flush=True)
    for quant, K, (hq, hkv), hd in SHAPES:
        q = torch.from_numpy(rng.standard_normal((CS.B, K, hq, hd), dtype=np.float32)).to(
            dev, torch.bfloat16)

        def pool():
            x = torch.from_numpy(rng.standard_normal((CS.POOL_PAGES, hkv, CS.PS, hd),
                                                     dtype=np.float32)).to(dev, torch.bfloat16)
            if quant is None:
                return x
            qv, s = M._quantize_kv(x)
            return {"q": qv, "s": s}

        call_args = (q, pool(), pool(), table, lens, CS.PS)
        rows = K * hq // hkv
        rec = {"pool": quant or "bf16", "K": K, "heads": [hq, hkv], "hd": hd,
               "plan": PA._split_plan(CS.MAX_PAGES, CS.B, hkv, rows), "sweep": {}}
        for pps in args.pps:
            splits = -(-CS.MAX_PAGES // pps)
            if max_splits is not None and splits > max_splits:
                continue

            def call(pps=pps):
                return PA.paged_attention(*call_args, _pages_per_split=pps)

            point = {"splits": splits,
                     "device_ms": CS.profiled_ms(call, flush, CS.PAGED_MARKERS),
                     "kernel_ms": CS.time_ms(call, flush)}
            if args.ptxas:
                # (q_dtype, kv_dtype, rows, hd, ps, pps[, splits]): the
                # cluster kernel's fold depends on the splits as well
                smem_args = [1, 2 if quant else 1, rows, hd, CS.PS, pps]
                point["smem_bytes"] = lib.paged_attention_smem_bytes(
                    *smem_args, *([splits] if max_splits is not None else []))
            if occupancy is not None:
                occ = (ctypes.c_int * 2)()
                err = occupancy(1, 2 if quant else 1, CS.B, K, hq, hkv, hd, CS.PS,
                                CS.MAX_PAGES, pps, occ)
                point.update(blocks_per_sm=occ[0] if err == 0 else None,
                             active_clusters=occ[1] if err == 0 else None,
                             occupancy_error=err)
            rec["sweep"][pps] = point
        print(json.dumps(rec), flush=True)
        out.append(rec)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"root": os.path.abspath(args.root), "device": torch.cuda.get_device_name(0),
                       "seq_lens": seq_lens, "ptxas": registers, "shapes": out}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
