"""Chip-validation markers, sha-bound to the kernel source they vouch for.

Counterpart of ``kubeflow_tpu/utils/chipmarker.py``.  A marker written after
an on-card validation pass carries ``kernel_sha`` = sha256(kernel source at
validation time), and is TRUSTED only while the source still hashes to that
value — an edited kernel voids the validation instead of riding it.  The
format is the JAX package's, so a marker written by either package reads
valid in the other.  Writer: ``chip_smoke.py``, one marker per CUDA source
(``paged_attention.cu`` after its parity phase, ``flash_attention.cu`` after
its own) into ``kubeflow_tpu_torch/_build/``.  The port's engine keeps its
paged kernel on by default and reads no marker.
"""

from __future__ import annotations

import hashlib
import json
import os
import time


def source_sha(src_path: str) -> str:
    with open(src_path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def write_marker(marker_path: str, src_path: str, extra: dict | None = None) -> None:
    rec = {"validated_at": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
           "kernel_sha": source_sha(src_path)}
    if extra:
        rec.update(extra)
    # tmp+os.replace: marker_valid() reads this back across runs — a torn
    # marker silently re-queues chip validation (graftlint atomic-write)
    with open(marker_path + ".tmp", "w") as f:
        json.dump(rec, f, indent=1)
    os.replace(marker_path + ".tmp", marker_path)


def marker_valid(marker_path: str, src_path: str) -> bool:
    """Marker present AND its kernel_sha matches the current source."""
    try:
        with open(marker_path) as f:
            marker = json.load(f)
        return marker.get("kernel_sha") == source_sha(src_path)
    except (OSError, ValueError):
        return False
