"""Build-on-first-use for the port's native code (C ABI via ctypes).

Two builders, both keyed on a hash of the source and the flags so an edit
never reuses a stale binary, and both racing safely between concurrent
builders through an atomic rename:

* ``build_native`` — g++ for host C++ cores (the serving engine's batcher,
  ``serving/engine/core.cc``, and the DDP shim's ring,
  ``transport/transport_core.cc``).
* ``build_cuda`` — nvcc for hand-written Hopper kernels
  (``serving/engine/csrc/*.cu``, ``ops/csrc/*.cu``), compiled for ``sm_90a`` into a shared
  library with a plain C interface.  No PyTorch headers are included, so a
  build takes seconds, and nothing needs ``ninja``.  ptxas runs verbose
  (``-Xptxas -v``): ``build_log`` returns a build's seconds and its
  per-kernel register, shared-memory and spill lines, kept beside the
  ``.so``.
* ``build_stress`` — the C++ core's sanitizer lane: ``core.cc`` with its
  concurrent stress driver ``serving/engine/stress_main.cc`` under
  ``-fsanitize=thread`` or ``address`` (the JAX package's ``stress-tsan``
  and ``stress-asan`` Makefile targets, with their ``STRESS_FLAGS``).

Every ``.so`` (and each stress binary) lands in ``kubeflow_tpu_torch/_build/``
(``BUILD_DIR``), which git ignores.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import shutil
import subprocess
import threading
import time

_LOCK = threading.Lock()
_KEY_LOCKS: dict[str, threading.Lock] = {}
_CACHE: dict[str, ctypes.CDLL] = {}

BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "_build")
CUDA_ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
# the sanitizer lane's flags, kept here alone (the JAX package keeps them in
# its engine Makefile)
STRESS_FLAGS = ["-O1", "-g", "-std=c++17", "-pthread"]
_ENGINE_DIR = os.path.join(os.path.dirname(BUILD_DIR), "serving", "engine")


def _tag(src_path: str, flags: list[str]) -> str:
    with open(src_path, "rb") as f:
        # flags are part of the key: a flag change must not silently reuse a
        # binary built without them
        return hashlib.md5(f.read() + repr(flags).encode()).hexdigest()[:10]


def _compile(cmd: list[str], tmp: str, so_path: str, src_path: str) -> str:
    t0 = time.perf_counter()
    try:
        r = subprocess.run(cmd, check=True, capture_output=True)
    except subprocess.CalledProcessError as e:
        raise RuntimeError(
            f"native build failed for {src_path}:\n{e.stderr.decode(errors='replace')}"
        ) from e
    with open(tmp + ".log", "w") as f:
        json.dump({"seconds": time.perf_counter() - t0,
                   "output": (r.stdout + r.stderr).decode(errors="replace")}, f)
    os.replace(tmp + ".log", so_path + ".log")
    os.replace(tmp, so_path)  # atomic under concurrent builders
    return so_path


def build_log(so_path: str) -> dict:
    """The build of ``so_path`` as it was compiled: ``seconds`` and the
    compiler's ``output`` (for a CUDA library, ptxas's lines per kernel:
    registers, shared memory, spill stores and loads).  Empty when the
    library was built before logs were kept."""
    try:
        with open(so_path + ".log") as f:
            return json.load(f)
    except OSError:
        return {}


def build_native(src_path: str, prefix: str, extra_flags: list[str] | None = None) -> str:
    """Compile ``src_path`` with g++ to ``_build/_<prefix>_<srchash>.so``."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    so_path = os.path.join(BUILD_DIR, f"_{prefix}_{_tag(src_path, extra_flags or [])}.so")
    if os.path.exists(so_path):
        return so_path
    tmp = so_path + f".tmp{os.getpid()}"
    cmd = ["g++", "-O2", "-fPIC", "-shared", "-std=c++17", "-Wall",
           *(extra_flags or []), src_path, "-o", tmp]
    return _compile(cmd, tmp, so_path, src_path)


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``/usr/local/cuda``,
    else ``nvcc`` on PATH.  Raises when there is none."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the Hopper kernels "
                           "are built from source on the machine with the card")
    return found


def build_cuda(src_path: str, prefix: str, extra_flags: list[str] | None = None) -> str:
    """Compile a ``.cu`` file for sm_90a into ``_build/_<prefix>_<hash>.so``.

    Raises RuntimeError carrying nvcc's stderr when the build fails."""
    # --split-compile=0: the optimizer and ptxas work on the source's
    # kernels in parallel, one thread per core
    flags = (CUDA_ARCH_FLAGS + ["-std=c++17", "-O3", "--split-compile=0", "-Xptxas", "-v"]
             + (extra_flags or []))
    os.makedirs(BUILD_DIR, exist_ok=True)
    so_path = os.path.join(BUILD_DIR, f"_{prefix}_{_tag(src_path, flags)}.so")
    if os.path.exists(so_path):
        return so_path
    tmp = so_path + f".tmp{os.getpid()}"
    # libraries (-l...) follow the source, as the linker reads them
    libs = [f for f in flags if f.startswith("-l")]
    cmd = [nvcc_path(), *[f for f in flags if not f.startswith("-l")], "-shared",
           "-Xcompiler", "-fPIC", src_path, "-o", tmp, *libs]
    return _compile(cmd, tmp, so_path, src_path)


def build_stress(sanitizer: str) -> str:
    """Compile the core and its stress driver under ``-fsanitize=<sanitizer>``
    (``thread`` or ``address``) into ``_build/stress_{tsan,asan}_<hash>``, an
    executable that prints ``stress OK`` when the race ends clean."""
    short = {"thread": "tsan", "address": "asan"}.get(sanitizer)
    if short is None:
        raise ValueError(f"sanitizer must be 'thread' or 'address', got {sanitizer!r}")
    srcs = [os.path.join(_ENGINE_DIR, n) for n in ("core.cc", "stress_main.cc")]
    flags = STRESS_FLAGS + [f"-fsanitize={sanitizer}"]
    digest = hashlib.md5(b"".join(_tag(p, flags).encode() for p in srcs)).hexdigest()[:10]
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = os.path.join(BUILD_DIR, f"stress_{short}_{digest}")
    if os.path.exists(out):
        return out
    tmp = out + f".tmp{os.getpid()}"
    return _compile(["g++", *flags, *srcs, "-o", tmp], tmp, out, srcs[1])


def _load(key: str, build) -> ctypes.CDLL:
    # one lock per source: two sources build at once, one source once
    with _LOCK:
        lock = _KEY_LOCKS.setdefault(key, threading.Lock())
    with lock:
        if key not in _CACHE:
            _CACHE[key] = ctypes.CDLL(build())
        return _CACHE[key]


def load_native(src_path: str, prefix: str, extra_flags: list[str] | None = None) -> ctypes.CDLL:
    """Build (if needed) and dlopen a host C++ core; one CDLL per source."""
    return _load(os.path.abspath(src_path),
                 lambda: build_native(src_path, prefix, extra_flags))


def load_cuda(src_path: str, prefix: str, extra_flags: list[str] | None = None) -> ctypes.CDLL:
    """Build (if needed) and dlopen a CUDA kernel library; one CDLL per source."""
    return _load(os.path.abspath(src_path),
                 lambda: build_cuda(src_path, prefix, extra_flags))
