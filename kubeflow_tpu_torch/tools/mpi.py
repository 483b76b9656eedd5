"""Build-on-first-use for the vendored minimal ``mpirun`` (mpirun.cc).

The port's copy of ``kubeflow_tpu/tools/mpi.py``.  One thing differs: the
binary lands in ``kubeflow_tpu_torch/_build/mpi/mpirun`` (the build
directory git ignores, ``utils/native_build.BUILD_DIR``), not in a
``tools/bin`` beside the source.

The image ships no MPI runtime, so the MPIJob launcher-exec contract could
never run against a real binary.  This builds the vendored local mpirun
(hash-gated like the other native cores) so tests — and users without
OpenMPI — can put its directory on PATH.
"""

from __future__ import annotations

import hashlib
import os
import subprocess

from ..utils.native_build import BUILD_DIR

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "mpirun.cc")
_BIN_DIR = os.path.join(BUILD_DIR, "mpi")


def ensure_mpirun() -> str:
    """Compile mpirun.cc if its source changed; return the bin dir to put
    on PATH.  Concurrent builders race safely via atomic rename."""
    with open(_SRC, "rb") as f:
        tag = hashlib.md5(f.read()).hexdigest()[:10]
    exe = os.path.join(_BIN_DIR, "mpirun")
    stamp = os.path.join(_BIN_DIR, f".mpirun.{tag}")
    if not (os.path.exists(exe) and os.path.exists(stamp)):
        os.makedirs(_BIN_DIR, exist_ok=True)
        tmp = exe + f".tmp{os.getpid()}"
        subprocess.run(["g++", "-O2", "-std=c++17", "-Wall", _SRC, "-o", tmp],
                       check=True, capture_output=True)
        os.replace(tmp, exe)
        with open(stamp, "w"):
            pass
    return _BIN_DIR
