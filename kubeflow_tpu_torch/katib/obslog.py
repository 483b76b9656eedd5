"""Python client for the C++ observation-log store core (obslog_core.cc).

A copy of ``kubeflow_tpu/katib/obslog.py``
(the port imports nothing of the JAX package).

Upstream analogue (UNVERIFIED, SURVEY.md §2a "Katib: db-manager + UI" row):
the ``ReportObservationLog`` / ``GetObservationLog`` gRPC surface of Katib's
db-manager.  Intermediate metric time series live here — NOT on Trial status
and NOT in pod logs — so they survive pod GC and back both medianstop early
stopping and the UI data endpoints (service.py) without re-parsing logs.
"""

from __future__ import annotations

import ctypes
import os
import struct
import threading
from typing import Optional

from ..utils.native_build import load_native

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "obslog_core.cc")
_LIB = None
_BIND_LOCK = threading.Lock()


def _load() -> ctypes.CDLL:
    global _LIB
    with _BIND_LOCK:
        if _LIB is None:
            lib = load_native(_SRC, "obslog")
            i32, i64, p, c, d = (ctypes.c_int32, ctypes.c_int64, ctypes.c_void_p,
                                 ctypes.c_char_p, ctypes.c_double)
            lib.obs_open.restype = p
            lib.obs_open.argtypes = [c]
            lib.obs_close.argtypes = [p]
            lib.obs_report.restype = i32
            lib.obs_report.argtypes = [p, c, c, i64, d]
            lib.obs_count.restype = i64
            lib.obs_count.argtypes = [p, c, c]
            lib.obs_get_log.restype = i64
            lib.obs_get_log.argtypes = [p, c, c, i64]
            lib.obs_latest.restype = i32
            lib.obs_latest.argtypes = [p, c, c, ctypes.POINTER(d)]
            lib.obs_trials.restype = i64
            lib.obs_trials.argtypes = [p]
            lib.obs_metrics.restype = i64
            lib.obs_metrics.argtypes = [p, c]
            lib.obs_read_buffer.restype = i64
            lib.obs_read_buffer.argtypes = [p, ctypes.c_char_p, i64]
            _LIB = lib
    return _LIB


class ObservationStore:
    """Per-(trial, metric) time series with WAL durability."""

    def __init__(self, path: Optional[str] = None):
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self.lib = _load()
        self._h = self.lib.obs_open(path.encode() if path else None)
        if not self._h:
            raise OSError(f"cannot open observation WAL at {path!r}")
        self._lock = threading.Lock()  # query + read_buffer must pair

    def close(self) -> None:
        if self._h:
            self.lib.obs_close(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover - defensive
        try:
            self.close()
        except Exception:
            pass

    def _read(self, n: int) -> bytes:
        buf = ctypes.create_string_buffer(int(n))
        got = self.lib.obs_read_buffer(self._h, buf, n)
        return buf.raw[:got]

    # ------------------------------------------------------------- writes

    def report(self, trial: str, metric: str, value: float, step: Optional[int] = None) -> int:
        """Append one observation; step defaults to the series index."""
        with self._lock:
            if step is None:
                step = self.lib.obs_count(self._h, trial.encode(), metric.encode())
            self.lib.obs_report(self._h, trial.encode(), metric.encode(), int(step), float(value))
            return int(step)

    # -------------------------------------------------------------- reads

    def count(self, trial: str, metric: str) -> int:
        with self._lock:
            return int(self.lib.obs_count(self._h, trial.encode(), metric.encode()))

    def get_log(self, trial: str, metric: str, start: int = 0) -> list[tuple[int, float]]:
        """The series from index ``start``: [(step, value), ...]."""
        with self._lock:
            n = self.lib.obs_get_log(self._h, trial.encode(), metric.encode(), int(start))
            raw = self._read(n)
        out = []
        for off in range(0, len(raw), 16):
            step, value = struct.unpack_from("<qd", raw, off)
            out.append((step, value))
        return out

    def latest(self, trial: str, metric: str) -> Optional[float]:
        out = ctypes.c_double()
        with self._lock:
            rc = self.lib.obs_latest(self._h, trial.encode(), metric.encode(), ctypes.byref(out))
        return out.value if rc else None

    def trials(self) -> list[str]:
        with self._lock:
            n = self.lib.obs_trials(self._h)
            raw = self._read(n)
        return [t for t in raw.decode().split("\n") if t]

    def metrics(self, trial: str) -> list[str]:
        with self._lock:
            n = self.lib.obs_metrics(self._h, trial.encode())
            raw = self._read(n)
        return [m for m in raw.decode().split("\n") if m]

    def observation(self, trial: str, metric_names) -> dict:
        """Trial ``.status.observation`` built from the stored series."""
        metrics = []
        for name in metric_names:
            series = [v for _, v in self.get_log(trial, name)]
            if series:
                metrics.append({"name": name, "latest": series[-1],
                                "min": min(series), "max": max(series)})
        return {"metrics": metrics}
