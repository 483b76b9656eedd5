"""Metrics collection from trial logs.

A copy of ``kubeflow_tpu/katib/metrics.py``
(the port imports nothing of the JAX package).

Upstream analogue (UNVERIFIED, SURVEY.md §2a "Katib: metrics collectors"):
a sidecar injected by webhook tails stdout/TFEvent files and pushes
observation logs to the db-manager.  Architectural deviation (documented):
the simulator's trial controller PULLS pod logs from the kubelet at reconcile
time instead of running a push sidecar — same parse rules, same observation
schema on Trial status.

StdOut format (katib default): lines containing ``metric=value`` pairs, e.g.
``epoch 3: accuracy=0.91 loss=0.32`` or ``{"accuracy": 0.91}`` JSON lines.
"""

from __future__ import annotations

import json
import re
from typing import Iterable

_PAIR = r"(?P<name>[A-Za-z][\w\-./]*)\s*=\s*(?P<value>[-+]?\d+(?:\.\d+)?(?:[eE][-+]?\d+)?)"


def parse_metrics(log: str, metric_names: Iterable[str]) -> dict[str, list[float]]:
    """Extract all observations of each metric, in log order."""
    wanted = set(metric_names)
    out: dict[str, list[float]] = {m: [] for m in wanted}
    for line in log.splitlines():
        line = line.strip()
        if line.startswith("{"):
            try:
                d = json.loads(line)
                for k, v in d.items():
                    if k in wanted and isinstance(v, (int, float)):
                        out[k].append(float(v))
                continue
            except (json.JSONDecodeError, TypeError):
                pass
        for m in re.finditer(_PAIR, line):
            name = m.group("name")
            if name in wanted:
                out[name].append(float(m.group("value")))
    return out


def observation(log: str, metric_names: Iterable[str]) -> dict:
    """Trial .status.observation from a log blob."""
    parsed = parse_metrics(log, metric_names)
    metrics = []
    for name, values in parsed.items():
        if values:
            metrics.append(
                {"name": name, "latest": values[-1], "min": min(values), "max": max(values)}
            )
    return {"metrics": metrics}


# ----------------------------------------------------------------- TFEvent
#
# Upstream analogue (UNVERIFIED, SURVEY.md §2a metrics-collectors row): the
# ``tfevent-metricscollector`` sidecar parses TensorBoard event files.  The
# rebuild reads the TFRecord/Event wire format directly (no TensorFlow
# import — a multi-second dependency for two proto fields) and ships a
# writer so TPU workloads can emit collector-readable scalars.
#
# TFRecord framing: u64 len | u32 masked_crc(len) | data | u32 masked_crc.
# Event proto: field 2 = step (varint), field 5 = Summary; Summary field 1 =
# repeated Value; Value field 1 = tag, field 2 = simple_value (fixed32).

import glob
import os
import struct


def _crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), table-driven — TFRecord's checksum."""
    global _CRC_TABLE
    if _CRC_TABLE is None:
        table = []
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
            table.append(c)
        _CRC_TABLE = table
    crc = 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ _CRC_TABLE[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


_CRC_TABLE = None


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return ((crc >> 15 | crc << 17) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(buf: bytes, off: int) -> tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[off]
        off += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, off
        shift += 7


def _proto_fields(buf: bytes):
    """Yield (field_number, wire_type, value) triples of one message."""
    off = 0
    while off < len(buf):
        key, off = _varint(buf, off)
        field, wire = key >> 3, key & 7
        if wire == 0:  # varint
            value, off = _varint(buf, off)
        elif wire == 1:  # fixed64
            value = buf[off:off + 8]
            off += 8
        elif wire == 2:  # length-delimited
            n, off = _varint(buf, off)
            value = buf[off:off + n]
            off += n
        elif wire == 5:  # fixed32
            value = buf[off:off + 4]
            off += 4
        else:  # groups (3/4): not emitted by TF writers
            return
        yield field, wire, value


def _parse_event(data: bytes) -> tuple[int, dict[str, float]]:
    """One Event proto → (step, {tag: scalar})."""
    step = 0
    scalars: dict[str, float] = {}
    for field, wire, value in _proto_fields(data):
        if field == 2 and wire == 0:
            step = value
        elif field == 5 and wire == 2:  # Summary
            for f2, w2, v2 in _proto_fields(value):
                if f2 == 1 and w2 == 2:  # Summary.Value
                    tag, simple = None, None
                    for f3, w3, v3 in _proto_fields(v2):
                        if f3 == 1 and w3 == 2:
                            tag = v3.decode("utf-8", "replace")
                        elif f3 == 2 and w3 == 5:
                            simple = struct.unpack("<f", v3)[0]
                        elif f3 == 8 and w3 == 2:  # TensorProto (TF2 scalars)
                            for f4, w4, v4 in _proto_fields(v3):
                                if f4 == 5 and w4 == 2 and len(v4) >= 4:  # packed float_val
                                    simple = struct.unpack("<f", v4[:4])[0]
                                elif f4 == 5 and w4 == 5:
                                    simple = struct.unpack("<f", v4)[0]
                                elif f4 == 4 and w4 == 2 and len(v4) == 4:  # tensor_content
                                    simple = struct.unpack("<f", v4)[0]
                    if tag is not None and simple is not None:
                        scalars[tag] = simple
    return step, scalars


def parse_tfevent_file(path: str, metric_names: Iterable[str]) -> dict[str, list[tuple[int, float]]]:
    """Event file → {metric: [(step, value), ...]} in record order."""
    wanted = set(metric_names)
    out: dict[str, list[tuple[int, float]]] = {m: [] for m in wanted}
    with open(path, "rb") as f:
        buf = f.read()
    off = 0
    while off + 12 <= len(buf):
        (n,) = struct.unpack_from("<Q", buf, off)
        off += 12  # len + len-crc (not validated on read)
        data = buf[off:off + n]
        if len(data) < n:
            break  # truncated tail (crash mid-write): drop
        off += n + 4  # data + data-crc
        step, scalars = _parse_event(data)
        for tag, value in scalars.items():
            if tag in wanted:
                out[tag].append((step, value))
    return out


def parse_tfevent_dir(path: str, metric_names: Iterable[str]) -> dict[str, list[tuple[int, float]]]:
    """All ``events.out.tfevents.*`` files under ``path`` (sorted), merged."""
    merged: dict[str, list[tuple[int, float]]] = {m: [] for m in metric_names}
    if not path or not os.path.isdir(path):
        return merged
    for f in sorted(glob.glob(os.path.join(path, "events.out.tfevents.*"))):
        for metric, series in parse_tfevent_file(f, metric_names).items():
            merged[metric].extend(series)
    return merged


class TFEventWriter:
    """Minimal TensorBoard-compatible scalar writer for TPU workloads.

    Writes real TFRecord framing (masked CRC-32C) with Event protos carrying
    ``simple_value`` summaries, so both this collector and actual TensorBoard
    can read the output.
    """

    def __init__(self, logdir: str, suffix: str = "0"):
        os.makedirs(logdir, exist_ok=True)
        self.path = os.path.join(logdir, f"events.out.tfevents.{suffix}")
        self._f = open(self.path, "ab")

    @staticmethod
    def _encode_varint(v: int) -> bytes:
        out = bytearray()
        while True:
            b = v & 0x7F
            v >>= 7
            out.append(b | (0x80 if v else 0))
            if not v:
                return bytes(out)

    def scalar(self, tag: str, value: float, step: int) -> None:
        enc = self._encode_varint
        tag_b = tag.encode()
        val = (b"\x0a" + enc(len(tag_b)) + tag_b           # Value.tag (field 1)
               + b"\x15" + struct.pack("<f", value))       # Value.simple_value (field 2)
        summary = b"\x0a" + enc(len(val)) + val            # Summary.value (field 1)
        event = (b"\x10" + enc(step)                       # Event.step (field 2)
                 + b"\x2a" + enc(len(summary)) + summary)  # Event.summary (field 5)
        header = struct.pack("<Q", len(event))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(event)
        self._f.write(struct.pack("<I", _masked_crc(event)))
        self._f.flush()

    def close(self) -> None:
        self._f.close()
