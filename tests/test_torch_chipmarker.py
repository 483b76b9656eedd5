"""Port parity: the sha-bound chip-validation markers
(``kubeflow_tpu_torch/utils/chipmarker.py``).

A marker written by either package reads valid in the other for the same
source; an edited source voids it in both; a torn or missing marker reads
invalid; ``extra`` fields ride along.  The port's writer is
``chip_smoke.py``, one marker per CUDA source after that kernel's parity
phase, into the git-ignored ``_build/``."""

from __future__ import annotations

import json
import os

import pytest

from kubeflow_tpu.utils import chipmarker as ref
from kubeflow_tpu_torch.utils import chipmarker as port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = [os.path.join(REPO, "kubeflow_tpu_torch", "serving", "engine", "csrc",
                        "paged_attention.cu"),
           os.path.join(REPO, "kubeflow_tpu_torch", "ops", "csrc", "flash_attention.cu")]


@pytest.mark.parametrize("writer,reader", [(port, ref), (ref, port), (port, port)],
                         ids=["port-to-ref", "ref-to-port", "port-to-port"])
def test_marker_reads_valid_across_packages_and_an_edit_voids_it(tmp_path, writer, reader):
    src = tmp_path / "kernel.cu"
    src.write_text("__global__ void k() {}\n")
    marker = str(tmp_path / "kernel.validated.json")
    writer.write_marker(marker, str(src), extra={"card": "H100", "max_abs_err": 0.0})
    assert reader.marker_valid(marker, str(src))
    rec = json.load(open(marker))
    assert rec["card"] == "H100" and rec["kernel_sha"] == reader.source_sha(str(src))
    assert not os.path.exists(marker + ".tmp")  # tmp + os.replace
    src.write_text("__global__ void k() { /* edited */ }\n")
    assert not reader.marker_valid(marker, str(src))
    assert not writer.marker_valid(marker, str(src))


def test_torn_or_missing_marker_is_invalid(tmp_path):
    src = tmp_path / "kernel.cu"
    src.write_text("x")
    marker = tmp_path / "m.json"
    assert not port.marker_valid(str(marker), str(src))
    marker.write_text('{"kernel_sha": ')
    assert not port.marker_valid(str(marker), str(src))
    assert not port.marker_valid(str(marker), str(tmp_path / "gone.cu"))


@pytest.mark.parametrize("src", SOURCES, ids=["paged", "flash"])
def test_source_sha_is_the_reference_sha_for_the_port_kernels(src):
    assert port.source_sha(src) == ref.source_sha(src)
    assert len(port.source_sha(src)) == 64
