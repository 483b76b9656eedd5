"""The port's C++ core under sanitizers: ``serving/engine/core.cc`` (a byte
copy of the JAX package's) with its concurrent stress driver
``stress_main.cc``, built by ``utils.native_build.build_stress`` with the
reference Makefile's ``STRESS_FLAGS`` under TSAN and ASAN into ``_build/``.

Submitter threads race the decode thread across the core's whole C API for
2000 requests each; any sanitizer report fails the test even if the binary
exits 0.  Slow lane, like ``tests/test_engine.py``'s sanitizer test (each
build and run takes tens of seconds on a CPU)."""

from __future__ import annotations

import os
import subprocess

import pytest

from kubeflow_tpu_torch.utils import native_build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENGINE = os.path.join(REPO, "kubeflow_tpu_torch", "serving", "engine")
REF_ENGINE = os.path.join(REPO, "kubeflow_tpu", "serving", "engine")


def test_stress_sources_are_the_reference_bytes():
    """The lane races the port's own core, byte-identical to the reference's
    today, with the reference's driver byte for byte."""
    ref = REF_ENGINE
    for name in ("core.cc", "stress_main.cc"):
        with open(os.path.join(ENGINE, name), "rb") as a, \
                open(os.path.join(ref, name), "rb") as b:
            assert a.read() == b.read(), name
    mk = open(os.path.join(ref, "Makefile")).read()
    flags = next(ln for ln in mk.splitlines() if ln.startswith("STRESS_FLAGS"))
    assert flags.split(":=")[1].split() == native_build.STRESS_FLAGS


def test_build_stress_refuses_an_unknown_sanitizer():
    with pytest.raises(ValueError, match="thread' or 'address"):
        native_build.build_stress("memory")


@pytest.mark.slow
@pytest.mark.parametrize("sanitizer", ["thread", "address"])
def test_core_concurrent_stress_under_sanitizers(sanitizer):
    binary = native_build.build_stress(sanitizer)
    assert os.path.dirname(binary) == native_build.BUILD_DIR
    env = dict(os.environ)
    env["TSAN_OPTIONS"] = "halt_on_error=1"
    env["ASAN_OPTIONS"] = "detect_leaks=1"
    run = subprocess.run([binary], capture_output=True, text=True, timeout=400, env=env)
    report = run.stdout + run.stderr
    assert run.returncode == 0, report[-3000:]
    assert "stress OK" in run.stdout
    assert "WARNING: ThreadSanitizer" not in report
    assert "ERROR: AddressSanitizer" not in report and "LeakSanitizer" not in report
