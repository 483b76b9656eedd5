"""The frozen arithmetic against hand counts."""

from __future__ import annotations

import pytest

from portbench import arith, spec

H100 = arith.peaks("NVIDIA H100 80GB HBM3")


def test_peaks():
    assert H100 == {"bf16_flops": 989e12, "hbm_bytes_per_s": 3.35e12}
    assert arith.peaks("cpu") is None


def test_bert_train_flops_is_the_recorded_count():
    m = spec.config("bert-base-uncased")
    assert arith.bert_train_flops(m, 32, 512, 80) == pytest.approx(9.646241e12, rel=1e-7)
    # phase 1 runs the same tokens a step, less attention and fewer predictions
    assert arith.bert_train_flops(m, 128, 128, 20) == pytest.approx(8.95e12, rel=2e-3)


def test_flash_bound_at_bert_base():
    t = arith.flash_call_bound_s(32, 12, 512, 512, 64, H100)
    assert t * 1e3 == pytest.approx(0.0303, abs=5e-5)
