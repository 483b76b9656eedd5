"""Shared helpers of the benchmark's own tests (run on the CPU with
``python -m pytest portbench/tests``; the tests marked ``cuda`` need the
card and skip without it)."""

from __future__ import annotations

import copy
import os
import sys
import time

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from portbench import spec  # noqa: E402
from portbench.runtime import Context  # noqa: E402


def tiny_cell(name: str) -> dict:
    """The cell ``name`` at a size the CPU holds: its own drivers, readers,
    limits and mix, with every width and length cut down."""
    c = spec.cell(name)
    readers = c.pop("readers")
    c = copy.deepcopy(c)
    c["readers"] = readers
    cfg, mix = c["config"], c["traffic"]
    cfg.update(vocab_size=1200, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
               num_attention_heads=4, max_position_embeddings=64)
    mix.update(batch=4, seq_len=32, max_predictions=6, token_ids=[999, 1200], pool=6,
               trace_steps=3)
    return c


def tiny_ctx(cell: dict, seed: int = 2**31 + 7, seconds: float = 1.5, trace: bool = False,
             control: bool = False) -> Context:
    import torch

    return Context(cell=cell, seed=seed, seconds=seconds, trace=trace,
                   device=torch.device("cpu"), t_start=time.perf_counter(), control=control)


@pytest.fixture
def card():
    """Skips a test unless a CUDA card is present (decided when the test
    runs, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the port's kernels have no CPU mode)")
    return torch.device("cuda", 0)
