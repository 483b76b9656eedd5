"""The plain references the benchmark holds the program's outputs against:
straightforward PyTorch in float32 with TF32 off, written from the models'
published descriptions, importing nothing of the program (``reference``
modules import only ``torch``, ``math`` and each other)."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def full_f32():
    """float32 matrix products as float32: TF32 off for the block, then the
    settings as they were."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])
