"""Device resolution for the port's entry points.

Entry points (``model.init``, ``Engine``, ``JetStreamModel``) run on the
card unless the caller asks for the CPU: the default is ``"cuda"``, and a
CUDA request on a machine without a card raises instead of carrying on
silently on the CPU.
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: "str | torch.device | None" = None) -> torch.device:
    """``device`` (default ``"cuda"``) as a ``torch.device`` with its index
    filled in (so it compares equal to a tensor's ``.device``); raises
    RuntimeError for a CUDA device when no card is present."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but torch.cuda.is_available() "
                "is False; pass device='cpu' explicitly to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
