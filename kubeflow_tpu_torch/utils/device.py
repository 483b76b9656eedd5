"""Device resolution for the port's entry points.

Entry points (``model.init``, ``Engine``, ``JetStreamModel``) run on the
card unless the caller asks for the CPU: the default is ``"cuda"``, and a
CUDA request on a machine without a card raises instead of carrying on
silently on the CPU.

A pod's cards reach it as ``CUDA_VISIBLE_DEVICES`` (core/kubelet.py), one
entry per card it holds.  Two node cards may map onto one physical card
(``"0,0"``), a list the CUDA runtime refuses: ``cudaGetDeviceCount`` fails
with error 101 (invalid device ordinal) and torch sees no card.  So before
CUDA starts, ``resolve_device`` collapses a repeated list to its distinct
entries (``"0,0"`` -> ``"0"``), and ``pod_cards`` keeps reporting the list
as it was given.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

DEFAULT_DEVICE = "cuda"

# CUDA_VISIBLE_DEVICES as this process was given it, once a repeated list
# was collapsed for the CUDA runtime
_GIVEN_CARDS: Optional[list] = None


def _entries(raw: str) -> list:
    return [e.strip() for e in raw.split(",") if e.strip()]


def pod_cards() -> list:
    """The cards this process holds, one ``CUDA_VISIBLE_DEVICES`` entry
    each, as it was given them (a repeated entry counts each time); without
    the variable, ``torch.cuda.device_count()`` cards named by their
    ordinals."""
    if _GIVEN_CARDS is not None:
        return list(_GIVEN_CARDS)
    raw = os.environ.get("CUDA_VISIBLE_DEVICES")
    if raw is None:
        return [str(i) for i in range(torch.cuda.device_count())]
    return _entries(raw)


def _collapse_repeated_cards() -> None:
    """``CUDA_VISIBLE_DEVICES`` with each card once, for the CUDA runtime;
    a no-op once CUDA has started (it read the variable then)."""
    global _GIVEN_CARDS
    raw = os.environ.get("CUDA_VISIBLE_DEVICES")
    if raw is None or _GIVEN_CARDS is not None or torch.cuda.is_initialized():
        return
    entries = _entries(raw)
    distinct = list(dict.fromkeys(entries))
    if len(distinct) < len(entries):
        _GIVEN_CARDS = entries
        os.environ["CUDA_VISIBLE_DEVICES"] = ",".join(distinct)


def resolve_device(device: "str | torch.device | None" = None) -> torch.device:
    """``device`` (default ``"cuda"``) as a ``torch.device`` with its index
    filled in (so it compares equal to a tensor's ``.device``); raises
    RuntimeError for a CUDA device when no card is present."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda":
        _collapse_repeated_cards()
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but torch.cuda.is_available() "
                "is False; pass device='cpu' explicitly to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
