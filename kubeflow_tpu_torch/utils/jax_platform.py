"""One call that resolves a worker's device.

Counterpart of ``kubeflow_tpu/utils/jax_platform.py``.  There, an image
may pin ``jax_platforms`` through ``jax.config`` in a sitecustomize at
interpreter start, masking the ``JAX_PLATFORMS`` variable, and every entry
point re-applies the variable before touching a device.  PyTorch has no
platform pin to undo: a device is chosen per tensor, never at interpreter
start, so nothing here has to win a race with a sitecustomize.  What is left
is the worker's device itself, read from ``TORCH_DEVICE``, the port's
counterpart of ``JAX_PLATFORMS``.
"""

from __future__ import annotations

import os

import torch

from .device import resolve_device


def honor_jax_platforms() -> torch.device:
    """The worker's device: ``TORCH_DEVICE`` (unset or empty: the card,
    ``"cuda"``, which raises without one; ``TORCH_DEVICE=cpu`` runs on the
    CPU)."""
    return resolve_device(os.environ.get("TORCH_DEVICE") or None)
