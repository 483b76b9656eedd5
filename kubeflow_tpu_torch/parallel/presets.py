"""Named parallelism presets: the TPUJob/JAXJob-facing surface.

Counterpart of ``kubeflow_tpu/parallel/presets.py``.  A preset maps a
strategy name (what a job spec or the ``TPU_PARALLELISM_PRESET`` env var
carries) to a concrete MeshConfig and the attention implementation that
rides it, so a workload picks DP/FSDP/TP/SP/CP/EP without hand-rolling mesh
math.

    preset = get_preset("ring-cp", n_devices=4)
    mesh = build_mesh(preset.mesh, ["cuda:0"] * 4)
    out = preset.attention(q, k, v, mesh, causal=True)

The ``pp`` preset's mesh carries a model whose ``pipeline_stages`` match
its ``stages`` (the GPipe schedule, ``parallel/pipeline.py``).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable

from ..ops.attention import multihead_attention
from ..ops.flash_attention import flash_attention
from ..ops.ring_attention import ring_attention
from ..ops.ulysses import ulysses_attention
from .mesh import MeshConfig

ENV_PRESET = "TPU_PARALLELISM_PRESET"


@dataclasses.dataclass(frozen=True)
class Preset:
    name: str
    mesh: MeshConfig
    #: attention(q, k, v, mesh, causal=...) for sharded presets;
    #: attention(q, k, v, causal=...) for single-axis presets (mesh unused)
    attention: Callable
    description: str = ""


def _dense(q, k, v, mesh=None, causal=True):
    return multihead_attention(q, k, v, causal=causal)


def _flash(q, k, v, mesh=None, causal=True):
    return flash_attention(q, k, v, causal=causal)


def get_preset(name: str, n_devices: int, tensor: int = 1, stages: int = 1) -> Preset:
    """Resolve a strategy name to a preset sized for n_devices."""
    if name in ("dp", "data"):
        return Preset(name, MeshConfig(data=n_devices, fsdp=1), _flash,
                      "pure data parallel (gradients psum over `data`)")
    if name == "fsdp":
        return Preset(name, MeshConfig(fsdp=n_devices), _flash,
                      "ZeRO-3-style sharded data parallel")
    if name in ("tp", "tensor"):
        t = tensor if tensor > 1 else 2  # tp means tensor>1; default 2
        if tensor == 1 and n_devices % 2:
            raise ValueError(f"tp preset needs an even device count, got {n_devices}")
        if n_devices % t:
            raise ValueError(f"tensor={t} does not divide {n_devices} devices")
        return Preset(name, MeshConfig(fsdp=n_devices // t, tensor=t),
                      _flash, "Megatron-style tensor parallel innermost, fsdp outer")
    if name in ("ring-cp", "ring", "cp"):
        return Preset(
            name, MeshConfig(fsdp=1, seq=n_devices),
            lambda q, k, v, mesh, causal=True: ring_attention(q, k, v, mesh, causal=causal),
            "ring attention: KV rotates the ring; S scales with devices",
        )
    if name in ("ulysses", "sp"):
        return Preset(
            name, MeshConfig(fsdp=1, seq=n_devices),
            lambda q, k, v, mesh, causal=True: ulysses_attention(q, k, v, mesh, causal=causal),
            "Ulysses: head all-to-all, full-length attention per device",
        )
    if name in ("moe-ep", "ep", "expert"):
        return Preset(name, MeshConfig(fsdp=1, expert=n_devices), _flash,
                      "expert parallel: MoE FFN dispatched over `expert`")
    if name in ("pp", "pipeline"):
        s = stages if stages > 1 else 2
        if n_devices % s:
            raise ValueError(f"stages={s} does not divide {n_devices} devices")
        return Preset(name, MeshConfig(stages=s, fsdp=n_devices // s), _dense,
                      "GPipe pipeline over `stages` (parallel/pipeline.py), fsdp within")
    raise ValueError(
        f"unknown parallelism preset {name!r}; "
        "available: dp, fsdp, tp, pp, ring-cp, ulysses, moe-ep"
    )


ENV_TENSOR = "TPU_TENSOR_PARALLEL"


def preset_from_env(n_devices: int, default: str = "fsdp") -> Preset:
    """What a job worker calls: the controller sets TPU_PARALLELISM_PRESET
    (and optionally TPU_TENSOR_PARALLEL for the tp preset's axis size)."""
    return get_preset(
        os.environ.get(ENV_PRESET, default),
        n_devices,
        tensor=int(os.environ.get(ENV_TENSOR, "1")),
    )
