"""Parallelism layer: mesh, shardings, distributed init, named presets
(DP/FSDP/TP/SP/CP/EP) consumed by job workloads."""

from .mesh import MeshConfig, build_mesh  # noqa: F401

_PRESETS = ("Preset", "get_preset", "preset_from_env")


def __getattr__(name):
    # the presets import the ops, and the ops import the mesh: loading them
    # on first use keeps ``import kubeflow_tpu_torch.ops`` free of a cycle
    if name in _PRESETS:
        from . import presets
        return getattr(presets, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
