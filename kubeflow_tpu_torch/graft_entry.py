"""Entry points: a BERT-base forward step and the multi-device dry runs.

Counterpart of the JAX package's ``__graft_entry__.py``.  ``entry()``
returns a BERT-base forward step and its example arguments.
``dryrun_multichip(n)`` runs one FULL training step (forward, backward,
AdamW; data × fsdp × tensor shardings) of a tiny BERT on an n-shard mesh,
then ``_dryrun_composed``: one step of the MoE transformer composing
stages × seq × expert (× tensor) in one step.  Each prints its ``OK`` line
with the mesh's axis sizes and the loss.

The mesh is the port's single controller (``parallel/mesh.py``): the
default ``devices`` are n shards of the visible cards (round robin, so one
card takes every shard), and a machine without a card raises; the tests
pass ``["cpu"] * n``.

    python -m kubeflow_tpu_torch.graft_entry 16
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def entry(device=None):
    """(fn, example_args) — a BERT-base forward (MLM logits) on ``device``
    (default ``"cuda"``)."""
    from .models import bert
    from .utils.device import resolve_device

    dev = resolve_device(device)
    config = bert.BertConfig()  # BERT-base
    params = bert.init(config, dev, seed=0)
    ids = torch.zeros((8, 128), dtype=torch.int32, device=dev)
    mask = torch.ones((8, 128), dtype=torch.int32, device=dev)

    def fn(params, input_ids, attention_mask):
        return bert.forward(params, config, input_ids, attention_mask)

    return fn, (params, ids, mask)


def _mesh_factors(n: int) -> dict:
    """Factor n devices into data×fsdp×tensor (largest share to fsdp)."""
    tensor = 2 if n % 2 == 0 else 1
    rem = n // tensor
    data = 2 if rem % 2 == 0 and rem > 2 else 1
    fsdp = rem // data
    if data * fsdp * tensor != n:
        raise ValueError(f"{n} devices do not factor into data×fsdp×tensor")
    return {"data": data, "fsdp": fsdp, "tensor": tensor}


def _devices(n: int, devices: Optional[list]) -> list:
    """``devices``, or n shards of the visible cards (raises without one)."""
    if devices is not None:
        if len(devices) != n:
            raise ValueError(f"need {n} devices, have {len(devices)}")
        return list(devices)
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if not cards:
        raise RuntimeError("dryrun_multichip: no visible card; pass devices explicitly "
                           "(for example ['cpu'] * n) to run the dry run on the CPU")
    return [torch.device("cuda", i % cards) for i in range(n)]


def dryrun_multichip(n_devices: int, devices: Optional[list] = None) -> None:
    """One full sharded training step on an n-shard mesh (tiny shapes)."""
    from .models import bert
    from .parallel.mesh import MeshConfig, build_mesh
    from .train.data import synthetic_mlm_batches
    from .train.trainer import Trainer, TrainerConfig

    devices = _devices(n_devices, devices)
    f = _mesh_factors(n_devices)
    mesh = build_mesh(MeshConfig(data=f["data"], fsdp=f["fsdp"], tensor=f["tensor"]), devices)

    config = bert.BertConfig(
        vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
        intermediate_size=128, max_position=64,
    )
    model = bert.init(config, devices[0], seed=0)

    def loss_fn(p, batch):
        return bert.mlm_loss(p, config, batch["input_ids"], batch["labels"],
                             batch["attention_mask"])

    trainer = Trainer(loss_fn, model, TrainerConfig(learning_rate=1e-3, warmup_steps=1,
                                                    total_steps=4),
                      mesh=mesh, rules=bert.SHARDING_RULES)
    dp = f["data"] * f["fsdp"]  # batch must divide evenly over the dp extent
    batch_size = dp * max(2, 8 // dp + (8 % dp > 0))
    batch = next(synthetic_mlm_batches(config.vocab_size, batch_size, 16))
    metrics = trainer.train_step(batch)
    if not math.isfinite(metrics["loss"]):
        raise RuntimeError(f"dryrun_multichip: a non-finite loss {metrics}")
    print(f"dryrun_multichip OK: mesh={mesh.shape} loss={metrics['loss']:.4f}", flush=True)

    _dryrun_composed(n_devices, devices)


def _composed_mesh_factors(n: int) -> dict:
    """Every parallel axis >1 where the device count allows: stages, seq,
    expert, tensor, data each take a factor of 2 while one remains (16
    devices → stages×seq×expert×tensor all 2 — four non-trivial axes in ONE
    step); leftovers go to fsdp."""
    f = {"stages": 1, "seq": 1, "expert": 1, "tensor": 1, "data": 1, "fsdp": 1}
    rem = n
    for axis in ("stages", "seq", "expert", "tensor", "data"):
        if rem % 2 == 0 and rem >= 2:
            f[axis] = 2
            rem //= 2
    f["fsdp"] = rem
    return f


def _dryrun_composed(n_devices: int, devices: list) -> float:
    """FULL training step composing stages+seq+expert (+tensor, +fsdp) in
    one step: the MoE transformer with GPipe over `stages`, sequence-split
    activations over `seq`, the expert-split FFN over `expert`
    (``models/moe_transformer.py``), the port's AdamW (``trainer.adamw``).
    Returns the loss."""
    from .models import moe_transformer as mt
    from .parallel.mesh import MeshConfig, build_mesh
    from .train.trainer import Trainer, TrainerConfig, adamw

    f = _composed_mesh_factors(n_devices)
    mesh = build_mesh(MeshConfig(**f), devices)
    config = mt.MoeTransformerConfig(
        vocab_size=256, d_model=32, n_layers=4, n_heads=4, num_experts=2,
        top_k=1, capacity_factor=4.0,
        pipeline_stages=f["stages"], pipeline_microbatches=2,
    )
    trainer = Trainer(lambda p, b: mt.lm_loss(p, config, b["tokens"]),
                      mt.init(config, devices[0], seed=0), TrainerConfig(),
                      optimizer=adamw(1e-3), mesh=mesh, rules=mt.SHARDING_RULES)
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, config.vocab_size, (4, 17), generator=g, dtype=torch.int32)
    loss = trainer.train_step({"tokens": toks})["loss"]
    if not math.isfinite(loss):
        raise RuntimeError(f"dryrun_composed: a non-finite loss {loss}")
    print(
        f"dryrun_composed OK: mesh={mesh.shape} "
        f"(pp stages={config.pipeline_stages}, seq-parallel, expert-parallel) loss={loss:.4f}",
        flush=True)
    if n_devices < 16:
        # at 8 devices only 3 axes go >1: say what the 16-device run composes
        f16 = {k: v for k, v in _composed_mesh_factors(16).items() if v > 1}
        print(
            f"dryrun_composed note: at 16 devices the composition is {f16} "
            f"(4 non-trivial axes in one step) — validated by tests/"
            f"test_torch_graft_entry.py::test_dryrun_composed_16_shards_composes_four_axes",
            flush=True)
    return loss


if __name__ == "__main__":
    import sys

    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 8)
