"""TPUJob/JAXJob BERT training worker with first-class auto-resume.

Counterpart of ``kubeflow_tpu/examples/bert_worker.py``, with the same
environment surface and the same stdout lines.  It builds a (tiny-by-default)
BERT MLM ``Trainer`` and, when the controller injected ``CHECKPOINT_DIR``,
resumes from the newest checkpoint before training, so a gang restart
continues from step N instead of step 0.  Prints Katib-style ``key=value``
metrics to stdout.

``FAIL_AT_STEP``/``FAIL_MARKER`` simulate a mid-run preemption (exit 137,
retryable under the ExitCode restart policy) exactly once; ``FAIL_RANK``
limits it to one process of a gang (read against ``RANK``, else
``JAX_PROCESS_ID``, the index the controller injects).  A member whose gang
lost a process exits with ``GANG_LOST_EXIT`` (143, retryable), so the
controller restarts the whole gang.

The device is ``TORCH_DEVICE`` (default ``"cuda"``: the card, raising
without one; ``TORCH_DEVICE=cpu`` runs on the CPU), the port's counterpart
of the ``JAX_PLATFORMS`` the JAX worker reads.  As the JAX worker does, it
trains on an ``fsdp`` mesh over the job's global devices with
``bert.SHARDING_RULES``: ``LOCAL_DEVICES`` (default 1) shards per process,
sharing the process's device, so a gang of P processes trains on P x
``LOCAL_DEVICES`` shards; every member draws the same global batches and
keeps its own rows, and process 0 writes the checkpoints.

    python -m kubeflow_tpu_torch.examples.bert_worker
"""

from __future__ import annotations

import os
import sys


def main() -> None:
    from kubeflow_tpu_torch.parallel.distributed import GANG_LOST_EXIT, GangMemberLost

    try:
        _main()
    except GangMemberLost as e:
        print(f"gang member lost: {e}", file=sys.stderr, flush=True)
        os._exit(GANG_LOST_EXIT)


def _main() -> None:
    from kubeflow_tpu_torch.models import bert
    from kubeflow_tpu_torch.parallel.distributed import GangMemberLost, devices, initialize
    from kubeflow_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    from kubeflow_tpu_torch.train.data import synthetic_mlm_batches
    from kubeflow_tpu_torch.train.trainer import Trainer, TrainerConfig
    from kubeflow_tpu_torch.utils.device import resolve_device

    device = resolve_device(os.environ.get("TORCH_DEVICE") or None)
    shards = int(os.environ.get("LOCAL_DEVICES", "1"))
    penv = initialize(local_device_count=shards, device=device)
    config = bert.BertConfig(
        vocab_size=int(os.environ.get("VOCAB_SIZE", "512")),
        hidden_size=int(os.environ.get("HIDDEN_SIZE", "64")),
        num_layers=int(os.environ.get("NUM_LAYERS", "2")),
        num_heads=int(os.environ.get("NUM_HEADS", "4")),
        intermediate_size=int(os.environ.get("INTERMEDIATE_SIZE", "128")),
        max_position=64,
    )
    steps = int(os.environ.get("TRAIN_STEPS", "20"))
    batch_size = int(os.environ.get("BATCH_SIZE", "8"))
    devs = devices() if penv.is_distributed else [device] * shards
    mesh = build_mesh(MeshConfig(fsdp=len(devs)), devs)
    model = bert.init(config, device, seed=0)

    def loss_fn(m, b):
        return bert.mlm_loss(m, config, b["input_ids"], b["labels"], b["attention_mask"])

    trainer = Trainer(
        loss_fn, model,
        TrainerConfig(
            learning_rate=1e-3, warmup_steps=2, total_steps=steps + 2,
            checkpoint_dir=os.environ.get("CHECKPOINT_DIR") or None,
            checkpoint_every=int(os.environ.get("CHECKPOINT_EVERY", "1000")),
        ),
        mesh=mesh, rules=bert.SHARDING_RULES,
    )
    # auto-resume: the platform contract for restarted gangs
    resumed = trainer.restore_latest()
    print(f"resumed_from={trainer.step_num}" if resumed else "resumed_from=0", flush=True)

    fail_at = int(os.environ.get("FAIL_AT_STEP", "-1"))
    marker = os.environ.get("FAIL_MARKER", "")
    fail_rank = int(os.environ.get("FAIL_RANK", "-1"))
    rank = int(os.environ.get("RANK", os.environ.get("JAX_PROCESS_ID", "0")))
    if fail_rank >= 0 and rank != fail_rank:
        fail_at = -1
    data = synthetic_mlm_batches(config.vocab_size, batch_size, seq_len=32)
    try:
        _train(trainer, data, steps, fail_at, marker)
    except GangMemberLost:
        trainer.finalize()  # the writer's checkpoint in flight is made whole first
        raise
    trainer.save()
    trainer.block_until_ready()
    trainer.finalize()
    print(f"TRAIN-DONE step={trainer.step_num}", flush=True)


def _train(trainer, data, steps: int, fail_at: int, marker: str) -> None:
    while trainer.step_num < steps:
        metrics = trainer.train_step(next(data))
        print(f"step={trainer.step_num} loss={metrics['loss']:.4f}", flush=True)
        if trainer.step_num == fail_at and marker and not os.path.exists(marker):
            open(marker, "w").close()
            # simulated preemption: retryable under ExitCode.  The async
            # save of an earlier step may still be writing; joining it first
            # makes the step the rerun resumes from deterministic
            trainer.finalize()
            os._exit(137)


if __name__ == "__main__":
    main()
