"""Training cells: BERT's MLM pretraining by the port's trainer
(``kubeflow_tpu_torch.train.trainer.Trainer`` over ``models/bert.py``).

Set-up builds one trainer (the model from the seed's weights, f32 masters,
bf16 compute, the flash kernel; AdamW as the configuration's ``trainer``
block states) and drives it through its first ``checked_steps`` steps by
the window's own call (``train_step(batch, sync=False)``) on the window's
own feed (the mix's batches, made on the card from the seed, every row of
those steps different), keeping each step's loss, each leaf's first
gradient as the optimizer got it (from its first moment after one step)
and each leaf's change over those steps.  The same trainer then runs
``warm_steps`` more, and the window: steps dispatched ahead until the
window's seconds have passed, closed by a synchronize.  With ``--trace 1``,
once the window has closed, the port's ``Capture`` brackets
``trace_steps`` more steps, so the window is as in a run without it.

Check: the plain reference trains from the same weights (made again from
the seed) on the same batches in float32, once the window has closed and
the trainer is freed.
"""

from __future__ import annotations

import gc
import os
import shutil
import tempfile
import time

import torch

from .. import check, weights
from ..generator import mlm_batches
from ..reference import bert as ref_bert
from ..reference.precision import fp8_matmul
from ..runtime import Context, Run, log

B1 = 0.9  # AdamW's first-moment decay: m after one step is (1 - b1) g


def published(flat: dict, layers: int) -> dict:
    """The tensors the check compares: BERT's parameters as it publishes
    them, one a layer, the fused query, key and value weights and biases
    apart (the port stacks the layers and fuses the three).  So a key's
    bias, whose gradient is nought under softmax, is a tensor of its own
    that the check's rule on the reference's gradient can leave out."""
    out = {}
    for n, t in flat.items():
        if not n.startswith("layers."):
            out[n] = t
            continue
        for i in range(layers):
            if n.endswith("attn_qkv_kernel"):
                parts = {f".{k}": t[i][:, j] for j, k in enumerate(("query", "key", "value"))}
            elif n.endswith("attn_qkv_bias"):
                parts = {f".{k}": t[i][j] for j, k in enumerate(("query", "key", "value"))}
            else:
                parts = {"": t[i]}
            for suffix, x in parts.items():
                out[f"{n}.{i}{suffix}"] = x
    return out


def norms(flat: dict, layers: int) -> dict:
    return {n: float(t.float().norm()) for n, t in published(flat, layers).items()}


def _trainer(ctx: Context, m: dict):
    from kubeflow_tpu_torch.models import bert
    from kubeflow_tpu_torch.train.trainer import Trainer, TrainerConfig

    bcfg = bert.BertConfig(vocab_size=m["vocab_size"], hidden_size=m["hidden_size"],
                           num_layers=m["num_hidden_layers"],
                           num_heads=m["num_attention_heads"],
                           intermediate_size=m["intermediate_size"],
                           max_position=m["max_position_embeddings"],
                           type_vocab_size=m["type_vocab_size"],
                           layer_norm_eps=m["layer_norm_eps"], attention="flash")
    P = ctx.traffic["max_predictions"]
    opt = ctx.config["trainer"]
    model = bert.BertMLM(weights.bert(m, ctx.seed, ctx.device))

    def loss_fn(model, b):
        return bert.mlm_loss(model, bcfg, b["input_ids"], b["labels"], b["attention_mask"],
                             max_predictions=P)

    tcfg = TrainerConfig(learning_rate=opt["learning_rate"], weight_decay=opt["weight_decay"],
                         warmup_steps=opt["warmup_steps"], total_steps=opt["total_steps"],
                         max_grad_norm=opt["max_grad_norm"])
    return Trainer(loss_fn, model, tcfg, device=ctx.device)


def _traced_steps(trainer, batches, start: int, n: int):
    """``n`` steps inside the port's capture, retried (up to three times)
    while a capture loses a device record.  Returns the capture, or None."""
    from kubeflow_tpu_torch.parallel.profiling import Capture

    for attempt in range(3):
        cap = Capture().start()
        for i in range(n):
            trainer.train_step(batches[(start + attempt * n + i) % len(batches)], sync=False)
        cap.stop()
        log(f"capture {attempt}: launch_calls {cap.launch_calls}, lost {cap.lost_records}")
        if not cap.lost_records:
            return cap
    return None


def run(ctx: Context) -> dict:
    mix, m = ctx.traffic, ctx.config
    n_checked = mix["checked_steps"]
    trainer = _trainer(ctx, m)
    batches = mlm_batches(mix, ctx.seed, m["vocab_size"], mix["pool"], ctx.device)
    L = m["num_hidden_layers"]
    init = {n: p.detach().clone() for n, p in trainer.params.items()}
    losses, grad1 = [], None
    for i in range(n_checked):
        losses.append(trainer.train_step(batches[i], sync=False)["loss"])
        if i == 0:
            b = float(torch.tensor(1 - B1))
            grad1 = {n: v / b for n, v in norms(trainer.opt_state["mu"], L).items()}
    prog = {"loss": [float(x) for x in losses], "grad1": grad1,
            "change": norms({n: p.detach() - init[n] for n, p in trainer.params.items()}, L)}
    del init
    step = n_checked
    for _ in range(mix["warm_steps"]):
        trainer.train_step(batches[step % len(batches)], sync=False)
        step += 1
    trainer.block_until_ready()
    t0 = time.perf_counter()
    setup_s = t0 - ctx.t_start
    t_end = t0 + ctx.seconds
    steps = 0
    while time.perf_counter() < t_end:
        trainer.train_step(batches[step % len(batches)], sync=False)
        steps, step = steps + 1, step + 1
    trainer.block_until_ready()
    t1 = time.perf_counter()
    peak_mem = torch.cuda.max_memory_allocated(ctx.device) if ctx.device.type == "cuda" else 0
    cap = _traced_steps(trainer, batches, step, mix["trace_steps"]) if ctx.trace else None
    checked = batches[:n_checked]
    del trainer, batches
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()

    run = Run(ctx=ctx, setup_s=setup_s, t0=t0, t1=t1, model=m, steps=steps,
              batch=mix["batch"], seq_len=mix["seq_len"], predictions=mix["max_predictions"])
    if cap is not None:
        from ..trace import TraceView

        tmp = tempfile.mkdtemp(prefix="portbench-trace-")
        try:
            cap.export(os.path.join(tmp, "trace.json"))
            run.trace = TraceView(os.path.join(tmp, "trace.json"))
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        del cap
    t = time.perf_counter()
    p0 = {f"{g}.{n}": v for g, leaves in weights.bert(m, ctx.seed, ctx.device).items()
          for n, v in leaves.items()}
    opt = ctx.config["trainer"]
    leaves = lambda ts: norms(ts, L)  # noqa: E731
    ref = ref_bert.steps(p0, m, checked, mix["max_predictions"], opt, norms=leaves)
    log(f"reference: {n_checked} steps, {time.perf_counter() - t:.1f} s; "
        f"losses program {prog['loss']} reference {ref['loss']}")
    limits = ctx.workload["limits"]
    checks = check.trained(prog, ref, limits)
    controls = {}
    if ctx.control:
        # fp8 in the program's place, and the fault of half the batch left
        # out (the mean over the rest), both against the float32 reference
        fp8 = ref_bert.steps(p0, m, checked, mix["max_predictions"], opt, mm=fp8_matmul,
                             norms=leaves)
        half = ref_bert.steps(p0, m, [{k: v[:len(v) // 2] for k, v in b.items()}
                                      for b in checked],
                              mix["max_predictions"], opt, norms=leaves)
        controls = {"fp8": check.trained(fp8, ref, limits),
                    "half_batch": check.trained(half, ref, limits)}
        for side, got in (("program", prog), ("fp8", fp8)):
            gaps = check.leaf_gaps(got["grad1"], ref["grad1"], sorted(ref["grad1"]))
            worst = sorted(gaps, key=gaps.get, reverse=True)[:3]
            log(f"{side}: first gradient's widest leaf gaps "
                + ", ".join(f"{n} {gaps[n]:.4g} (norm {ref['grad1'][n]:.3g})" for n in worst))
    return {"run": run, "checks": checks, "controls": controls, "attempted": steps, "failed": 0,
            "memory_peak_bytes": peak_mem, "trace_ok": not ctx.trace or run.trace is not None}
