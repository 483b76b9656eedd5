"""Gemma fine-tune → eval → deploy pipeline (BASELINE.json config[4]).

Counterpart of ``kubeflow_tpu/examples/gemma_pipeline.py`` on the port's
pipeline SDK: the same three components with the same signatures and
defaults, the same pipeline name, description and condition, and the same
artifact layout, so the compiled IR differs from the reference's only in
each executor's embedded source.
  1. ``finetune`` trains a decoder of the Gemma family (models/decoder.py)
     with ``adamw(3e-3)`` and emits the weights as a Model artifact
     (``params.npz`` in f32 + ``config.json`` with the six size fields,
     exactly the layout the serving engine loads),
  2. ``evaluate`` computes held-out perplexity and gates deployment,
  3. ``deploy`` checks the model dir and returns its URI for the
     InferenceService path.

The component bodies import ``torch`` and the port inside the function: the
launcher exec's only the function's source, with the artifact types of
whichever package runs the step in scope, so a body uses nothing of its
artifacts but ``.path``, ``.uri``, ``.metadata`` and ``.log_metric``.  Each
step runs on ``TORCH_DEVICE`` (default the card; ``TORCH_DEVICE=cpu`` for
the CPU) and prints one line of timings on stdout.

The model is ``DecoderConfig`` built from the six size fields, as in the
JAX pipeline: head_dim is d_model / n_heads, SwiGLU, no embedding scale.
At Gemma-7B's widths that is head_dim 192, not ``decoder.gemma_7b()``'s
block (head_dim 256, GeGLU, scaled embeddings).
"""

from __future__ import annotations

from kubeflow_tpu_torch.pipelines import dsl


@dsl.component
def finetune(
    vocab_size: int, d_model: int, n_layers: int, n_heads: int, n_kv_heads: int,
    d_ff: int, steps: int, batch_size: int, seq_len: int,
    model: dsl.Output[dsl.Model], metrics: dsl.Output[dsl.Metrics],
) -> float:
    import json
    import os
    import time

    import numpy as np
    import torch

    from kubeflow_tpu_torch.models import decoder
    from kubeflow_tpu_torch.train.trainer import adamw
    from kubeflow_tpu_torch.utils.jax_platform import honor_jax_platforms

    device = honor_jax_platforms()
    config = decoder.DecoderConfig(vocab_size=vocab_size, d_model=d_model, n_layers=n_layers,
                                   n_heads=n_heads, n_kv_heads=n_kv_heads, d_ff=d_ff)
    params = decoder.init(config, device, seed=0)
    for p in params.values():
        p.requires_grad_()
    opt = adamw(3e-3)
    opt_state = opt.init(params)

    batches = decoder.synthetic_lm_batches(vocab_size, batch_size, seq_len)
    first = last = None
    step_s = []
    for _ in range(steps):
        t0 = time.perf_counter()
        tokens = torch.from_numpy(next(batches)["tokens"]).to(device)
        loss = decoder.lm_loss(params, config, tokens)
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        opt.update(grads, opt_state, params)
        del grads
        last = float(loss.detach())  # waits for the step
        first = first if first is not None else last
        step_s.append(time.perf_counter() - t0)

    t0 = time.perf_counter()
    os.makedirs(model.path, exist_ok=True)
    # npz has no bfloat16: persist f32, serving/eval casts back on load
    np.savez(os.path.join(model.path, "params.npz"),
             **{k: v.detach().float().cpu().numpy() for k, v in params.items()})
    # graftlint: disable=atomic-write -- demo scaffolding into a
    # directory this script just created; no concurrent reader
    with open(os.path.join(model.path, "config.json"), "w") as f:
        json.dump({"vocab_size": vocab_size, "d_model": d_model, "n_layers": n_layers,
                   "n_heads": n_heads, "n_kv_heads": n_kv_heads, "d_ff": d_ff}, f)
    savez_s = time.perf_counter() - t0
    metrics.log_metric("first_loss", first)
    metrics.log_metric("final_loss", last)
    model.metadata["family"] = "gemma"
    timed = step_s[1:] or step_s
    step_ms = sum(timed) / len(timed) * 1e3 if timed else 0.0
    print(f"FINETUNE device={device} steps={steps} step_ms={step_ms:.3f} "
          f"first_step_ms={step_s[0] * 1e3 if step_s else 0.0:.3f} "
          f"tokens_per_s={batch_size * seq_len / step_ms * 1e3 if step_ms else 0.0:.1f} "
          f"savez_s={savez_s:.6f}", flush=True)
    return last


@dsl.component
def evaluate(model: dsl.Input[dsl.Model], batch_size: int, seq_len: int,
             metrics: dsl.Output[dsl.Metrics]) -> float:
    import json
    import os
    import time

    import numpy as np
    import torch

    from kubeflow_tpu_torch.models import decoder
    from kubeflow_tpu_torch.utils.jax_platform import honor_jax_platforms

    device = honor_jax_platforms()
    t0 = time.perf_counter()
    with open(os.path.join(model.path, "config.json")) as f:
        config = decoder.DecoderConfig(**json.load(f))
    raw = np.load(os.path.join(model.path, "params.npz"))
    params = {k: torch.from_numpy(raw[k]).to(device, torch.bfloat16) for k in raw.files}
    load_s = time.perf_counter() - t0
    batch = next(decoder.synthetic_lm_batches(config.vocab_size, batch_size, seq_len, seed=99))
    with torch.no_grad():
        loss = float(decoder.lm_loss(params, config,
                                     torch.from_numpy(batch["tokens"]).to(device)))
    # exp in f32, as jnp.exp of the f32 loss
    ppl = float(np.exp(np.float32(min(loss, 20.0))))
    metrics.log_metric("eval_loss", loss)
    metrics.log_metric("perplexity", ppl)
    print(f"EVALUATE device={device} load_s={load_s:.6f} loss={loss:.6f}", flush=True)
    return ppl


@dsl.component
def deploy(model: dsl.Input[dsl.Model], service_name: str = "gemma") -> str:
    """Package the model dir for serving (the InferenceService storageUri)."""
    import os

    assert os.path.exists(os.path.join(model.path, "params.npz"))
    assert os.path.exists(os.path.join(model.path, "config.json"))
    # the artifact uri IS the deployable storage location (mstore://...)
    return model.uri


@dsl.pipeline(name="gemma-finetune-eval-deploy",
              description="BASELINE config[4]: fine-tune -> eval -> gated deploy")
def gemma_pipeline(
    vocab_size: int = 512, d_model: int = 64, n_layers: int = 2, n_heads: int = 4,
    n_kv_heads: int = 2, d_ff: int = 128, steps: int = 30, batch_size: int = 8,
    seq_len: int = 32, max_perplexity: float = 1000.0,
):
    ft = finetune(
        vocab_size=vocab_size, d_model=d_model, n_layers=n_layers, n_heads=n_heads,
        n_kv_heads=n_kv_heads, d_ff=d_ff, steps=steps, batch_size=batch_size,
        seq_len=seq_len,
    )
    ev = evaluate(model=ft.outputs["model"], batch_size=batch_size, seq_len=seq_len)
    with dsl.Condition(ev.output < max_perplexity):
        deploy(model=ft.outputs["model"])
