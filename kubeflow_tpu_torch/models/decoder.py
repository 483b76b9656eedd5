"""Trainable decoder LM family: Llama-3 / Gemma-class (BASELINE configs 3, 4).

Counterpart of ``kubeflow_tpu/models/decoder.py``.  The architecture (GQA +
RoPE + RMSNorm + SwiGLU or GeGLU) is the serving engine's: this module sits
over the port's ``serving/engine/model.py`` ``init`` and ``forward_full``, so
the weights trained here serve there unchanged.  ``forward_full`` was written
as the engine's oracle; nothing on its default path breaks autograd (no
in-place write into a saved tensor, no ``no_grad``, no int8 or LoRA branch
without int8 leaves or an adapter table).

``gemma_7b`` uses the Gemma-1 semantics: GeGLU, sqrt(d_model) input-embedding
scaling and a decoupled head_dim of 256.  ``SHARDING_RULES`` waits for
ROADMAP Queue 1 item 3.3.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch
import torch.nn.functional as F

from ..serving.engine.model import (DecoderConfig, forward_full, init,  # noqa: F401
                                    params_from_jax)


def gemma_7b() -> DecoderConfig:
    return DecoderConfig(
        vocab_size=256128, d_model=3072, n_layers=28, n_heads=16,
        n_kv_heads=16, d_ff=24576, rope_theta=10000.0,
        head_dim_override=256, act="gelu_tanh", scale_embed=True,
        norm_eps=1e-6,
    )


def tiny(vocab_size: int = 512) -> DecoderConfig:
    """Test-scale config (same family)."""
    return DecoderConfig(vocab_size=vocab_size, d_model=64, n_layers=2,
                         n_heads=4, n_kv_heads=2, d_ff=128)


def lm_loss(params: dict, config: DecoderConfig, tokens: torch.Tensor) -> torch.Tensor:
    """Next-token cross-entropy over [B, S] token ids (causal shift inside),
    on f32 logits (``optax.softmax_cross_entropy_with_integer_labels``)."""
    logits = forward_full(params, config, tokens[:, :-1])       # [B, S-1, V] f32
    targets = tokens[:, 1:].long()
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]), targets.reshape(-1))


def train_flops(config: DecoderConfig, batch: int, seq_len: int) -> float:
    """6·N·D matmul FLOPs (fwd+bwd) + attention term, for MFU accounting."""
    n = config.param_count() - config.vocab_size * config.d_model  # embed lookup is free
    # per token QK^T+PV over the ATTENTION width (n_heads*head_dim, not
    # d_model: gemma-7b decouples them, 4096 vs 3072)
    attn = config.n_layers * 2 * seq_len * config.n_heads * config.head_dim
    return 6 * batch * seq_len * (n + attn / 2)


def synthetic_lm_batches(vocab_size: int, batch_size: int, seq_len: int,
                         seed: int = 0) -> Iterator[dict]:
    """Markov-ish synthetic token stream (learnable: next = current + 0, 1
    or 2, mod vocab), drawn with numpy from ``seed``.  The JAX package draws
    with ``jax.random``: other numbers, the same law."""
    rng = np.random.default_rng(seed)
    while True:
        start = rng.integers(0, vocab_size, (batch_size, 1))
        steps = rng.integers(0, 3, (batch_size, seq_len - 1))
        toks = np.concatenate([start, np.cumsum(steps, axis=1) + start], axis=1) % vocab_size
        yield {"tokens": toks.astype(np.int32)}
