"""Random weights made from the run's seed on the device, one large call a
leaf, in the type they are trained in.  Both the program and the plain
reference get their weights from here (each makes its own copy), so the
reference takes nothing the program made.

The layout is the port's (``models/bert.py``'s groups, the layers stacked
``[L, ...]``), and the scales its ``init``'s: N(0, 0.02^2) for BERT's dense
weights (its ``initializer_range``), ones for norm scales, zeros for
biases.
"""

from __future__ import annotations

import torch

from .generator import subseed


def bert(m: dict, seed: int, device) -> dict:
    """BERT's MLM tree in f32 (``m``: the published config's keys)."""
    g = torch.Generator(device=device)
    g.manual_seed(subseed(seed, "bert_weights"))
    h, f, L = m["hidden_size"], m["intermediate_size"], m["num_hidden_layers"]
    nh = m["num_attention_heads"]
    hd = h // nh
    std = m["initializer_range"]

    def dense(*shape):
        return torch.randn(shape, generator=g, device=device, dtype=torch.float32).mul_(std)

    def ones(*shape):
        return torch.ones(shape, device=device)

    def zeros(*shape):
        return torch.zeros(shape, device=device)

    return {
        "embeddings": {
            "word": dense(m["vocab_size"], h),
            "position": dense(m["max_position_embeddings"], h),
            "type": dense(m["type_vocab_size"], h),
            "ln_scale": ones(h),
            "ln_bias": zeros(h),
        },
        "layers": {
            "attn_qkv_kernel": dense(L, h, 3, nh, hd),
            "attn_qkv_bias": zeros(L, 3, nh, hd),
            "attn_out_kernel": dense(L, nh, hd, h),
            "attn_out_bias": zeros(L, h),
            "ln1_scale": ones(L, h),
            "ln1_bias": zeros(L, h),
            "mlp_in_kernel": dense(L, h, f),
            "mlp_in_bias": zeros(L, f),
            "mlp_out_kernel": dense(L, f, h),
            "mlp_out_bias": zeros(L, h),
            "ln2_scale": ones(L, h),
            "ln2_bias": zeros(L, h),
        },
        "mlm": {
            "transform_kernel": dense(h, h),
            "transform_bias": zeros(h),
            "ln_scale": ones(h),
            "ln_bias": zeros(h),
            "output_bias": zeros(m["vocab_size"]),
        },
    }
