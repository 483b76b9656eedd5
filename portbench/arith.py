"""The yardstick's arithmetic, frozen here so that no change to the program
moves it: the chip's peaks, the model FLOPs of a training step, and the
bytes and operations that bound one call of the flash attention kernel.

The formulas are copies of the program's as they stood when the benchmark
was defined (``BertConfig.train_flops``, the flash kernel's byte bound in
``chip_smoke.py``), so the benchmark's numbers agree with the program's own
accounts of that time.
"""

from __future__ import annotations

from typing import Optional

# Published dense peaks of one NVIDIA H100 SXM (NVIDIA's data sheet): bf16
# tensor-core operations and HBM3 bandwidth, at the full 700 W limit.
PEAKS = {
    "H100": {"bf16_flops": 989e12, "hbm_bytes_per_s": 3.35e12},
}


def peaks(device_kind: str) -> Optional[dict]:
    """The peaks of the card named ``device_kind`` (as
    ``torch.cuda.get_device_name`` gives it), or None for a card the table
    does not hold: then no share of a peak is reported."""
    if "H100" in device_kind and "PCIe" not in device_kind:
        return PEAKS["H100"]
    return None


def bert_train_flops(m: dict, batch: int, seq_len: int, predictions: int) -> float:
    """Forward and backward matmul FLOPs of one MLM step: the encoder's
    projections, attention's QK^T and PV, and the MLM head over
    ``predictions`` positions a row (6 FLOPs per weight and token)."""
    h, f, n, v = m["hidden_size"], m["intermediate_size"], m["num_hidden_layers"], m["vocab_size"]
    encoder = n * (4 * h * h + 2 * h * f) * seq_len
    attn = n * 2 * seq_len * seq_len * h
    head = (h * h + h * v) * predictions
    return 6 * batch * (encoder + attn + head)


def flash_call_bound_s(batch: int, heads: int, seq_q: int, seq_k: int, head_dim: int,
                       peak: dict, key_mask: bool = True) -> float:
    """The least time one non-causal flash forward over bf16 ``[batch *
    heads, seq, head_dim]`` inputs can take: q, k, v (and the f32 key mask)
    read once, the output (bf16) and the log-sum-exp (f32) written once;
    the QK^T and PV operations over every key."""
    bh = batch * heads
    nbytes = (2 * bh * seq_q * head_dim * 2 + 2 * bh * seq_k * head_dim * 2
              + bh * seq_q * 4 + (batch * seq_k * 4 if key_mask else 0))
    flops = 4 * head_dim * bh * seq_q * seq_k
    return max(nbytes / peak["hbm_bytes_per_s"], flops / peak["bf16_flops"])
