"""The controls' matrix products: the reference's own products computed in
a precision below the configuration's, the step that would tempt a later
change (fp8 for a bfloat16 model), as fp8 training computes them: the
operands in e4m3 going forward, the incoming gradient in e5m2 coming back,
each under one scale for the whole tensor, the sums in float32."""

from __future__ import annotations

import torch

E4M3, E5M2 = torch.float8_e4m3fn, torch.float8_e5m2


def fp8(t: torch.Tensor, fmt=E4M3) -> torch.Tensor:
    """``t`` rounded to ``fmt`` under one scale for the whole tensor (its
    largest magnitude to the format's largest), back in float32."""
    scale = t.abs().amax().clamp(min=1e-30) / torch.finfo(fmt).max
    return (t / scale).to(fmt).to(torch.float32) * scale


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        qa, qb = fp8(a), fp8(b)
        ctx.save_for_backward(qa, qb)
        ctx.shapes = a.shape, b.shape
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = fp8(g, E5M2)
        ga = (qg @ qb.transpose(-1, -2)).sum_to_size(ctx.shapes[0])
        gb = (qa.transpose(-1, -2) @ qg).sum_to_size(ctx.shapes[1])
        return ga, gb


def fp8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (broadcast as ``@`` does) with both operands in e4m3, and
    its gradients from the incoming gradient in e5m2."""
    return _Fp8Matmul.apply(a, b)
