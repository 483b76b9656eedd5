"""BERT's masked-LM pretraining step, plain: the published encoder and MLM
head in float32, its loss, gradients and an AdamW step, with nothing
fused.

The encoder: the word, position and (segment 0) type embeddings summed,
LayerNorm; each layer self-attention over the row's real keys (padded keys
left out), scaled by ``head_dim^-1/2``, an output projection, residual and
LayerNorm, then a GELU feed-forward, residual and LayerNorm (post-norm).
The MLM head: a dense transform, GELU, LayerNorm, and the word embeddings
(tied) plus a bias, over the first ``max_predictions`` predicted positions
of each row; the loss is the mean cross entropy over the predicted tokens.
GELU is the tanh approximation, as the original release's ``modeling.py``
computes it.  There is no dropout: the port's model has none, and the
configuration lists the published dropouts as cut.  The optimizer is optax's ``clip_by_global_norm`` then ``adamw``
under a warmup-cosine schedule (b1 0.9, b2 0.999, eps 1e-8, the decay on
every leaf, the rate read before the count advances).
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from . import full_f32


def _ln(x, scale, bias, eps):
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


def _gelu(x):
    return F.gelu(x, approximate="tanh")


def loss(p: dict, m: dict, batch: dict, max_predictions: int,
         mm: Optional[Callable] = None) -> torch.Tensor:
    """The step's MLM loss.  ``p``: flat f32 leaves (``embeddings.word``,
    ``layers.attn_qkv_kernel``, ...); ``mm``: every matrix product, the
    projections' and attention's (a control passes a lower precision's)."""
    mm = mm or torch.matmul
    ids, labels, amask = batch["input_ids"], batch["labels"], batch["attention_mask"]
    h, L, nh = m["hidden_size"], m["num_hidden_layers"], m["num_attention_heads"]
    hd, eps = h // nh, m["layer_norm_eps"]
    B, S = ids.shape
    x = (p["embeddings.word"][ids] + p["embeddings.position"][None, :S]
         + p["embeddings.type"][0])
    x = _ln(x, p["embeddings.ln_scale"], p["embeddings.ln_bias"], eps)
    keep = amask.bool()[:, None, None, :]  # [B, 1, 1, T]
    for i in range(L):
        qkv = (mm(x, p["layers.attn_qkv_kernel"][i].reshape(h, 3 * h))
               + p["layers.attn_qkv_bias"][i].reshape(3 * h)).view(B, S, 3, nh, hd)
        q, k, v = (qkv[:, :, j].transpose(1, 2) for j in range(3))  # [B, nh, S, hd]
        s = (mm(q, k.transpose(-1, -2)) / math.sqrt(hd)).masked_fill(~keep, float("-inf"))
        att = mm(torch.softmax(s, -1), v).transpose(1, 2).reshape(B, S, h)
        att = mm(att, p["layers.attn_out_kernel"][i].reshape(h, h)) + p["layers.attn_out_bias"][i]
        x = _ln(x + att, p["layers.ln1_scale"][i], p["layers.ln1_bias"][i], eps)
        f = _gelu(mm(x, p["layers.mlp_in_kernel"][i]) + p["layers.mlp_in_bias"][i])
        f = mm(f, p["layers.mlp_out_kernel"][i]) + p["layers.mlp_out_bias"][i]
        x = _ln(x + f, p["layers.ln2_scale"][i], p["layers.ln2_bias"][i], eps)
    valid = labels != -100
    weight, idx = torch.sort(valid.int(), dim=1, descending=True, stable=True)
    weight, idx = weight[:, :max_predictions].bool(), idx[:, :max_predictions]
    x = torch.take_along_dim(x, idx[..., None], dim=1)
    tgt = torch.take_along_dim(labels, idx, dim=1).clamp(min=0)
    t = _gelu(mm(x, p["mlm.transform_kernel"]) + p["mlm.transform_bias"])
    t = _ln(t, p["mlm.ln_scale"], p["mlm.ln_bias"], eps)
    logits = mm(t, p["embeddings.word"].t()) + p["mlm.output_bias"]
    nll = -torch.log_softmax(logits, -1).gather(-1, tgt[..., None])[..., 0]
    return (nll * weight).sum() / weight.sum().clamp(min=1)


def schedule(opt: dict, count: int) -> float:
    """optax.warmup_cosine_decay_schedule(0, lr, warmup, total) at ``count``."""
    lr, warm, total = opt["learning_rate"], opt["warmup_steps"], opt["total_steps"]
    if count < warm:
        return lr * count / warm
    c = min(count - warm, total - warm)
    return lr * 0.5 * (1 + math.cos(math.pi * c / (total - warm)))


def _leaf_norms(tensors: dict) -> dict:
    return {n: float(t.norm()) for n, t in tensors.items()}


def steps(p0: dict, m: dict, batches: list, max_predictions: int, opt: dict,
          mm: Optional[Callable] = None, norms: Callable = _leaf_norms) -> dict:
    """Train from ``p0`` (flat f32 leaves, left as they are) over
    ``batches``; return each step's ``loss``, the first gradient as the
    optimizer gets it (clipped) as ``grad1`` norms, and the change over all
    the steps as ``change`` norms.  ``norms`` maps ``{leaf: tensor}`` to the
    norms compared (by default one a leaf)."""
    b1, b2, eps, wd = 0.9, 0.999, 1e-8, opt["weight_decay"]
    with full_f32():
        p = {n: t.detach().clone().requires_grad_(True) for n, t in p0.items()}
        mu = {n: torch.zeros_like(t) for n, t in p.items()}
        nu = {n: torch.zeros_like(t) for n, t in p.items()}
        losses, grad1 = [], None
        for count, batch in enumerate(batches):
            lv = loss(p, m, batch, max_predictions, mm)
            grads = dict(zip(p, torch.autograd.grad(lv, list(p.values()))))
            losses.append(float(lv.detach()))
            with torch.no_grad():
                gn = torch.sqrt(sum(g.square().sum() for g in grads.values()))
                if gn >= opt["max_grad_norm"]:
                    grads = {n: g / gn * opt["max_grad_norm"] for n, g in grads.items()}
                if grad1 is None:
                    grad1 = norms(grads)
                t = count + 1
                lr = schedule(opt, count)
                for n, g in grads.items():
                    mu[n] = (1 - b1) * g + b1 * mu[n]
                    nu[n] = (1 - b2) * g * g + b2 * nu[n]
                    u = (mu[n] / (1 - b1 ** t)) / ((nu[n] / (1 - b2 ** t)).sqrt() + eps)
                    p[n] -= lr * (u + wd * p[n])
        with torch.no_grad():
            change = norms({n: p[n] - p0[n] for n in p})
    return {"loss": losses, "grad1": grad1, "change": change}
