"""Training loop on one card: forward, backward and an optax-exact AdamW.

Counterpart of ``kubeflow_tpu/train/trainer.py``.  This slice trains on ONE
device: there is no mesh and there are no sharding rules.  Data, FSDP and
tensor parallelism on ``torch.distributed`` are ROADMAP Queue 1 item 3.3.
PyTorch runs eagerly, so there is no jit and no buffer donation; the trainer
updates the model's parameters and the optimizer state in place.

``default_optimizer`` reproduces the JAX package's optax chain
``clip_by_global_norm(max_grad_norm)`` then ``adamw(warmup_cosine_decay)``
exactly (see ``AdamW``), the bf16 at-rest moments of ``optimizer_dtype``
included.  XLA's ``compiled_cost_analysis`` has no counterpart and is left
out.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch
from torch import nn

from ..utils.device import resolve_device
from .data import to_device


@dataclass
class TrainerConfig:
    learning_rate: float = 1e-4
    weight_decay: float = 0.01
    warmup_steps: int = 100
    total_steps: int = 10_000
    max_grad_norm: float = 1.0
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 1000
    # "bfloat16" stores the Adam moments (m AND v) in bf16 at rest; the
    # update math still runs in f32.  bf16 shares f32's exponent range, so v
    # (squared grads) cannot overflow — the cost is 8 fewer mantissa bits.
    optimizer_dtype: Optional[str] = None


def warmup_cosine_decay(init_value: float, peak_value: float, warmup_steps: int,
                        decay_steps: int, end_value: float = 0.0) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule: a linear ramp from ``init_value``
    to ``peak_value`` over ``warmup_steps``, then a cosine decay to
    ``end_value`` at ``decay_steps``."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cosine_steps = decay_steps - warmup_steps
    if cosine_steps <= 0:
        raise ValueError("decay_steps must exceed warmup_steps")

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1 - min(max(count, 0), warmup_steps) / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        c = min(count - warmup_steps, cosine_steps)
        decay = 0.5 * (1 + math.cos(math.pi * c / cosine_steps))
        return peak_value * ((1 - alpha) * decay + alpha)

    return schedule


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm)."""
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


def _rounded(values: dict, dtype: torch.dtype) -> dict:
    """Python constants rounded to ``dtype``, as JAX applies a Python float
    to an array of that dtype (weakly typed: a bf16 array multiplies by the
    constant's bf16 value, so optax's b2 = 0.999 acts as 0.99609375)."""
    return {k: float(torch.tensor(v, dtype=dtype)) for k, v in values.items()}


class AdamW:
    """optax ``chain(clip_by_global_norm(max_norm), adamw(schedule,
    weight_decay=wd))`` with optax's defaults (b1 0.9, b2 0.999, eps 1e-8,
    eps_root 0):

    * clip: every gradient becomes ``g / ‖g‖ * max_norm`` when ``‖g‖ >=
      max_norm`` and stays as it is otherwise (no ``+1e-6`` as in torch's
      ``clip_grad_norm_``); ``max_norm = inf`` is no clip;
    * moments ``m = (1-b1) g + b1 m``, ``v = (1-b2) g² + b2 v``, bias
      corrected by ``1 - b**t`` at the incremented count t;
    * update ``-lr_c * (m̂ / (sqrt(v̂) + eps) + wd * p)`` on every leaf,
      biases and LayerNorm included, with the learning rate read at the
      count c BEFORE this update (so the first step of a warmup from 0
      moves nothing).

    Each operation runs in the gradient's dtype, one rounding per
    operation, with its constants rounded to that dtype (``_rounded``), as
    optax's tree maps do: f32 parameters get f32 arithmetic, and bf16
    parameters (the MNIST, ResNet and decoder configs) bf16 moments and
    bf16 arithmetic.  ``moment_dtype`` (bf16 beside f32 parameters) stores
    m and v at rest in that dtype; each update reads them back into the
    gradient's dtype and rounds them again after."""

    def __init__(self, schedule: Callable[[int], float], weight_decay: float,
                 max_grad_norm: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, moment_dtype: Optional[torch.dtype] = None):
        self.schedule = schedule
        self.weight_decay = weight_decay
        self.max_grad_norm = max_grad_norm
        self.b1, self.b2, self.eps = b1, b2, eps
        self.moment_dtype = moment_dtype

    def init(self, params: dict) -> dict:
        def zeros(p):
            return torch.zeros_like(p, dtype=self.moment_dtype or p.dtype)
        return {"count": 0,
                "mu": {n: zeros(p) for n, p in params.items()},
                "nu": {n: zeros(p) for n, p in params.items()}}

    @torch.no_grad()
    def update(self, grads: dict, state: dict, params: dict) -> torch.Tensor:
        """Apply one update to ``params`` and ``state`` in place; returns
        the global norm of ``grads`` before the clip."""
        gn = global_norm(grads.values())
        count = state["count"]
        t = count + 1
        b1, b2 = self.b1, self.b2
        consts = {"1-b1": 1 - b1, "b1": b1, "1-b2": 1 - b2, "b2": b2, "eps": self.eps,
                  "c1": 1 - b1 ** t, "c2": 1 - b2 ** t, "wd": self.weight_decay,
                  "-lr": -self.schedule(count)}
        by_dtype: dict = {}
        clip = gn < self.max_grad_norm
        for name, p in params.items():
            g = grads[name]
            k = by_dtype.get(g.dtype) or by_dtype.setdefault(g.dtype, _rounded(consts, g.dtype))
            if math.isfinite(self.max_grad_norm):
                g = torch.where(clip, g, g / gn.to(g.dtype) * self.max_grad_norm)
            mu = g.mul(k["1-b1"]).add_(state["mu"][name].to(g.dtype).mul(k["b1"]))
            nu = g.square().mul_(k["1-b2"]).add_(state["nu"][name].to(g.dtype).mul(k["b2"]))
            u = mu.div(k["c1"]).div_(nu.div(k["c2"]).sqrt_().add_(k["eps"]))
            if self.weight_decay:
                u.add_(p.to(g.dtype).mul(k["wd"]))
            p.add_(u.mul_(k["-lr"]))
            state["mu"][name].copy_(mu)
            state["nu"][name].copy_(nu)
        state["count"] = t
        return gn


def adam(learning_rate: float) -> AdamW:
    """``optax.adam(learning_rate)``: a constant rate, no clip, no decay."""
    return AdamW(lambda _: learning_rate, 0.0, math.inf)


def adamw(learning_rate: float, weight_decay: float = 1e-4) -> AdamW:
    """``optax.adamw(learning_rate)``: a constant rate, no clip, and optax's
    default decay 1e-4 (torch's ``AdamW`` defaults to 1e-2)."""
    return AdamW(lambda _: learning_rate, weight_decay, math.inf)


class SGD:
    """``optax.sgd(learning_rate, momentum)``: the trace ``t = g + momentum
    * t`` (kept in the parameters' dtype, as optax keeps it), then ``p +=
    -lr * t``, each operation in the gradient's dtype with its constants
    rounded to it, as ``AdamW`` does."""

    def __init__(self, learning_rate: float, momentum: Optional[float] = None):
        self.learning_rate = learning_rate
        self.momentum = momentum

    def init(self, params: dict) -> dict:
        if self.momentum is None:
            return {}
        return {"trace": {n: torch.zeros_like(p) for n, p in params.items()}}

    @torch.no_grad()
    def update(self, grads: dict, state: dict, params: dict) -> None:
        consts = {"m": self.momentum or 0.0, "-lr": -self.learning_rate}
        by_dtype: dict = {}
        for name, p in params.items():
            g = grads[name]
            k = by_dtype.get(g.dtype) or by_dtype.setdefault(g.dtype, _rounded(consts, g.dtype))
            if self.momentum is not None:
                g = g.add(state["trace"][name].mul(k["m"]))
                state["trace"][name].copy_(g)
            p.add_(g.mul(k["-lr"]))


def default_optimizer(cfg: TrainerConfig) -> AdamW:
    schedule = warmup_cosine_decay(
        0.0, cfg.learning_rate, cfg.warmup_steps, max(cfg.total_steps, cfg.warmup_steps + 1))
    moment_dtype = getattr(torch, cfg.optimizer_dtype) if cfg.optimizer_dtype else None
    return AdamW(schedule, cfg.weight_decay, cfg.max_grad_norm, moment_dtype=moment_dtype)


class Trainer:
    """Drives ``loss_fn(model, batch) -> scalar`` on one device.

    ``model`` is an ``nn.Module`` (``models.bert.BertMLM``); it is moved to
    ``device`` (default ``"cuda"``, which raises without a card) and its
    parameters are updated in place.  ``batch`` is a dict of numpy arrays or
    tensors."""

    def __init__(
        self,
        loss_fn: Callable[[Any, Any], torch.Tensor],
        model: nn.Module,
        config: Optional[TrainerConfig] = None,
        optimizer: Optional[AdamW] = None,
        flops_per_batch: Optional[float] = None,
        device=None,
    ):
        self.config = config or TrainerConfig()
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.loss_fn = loss_fn
        self.optimizer = optimizer or default_optimizer(self.config)
        self.flops_per_batch = flops_per_batch
        self.step_num = 0
        self._history: list[dict] = []
        self.params = dict(self.model.named_parameters())
        self.opt_state = self.optimizer.init(self.params)
        self._ckpt = None
        if self.config.checkpoint_dir:
            from .checkpoint import CheckpointManager

            self._ckpt = CheckpointManager(self.config.checkpoint_dir)

    # ---------------------------------------------------------------- train

    def put_batch(self, batch: Any) -> Any:
        return to_device(batch, self.device)

    def train_step(self, batch: Any, sync: bool = True) -> dict:
        """One optimizer step.

        ``sync=False`` keeps the metrics on the device (no host-device round
        trip), so the host can queue step N+1 while the card runs step N —
        time such a loop externally around a final ``block_until_ready()``.
        """
        t0 = time.perf_counter()
        batch = self.put_batch(batch)
        names = list(self.params)
        loss = self.loss_fn(self.model, batch)
        grads = dict(zip(names, torch.autograd.grad(loss, [self.params[n] for n in names])))
        gnorm = self.optimizer.update(grads, self.opt_state, self.params)
        metrics = {"loss": loss.detach(), "grad_norm": gnorm}
        if sync:
            metrics = {k: float(v) for k, v in metrics.items()}
            dt = time.perf_counter() - t0
            metrics["step_time_s"] = dt
            if self.flops_per_batch:
                metrics["tflops_per_s"] = self.flops_per_batch / dt / 1e12
            self._history.append(metrics)
        self.step_num += 1
        if self._ckpt and self.step_num % self.config.checkpoint_every == 0:
            self.save()
        return metrics

    def block_until_ready(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ----------------------------------------------------------- checkpoint

    def _state(self) -> dict:
        return {"params": self.model.state_dict(), "opt_state": self.opt_state}

    def save(self) -> None:
        if self._ckpt:
            self._ckpt.save(self.step_num, self._state())

    def finalize(self) -> None:
        """Flush an in-flight async checkpoint write — call before a clean
        process exit (a preemption kill skipping this is fine: resume falls
        back to the last whole step)."""
        if self._ckpt:
            self._ckpt.wait()

    def restore_latest(self) -> bool:
        """Resume from the newest checkpoint; returns True if one existed."""
        if not self._ckpt:
            return False
        restored = self._ckpt.restore_latest(self._state())
        if restored is None:
            return False
        with torch.no_grad():
            self.model.load_state_dict(restored["state"]["params"])
        self.opt_state = restored["state"]["opt_state"]
        self.step_num = restored["step"]
        return True

    # -------------------------------------------------------------- metrics

    def mfu(self, peak_flops_per_chip: float, n_chips: int = 1) -> Optional[float]:
        if not self.flops_per_batch or not self._history:
            return None
        times = [m["step_time_s"] for m in self._history[1:]] or [self._history[0]["step_time_s"]]
        achieved = self.flops_per_batch / (sum(times) / len(times))
        return achieved / (n_chips * peak_flops_per_chip)
