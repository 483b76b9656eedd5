"""Training loop: forward, backward and an optax-exact AdamW, on one device
or on a mesh.

Counterpart of ``kubeflow_tpu/train/trainer.py``.  PyTorch runs eagerly, so
there is no jit and no buffer donation; the trainer updates the parameters
and the optimizer state in place.

``mesh=None`` trains the model on one device.  With a mesh
(``parallel/mesh.py``) and the model's sharding rules, the parameters and
the AdamW moments are placed by the rules as ``ShardedTensor``s (each
moment in its parameter's layout), the batch
by ``batch_spec``, and the loss, its backward and the update run on each
shard's slice with the mesh current, as the JAX package's one jitted step
runs on its mesh.  Where one slice lives on several devices the replicas'
gradients are summed; the global gradient norm counts each slice once.
One controller drives every shard (the mesh's devices may repeat: N shards
of one card); the cross-process mesh is ROADMAP Queue 1 item 3.3.

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

from ..parallel.mesh import Mesh
from ..parallel.sharding import ShardedTensor, shard_params
from ..utils.device import resolve_device
from .data import global_batch, to_device


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
    def update(self, grads: dict, state: dict, params: dict,
               grad_norm: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Apply one update to ``params`` and ``state`` in place; returns
        the global norm of ``grads`` before the clip (``grad_norm`` when the
        caller computed it: a mesh's norm counts each slice once)."""
        gn = global_norm(grads.values()) if grad_norm is None else grad_norm
        count = state["count"]
        t = count + 1
        b1, b2 = self.b1, self.b2
        consts = {"1-b1": 1 - b1, "b1": b1, "1-b2": 1 - b2, "b2": b2, "eps": self.eps,
                  "c1": 1 - b1 ** t, "c2": 1 - b2 ** t, "wd": self.weight_decay,
                  "-lr": -self.schedule(count)}
        by_dtype: dict = {}
        # the norm and its clip test on each device the leaves live on
        norms: dict = {}
        for name, p in params.items():
            g = grads[name]
            k = by_dtype.get(g.dtype) or by_dtype.setdefault(g.dtype, _rounded(consts, g.dtype))
            if math.isfinite(self.max_grad_norm):
                if g.device not in norms:
                    gd = gn.to(g.device)
                    norms[g.device] = (gd, gd < self.max_grad_norm)
                gd, clip = norms[g.device]
                g = torch.where(clip, g, g / gd.to(g.dtype) * self.max_grad_norm)
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
    """Drives ``loss_fn(model, batch) -> scalar`` on one device or a mesh.

    ``model`` is an ``nn.Module`` (``models.bert.BertMLM``).  Without a
    mesh it is moved to ``device`` (default ``"cuda"``, which raises without
    a card) and its parameters are updated in place.  With ``mesh`` and
    ``rules`` (the model's path rules, e.g. ``bert.SHARDING_RULES``) its
    parameters are copied onto the mesh as ``ShardedTensor``s: ``params``
    maps each ``state_dict`` name to one, ``tree`` nests them as the model
    does, and ``loss_fn`` receives ``tree`` under ``with mesh:`` (``model``
    is left as it was; ``model`` is None on the trainer).  ``batch`` is a
    dict of numpy arrays or tensors, split over the batch on a mesh."""

    def __init__(
        self,
        loss_fn: Callable[[Any, Any], torch.Tensor],
        model: nn.Module,
        config: Optional[TrainerConfig] = None,
        optimizer: Optional[AdamW] = None,
        flops_per_batch: Optional[float] = None,
        device=None,
        mesh: Optional[Mesh] = None,
        rules=None,
    ):
        self.config = config or TrainerConfig()
        self.loss_fn = loss_fn
        self.optimizer = optimizer or default_optimizer(self.config)
        self.flops_per_batch = flops_per_batch
        self.step_num = 0
        self._history: list[dict] = []
        self.mesh = mesh
        if mesh is None:
            self.device = resolve_device(device)
            self.model = model.to(self.device)
            self.params = dict(self.model.named_parameters())
            self.opt_state = self.optimizer.init(self.params)
        else:
            if rules is None:
                raise ValueError("Trainer on a mesh needs the model's sharding rules")
            self.rules = tuple(rules)
            self.device = mesh.device(0)
            self.model = None
            self.tree = shard_params(model, mesh, self.rules)
            self.params = _flatten(self.tree)
            for st in self.params.values():
                for t in st.locals:
                    t.requires_grad_(True)
            self._replicas = {n: _replica_groups(st) for n, st in self.params.items()}
            self.opt_state = self._init_sharded_state()
        self._ckpt = None
        if self.config.checkpoint_dir:
            from .checkpoint import CheckpointManager

            self._ckpt = CheckpointManager(self.config.checkpoint_dir)

    # ------------------------------------------------------- mesh placement

    def _local_params(self) -> dict:
        """Every distinct local slice, keyed ``(name, j)``."""
        return {(n, j): t for n, st in self.params.items() for j, t in enumerate(st.locals)}

    def _init_sharded_state(self) -> dict:
        """The optimizer's state over the local slices, each per-parameter
        entry regrouped into ShardedTensors laid out as its parameter.  The
        update is elementwise beside the parameter, so a moment keeps its
        parameter's layout; where the rules resolve ``<entry>/<param path>``
        otherwise (a rule anchored at ``^``, as the MoE transformer's are),
        XLA would reshard it to that layout, here it stays beside its
        parameter."""
        flat = self.optimizer.init(self._local_params())
        state: dict = {}
        for key, value in flat.items():
            if not isinstance(value, dict):
                state[key] = value  # the step count: a replicated scalar
                continue
            state[key] = {}
            for name, st in self.params.items():
                locals_ = {id(t): value[(name, j)] for j, t in enumerate(st.locals)}
                state[key][name] = st.like([locals_[id(t)] for t in st.shards])
        return state

    def _flat_state(self) -> dict:
        return {k: ({(n, j): t for n, st in v.items() for j, t in enumerate(st.locals)}
                    if isinstance(v, dict) else v) for k, v in self.opt_state.items()}

    def _mesh_update(self, loss: torch.Tensor) -> torch.Tensor:
        """Backward onto every local slice, replicas' gradients summed, the
        norm over each slice once, then the update in place."""
        params = self._local_params()
        keys = list(params)
        got = torch.autograd.grad(loss, [params[k] for k in keys], allow_unused=True)
        grads = {k: torch.zeros_like(params[k]) if g is None else g for k, g in zip(keys, got)}
        dev0 = self.mesh.device(0)
        sumsq = []
        for name, groups in self._replicas.items():
            for group in groups:
                if len(group) > 1:  # one slice on several devices: psum
                    total = grads[(name, group[0])]
                    for j in group[1:]:
                        total = total + grads[(name, j)].to(total.device)
                    for j in group:
                        grads[(name, j)] = total.to(params[(name, j)].device)
                sumsq.append(grads[(name, group[0])].float().square().sum().to(dev0))
        gnorm = torch.sqrt(sum(sumsq))
        state = self._flat_state()
        self.optimizer.update(grads, state, params, grad_norm=gnorm)
        self.opt_state["count"] = state["count"]
        return gnorm

    # ---------------------------------------------------------------- train

    def put_batch(self, batch: Any) -> Any:
        if self.mesh is not None:
            return global_batch(batch, self.mesh)
        return to_device(batch, self.device)

    def train_step(self, batch: Any, sync: bool = True) -> dict:
        """One optimizer step.

        ``sync=False`` keeps the metrics on the device (no host-device round
        trip), so the host can queue step N+1 while the card runs step N —
        time such a loop externally around a final ``block_until_ready()``.
        """
        t0 = time.perf_counter()
        batch = self.put_batch(batch)
        if self.mesh is not None:
            with self.mesh:
                loss = self.loss_fn(self.tree, batch)
            gnorm = self._mesh_update(loss)
        else:
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
        devices = self.mesh.distinct_devices if self.mesh is not None else [self.device]
        for dev in devices:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    # ----------------------------------------------------------- checkpoint

    def _state(self) -> dict:
        """The checkpointed state; on a mesh the global tensors, in the
        one-device layout (``state_dict`` names), so either trainer restores
        the other's checkpoints."""
        if self.mesh is None:
            return {"params": self.model.state_dict(), "opt_state": self.opt_state}
        with torch.no_grad():
            return {"params": {n: st.gather() for n, st in self.params.items()},
                    "opt_state": {k: ({n: st.gather() for n, st in v.items()}
                                      if isinstance(v, dict) else v)
                                  for k, v in self.opt_state.items()}}

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
        """Resume from the newest checkpoint; returns True if one existed.
        On a mesh the global tensors are read on the host and re-sharded."""
        if not self._ckpt:
            return False
        restored = self._ckpt.restore_latest(self._state() if self.mesh is None else None)
        if restored is None:
            return False
        state = restored["state"]
        if self.mesh is None:
            with torch.no_grad():
                self.model.load_state_dict(state["params"])
            self.opt_state = state["opt_state"]
        else:
            for n, st in self.params.items():
                st.assign_(state["params"][n])
            for k, v in self.opt_state.items():
                if isinstance(v, dict):
                    for n, st in v.items():
                        st.assign_(state["opt_state"][k][n])
                else:
                    self.opt_state[k] = state["opt_state"][k]
        self.step_num = restored["step"]
        return True

    # -------------------------------------------------------------- metrics

    def mfu(self, peak_flops_per_chip: float, n_chips: Optional[int] = None) -> Optional[float]:
        """Achieved over peak FLOP/s, counting ``mesh.devices.size`` chips
        on a mesh, as the JAX package does (see ``mfu_label``)."""
        if not self.flops_per_batch or not self._history:
            return None
        if n_chips is None:
            n_chips = self.mesh.size if self.mesh is not None else 1
        times = [m["step_time_s"] for m in self._history[1:]] or [self._history[0]["step_time_s"]]
        achieved = self.flops_per_batch / (sum(times) / len(times))
        return achieved / (n_chips * peak_flops_per_chip)

    @property
    def mfu_label(self) -> str:
        """What ``mfu()``'s chips are: ``"4 mesh shards on 1 device
        (cuda:0)"`` says that the shards share one card."""
        if self.mesh is None:
            return f"1 device ({self.device})"
        devs = self.mesh.distinct_devices
        return (f"{self.mesh.size} mesh shards on {len(devs)} device"
                f"{'s' if len(devs) > 1 else ''} ({', '.join(str(d) for d in devs)})")


def _flatten(tree: dict, prefix: str = "") -> dict:
    """A nested dict's leaves under dotted names (``state_dict`` names)."""
    out: dict = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else str(k)
        out.update(_flatten(v, name) if isinstance(v, dict) else {name: v})
    return out


def _replica_groups(st: ShardedTensor) -> list:
    """The local indices of ``st`` grouped by the slice they hold: a group
    of more than one is one slice on several devices."""
    index = {id(t): j for j, t in enumerate(st.locals)}
    groups: dict = {}
    for pos, t in enumerate(st.shards):
        g = groups.setdefault(st.block(pos), [])
        if index[id(t)] not in g:
            g.append(index[id(t)])
    return list(groups.values())
