"""Training loop: forward, backward and an optax-exact AdamW, on one device
or on a mesh.

Counterpart of ``kubeflow_tpu/train/trainer.py``.  PyTorch runs eagerly, so
there is no jit and no buffer donation; the trainer updates the parameters
and the optimizer state in place.

The model is an ``nn.Module`` (BERT, the MoE transformer) or a nested dict
/ list of tensors (the decoder, ResNet, MNIST).  ``mesh=None`` trains the
model on one device.  With a mesh
(``parallel/mesh.py``) and the model's sharding rules, the parameters and
the AdamW moments are placed by the rules as ``ShardedTensor``s (each
moment in its parameter's layout), the batch
by ``batch_spec``, and the loss, its backward and the update run on each
shard's slice with the mesh current, as the JAX package's one jitted step
runs on its mesh.  Where one slice lives on several devices the replicas'
gradients are summed; the global gradient norm counts each slice once.
Each process drives the shards it owns (the mesh's devices may repeat: N
shards of one card).  On a mesh across processes (``parallel/mesh.py``)
the batch is the global value, equal on every process, each keeping its
rows (``put_batch``); a slice's gradient is summed over every process that
holds it, the norm counts each slice on the process of its first holder
(one all-reduce of the sum of squares), and every process gets the same
loss and norm.  Checkpoints gather every process's slices; process 0 alone
writes them (``train/checkpoint.py``).

``default_optimizer`` reproduces the JAX package's optax chain
``clip_by_global_norm(max_grad_norm)`` then ``adamw(warmup_cosine_decay)``
exactly (see ``AdamW``), the bf16 at-rest moments of ``optimizer_dtype``
included.  ``compiled_cost_analysis`` counts one forward and backward of
the step with ``torch.utils.flop_counter`` (XLA's cost model has no
counterpart), the flash kernel at its own products.
"""

from __future__ import annotations

import math
import time
import zlib
from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np
import torch
from torch import nn

from ..models._tree import named_leaves as _flatten
from ..parallel import distributed
from ..parallel.mesh import Mesh
from ..parallel.sharding import ShardedTensor, batch_spec, shard_params, tree_map_with_path
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

    ``model`` is an ``nn.Module`` (``models.bert.BertMLM``) or a nested
    dict / list of tensors (``decoder.init``, ``resnet.init``).  Without a
    mesh it is moved to ``device`` (default ``"cuda"``, which raises without
    a card) and its parameters are updated in place: a module's own, a
    tree's leaves as new leaf tensors (sharing the caller's storage where
    they are on ``device`` already), which ``loss_fn`` receives as
    ``model``.  With ``mesh`` and ``rules`` (the model's path rules, e.g.
    ``bert.SHARDING_RULES``) its parameters are copied onto the mesh as
    ``ShardedTensor``s: ``params`` maps each dotted name (a module's
    ``state_dict`` name) to one, ``tree`` nests them as the model does, and
    ``loss_fn`` receives ``tree`` under ``with mesh:`` (``model`` is left as
    it was; ``model`` is None on the trainer).  ``global_params()`` hands
    back the model's tree of global tensors, to serve or evaluate off the
    mesh.  ``batch`` is a dict of numpy arrays or tensors, split over the
    batch on a mesh."""

    def __init__(
        self,
        loss_fn: Callable[[Any, Any], torch.Tensor],
        model: Any,
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
            if isinstance(model, nn.Module):
                self.model = model.to(self.device)
                self.params = dict(self.model.named_parameters())
            else:
                self.model = tree_map_with_path(
                    lambda _, t: t.detach().to(self.device).requires_grad_(), model)
                self.params = _flatten(self.model)
            self.opt_state = self.optimizer.init(self.params)
        else:
            if rules is None:
                raise ValueError("Trainer on a mesh needs the model's sharding rules")
            self.rules = tuple(rules)
            self.device = mesh.device(mesh.local_positions[0])
            self.model = None
            self.tree = shard_params(model, mesh, self.rules)
            self.params = _flatten(self.tree)
            for st in self.params.values():
                for t in st.locals:
                    t.requires_grad_(True)
            self._replicas = {n: _replica_groups(st) for n, st in self.params.items()}
            # the slices other processes hold too, in one order everywhere
            self._shared = {n: sorted({st.block(p) for p in range(mesh.size)
                                       if _holders_span(st, st.block(p))})
                            for n, st in self.params.items()}
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
                state[key][name] = st.like([None if t is None else locals_[id(t)]
                                            for t in st.shards])
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
        dev0 = self.device
        for name, groups in self._replicas.items():
            for _, group, _ in groups:
                if len(group) > 1:  # one slice on several devices: psum
                    total = grads[(name, group[0])]
                    for j in group[1:]:
                        total = total + grads[(name, j)].to(total.device)
                    for j in group:
                        grads[(name, j)] = total.to(params[(name, j)].device)
        if not self.mesh.is_fully_addressable:
            self._sum_across(grads, params)
        sumsq = [grads[(name, group[0])].float().square().sum().to(dev0)
                 for name, groups in self._replicas.items()
                 for _, group, first_here in groups if first_here]
        total = sum(sumsq) if sumsq else torch.zeros((), device=dev0)
        if not self.mesh.is_fully_addressable:
            total = distributed.all_reduce_sum(total)
        gnorm = torch.sqrt(total)
        state = self._flat_state()
        self.optimizer.update(grads, state, params, grad_norm=gnorm)
        self.opt_state["count"] = state["count"]
        return gnorm

    def _sum_across(self, grads: dict, params: dict) -> None:
        """Sum each slice that several processes hold over them: one
        all-reduce of every such slice, zeros where this process holds
        none, in one order on every process."""
        parts, slots = [], []
        for name, blocks in self._shared.items():
            mine = {blk: group for blk, group, _ in self._replicas[name]}
            st = self.params[name]
            shape = st.sharding.shard_shape(tuple(st.shape))
            for blk in blocks:
                if blk in mine:
                    g = grads[(name, mine[blk][0])]
                    parts.append(g.float().reshape(-1).to(self.device))
                    slots.append((name, mine[blk]))
                else:
                    parts.append(torch.zeros(math.prod(shape), device=self.device))
                    slots.append(None)
        if not parts:
            return
        total = distributed.all_reduce_sum(torch.cat(parts))
        off = 0
        for part, slot in zip(parts, slots):
            if slot is not None:
                name, group = slot
                like = params[(name, group[0])]
                summed = total[off:off + part.numel()].reshape(like.shape)
                for j in group:
                    grads[(name, j)] = summed.to(params[(name, j)].device, like.dtype)
            off += part.numel()

    # ---------------------------------------------------------------- train

    def put_batch(self, batch: Any) -> Any:
        """The batch on the trainer's device, or split over its mesh by
        ``batch_spec``.  On a mesh across processes the batch is the global
        value (``jax.device_put``'s rule), which must be equal on every
        process: a checksum over the job raises on a mismatch, as JAX
        asserts; each process keeps its positions' rows."""
        if self.mesh is None:
            return to_device(batch, self.device)
        if not self.mesh.is_fully_addressable:
            sums = distributed.all_gather_object(_checksum(batch), self.mesh.group(
                self.mesh.processes))
            if any(s != sums[0] for s in sums):
                raise ValueError("the batch passed to put_batch is not the same on each "
                                 f"process (checksums {sums}); a process-local batch goes "
                                 "through train.data.global_batch")
        spec = batch_spec(self.mesh)
        return {k: v if isinstance(v, ShardedTensor) else
                ShardedTensor.shard(torch.as_tensor(v), self.mesh, spec)
                for k, v in batch.items()}

    def compiled_cost_analysis(self, batch: Any) -> dict:
        """The step's FLOPs — {"flops": n} — or {} when the count is not
        available; it never breaks training.  Counts one forward and
        backward of ``loss_fn`` on ``batch`` with ``FlopCounterMode``
        (matmuls, convolutions, SDPA), the flash kernel at its own products
        (``ops.flash_attention.counting_flops``), so ``attention="flash"``
        and ``"dense"`` count alike; a remat recompute counts again (the
        remat tax).  The optimizer update (elementwise) is not counted.
        Params, the optimizer state, the step counter and the RNG are left
        as they were; the gradients are dropped."""
        try:
            from torch.utils.flop_counter import FlopCounterMode

            from ..ops.flash_attention import counting_flops

            batch = self.put_batch(batch)
            devices = [d for d in (self.mesh.distinct_devices if self.mesh is not None
                                   else [self.device]) if d.type == "cuda"]
            with torch.random.fork_rng(devices=devices), counting_flops() as tally, \
                    FlopCounterMode(display=False) as counter:
                if self.mesh is not None:
                    params = self._local_params()
                    with self.mesh:
                        loss = self.loss_fn(self.tree, batch)
                else:
                    params = self.params
                    loss = self.loss_fn(self.model, batch)
                torch.autograd.grad(loss, list(params.values()), allow_unused=True)
            return {"flops": float(counter.get_total_flops() - tally.inside + tally.model)}
        except Exception:  # noqa: BLE001 — diagnostics never break training
            return {}

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
            params = (self.model.state_dict() if isinstance(self.model, nn.Module)
                      else {n: t.detach() for n, t in self.params.items()})
            return {"params": params, "opt_state": self.opt_state}
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
                if isinstance(self.model, nn.Module):
                    self.model.load_state_dict(state["params"])
                else:
                    for n, t in self.params.items():
                        t.copy_(state["params"][n])
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

    def global_params(self) -> Any:
        """The parameters as the model's tree of global tensors, detached
        (the JAX ``Trainer.params``): on a mesh each ShardedTensor gathered
        onto the mesh's first device; on one device the model's own leaves
        (a module's as its ``param_tree``).  A leaf that no rule splits and
        that lives there already is the parameter's own storage, not a
        copy."""
        tree = self.tree if self.mesh is not None else self.model

        def leaf(_, t):
            return (t.gather() if isinstance(t, ShardedTensor) else t).detach()

        with torch.no_grad():
            return tree_map_with_path(leaf, tree)

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
        (cuda:0)"`` says that the shards share one card; ``"4 mesh shards in
        2 processes on 1 device (cuda:0)"`` that two processes share it."""
        if self.mesh is None:
            return f"1 device ({self.device})"
        mesh = self.mesh
        if mesh.is_fully_addressable:
            devs = [str(d) for d in mesh.distinct_devices]
            where = ""
        else:
            devs = sorted({mesh.device_name(p) for p in range(mesh.size)})
            where = f" in {len(mesh.processes)} processes"
        n = distributed.card_count(mesh.processes) if where else len(devs)
        return (f"{mesh.size} mesh shards{where} on {n} device"
                f"{'s' if n > 1 else ''} ({', '.join(devs)})")


def _checksum(batch: dict) -> list:
    """A CRC of each leaf's bytes, in key order."""
    out = []
    for k in sorted(batch):
        v = batch[k]
        if isinstance(v, ShardedTensor):  # placed already (``global_batch``)
            continue
        v = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
        out.append((k, v.shape, str(v.dtype), zlib.crc32(np.ascontiguousarray(v).tobytes())))
    return out


def _holders_span(st: ShardedTensor, blk: tuple) -> bool:
    mesh = st.mesh
    return len({mesh.process_of(p) for p in range(mesh.size) if st.block(p) == blk}) > 1


def _replica_groups(st: ShardedTensor) -> list:
    """The local indices of ``st`` grouped by the slice they hold, as
    (block, indices, whether this process holds the block's first holder):
    a group of more than one is one slice on several devices."""
    mesh = st.mesh
    index = {id(t): j for j, t in enumerate(st.locals)}
    groups: dict = {}
    for pos in mesh.local_positions:
        g = groups.setdefault(st.block(pos), [])
        if index[id(st.shards[pos])] not in g:
            g.append(index[id(st.shards[pos])])
    first = {}
    for pos in range(mesh.size):
        first.setdefault(st.block(pos), pos)
    return [(blk, g, mesh.is_local(first[blk])) for blk, g in groups.items()]
