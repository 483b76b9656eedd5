"""BERT encoder with an MLM head: the training workload of the port.

Counterpart of ``kubeflow_tpu/models/bert.py``.  The parameters keep the JAX
tree's names and its layer-stacked ``[L, ...]`` layout (``embeddings.word``,
``layers.attn_qkv_kernel [L, h, 3, nh, hd]``, ``mlm.output_bias``) inside an
``nn.Module`` (``BertMLM``), so optimizers and ``state_dict`` work and the
JAX package's weights carry over name for name.  ``model["layers"]["..."]``
reads like the JAX dict, so the functions below take either the module or a
nested dict of tensors.

Numerics follow the JAX package: f32 master weights cast to ``config.dtype``
(bf16) per use, the embedding sum in f32 then cast before its LayerNorm, the
bias adds in bf16, LayerNorm in f32 with population variance, tanh GELU, and
the MLM logits in bf16 upcast for the log-softmax.  The layer stack runs as a
Python loop over the stacked weights (``lax.scan`` has no counterpart here).

Rematerialization (``remat=True``) checkpoints one layer at a time with
``torch.utils.checkpoint`` (``use_reentrant=False``) and a selective
checkpoint policy that keeps what the JAX policy of the same name keeps
(``REMAT_SAVES``): nothing but the layer input; every matmul without a
batch dimension (``dots``: the four projections' ``mm`` outputs, not
attention's batched products); or the ``checkpoint_name`` sites (``qkv``,
``attn_out``, ``attn_proj``, ``ffn1``, ``ffn2``), marked here by the
``checkpoint_name`` op, a copy the policy keeps.  The backward recomputes
the rest of the layer once, as JAX does, so the numbers are those without
remat.  The flash kernel's forward runs again in the recompute under every
policy: its log-sum-exp is never a kept value (in the JAX package either).

On a mesh (``with mesh:``, ``parallel/mesh.py``), with the parameters placed
by ``SHARDING_RULES`` (``parallel/sharding.py``), ``encode``, ``mlm_logits``
and ``mlm_loss`` split their work the way GSPMD partitions the JAX model:
the batch over ``("data", "fsdp")``; Megatron on ``tensor``, each tensor
shard taking its heads' slice of the qkv projection and running attention
on those heads (one flash launch per batch shard, tensor shard and layer),
the rows of ``attn_out_kernel`` and ``mlp_out_kernel`` giving partials that
``psum`` adds, ``mlp_in`` split by columns; and every dim a rule splits that
the layer does not compute split (the ``fsdp`` dims, the embeddings'
vocabulary on ``tensor``, the tied MLM head) gathered before use, as XLA's
all-gather.  The MLM loss is exact: the ``psum`` of the masked sums over
the ``psum`` of the counts.  Remat wraps the per-shard layer.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils import checkpoint as _ckpt

from ..ops.attention import multihead_attention, padding_mask
from ..ops.flash_attention import flash_attention
from ..ops.shard_map_compat import each, psum
from ..parallel.mesh import Mesh, current_mesh
from ..parallel.pipeline import gpipe, stack_stages
from ..parallel.sharding import (NamedSharding, P, ShardedTensor, Views, as_sharded, batch_spec,
                                 place_params)
from ..utils.device import resolve_device
from ._tree import tensor_from_numpy


@dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    dtype: torch.dtype = torch.bfloat16
    # rematerialization: each layer under torch.utils.checkpoint, saving
    # what the JAX policy of that name saves (REMAT_SAVES)
    remat: bool = False
    remat_policy: str = "nothing"
    # encoder attention: "dense" materializes [B,H,S,T] logits; "flash" runs
    # the Hopper kernel (ops/flash_attention.py) whose backward recomputes P
    # blockwise.  Both honor the key-side padding mask.
    attention: str = "dense"
    # pipeline parallelism (GPipe over the `stages` mesh axis, see
    # parallel/pipeline.py): >1 splits the layer stack into stages
    pipeline_stages: int = 1
    pipeline_microbatches: int = 4

    def __post_init__(self):
        if self.remat_policy not in REMAT_SAVES:
            raise ValueError(f"unknown remat_policy {self.remat_policy!r} "
                             f"(one of {', '.join(REMAT_SAVES)})")

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def num_params(self) -> int:
        h, f, v = self.hidden_size, self.intermediate_size, self.vocab_size
        per_layer = 4 * h * h + 2 * h * f + 9 * h + f  # qkv/o + ffn kernels, biases, 2 lns
        embed = (v + self.max_position + self.type_vocab_size) * h + 2 * h
        head = h * h + h + 2 * h + v  # transform + ln + bias (embedding tied)
        return self.num_layers * per_layer + embed + head

    def flops_per_token(self, seq_len: int) -> float:
        """Fwd+bwd matmul FLOPs per token (6ND + attention term), full head."""
        h, f, l = self.hidden_size, self.intermediate_size, self.num_layers
        matmul_params = l * (4 * h * h + 2 * h * f) + self.hidden_size * self.vocab_size
        attn = l * 2 * 2 * seq_len * h  # QK^T + PV per token
        return 6 * (matmul_params + attn / 2)

    def train_flops(self, batch: int, seq_len: int, num_predictions: Optional[int] = None) -> float:
        """Fwd+bwd matmul FLOPs for one batch; MLM head on P positions only."""
        h, f, l, v = self.hidden_size, self.intermediate_size, self.num_layers, self.vocab_size
        p = seq_len if num_predictions is None else num_predictions
        encoder = l * (4 * h * h + 2 * h * f) * seq_len
        attn = l * 2 * seq_len * seq_len * h
        head = (h * h + h * v) * p
        return 6 * batch * (encoder + attn + head)


# ----------------------------------------------------------------- sharding

SHARDING_RULES = (
    # embeddings: vocab on tensor, embed on fsdp
    (r"embeddings/(word|position|type)", P("tensor", "fsdp")),
    (r"embeddings/ln_", P()),
    # attention: qkv fused kernel [h, 3, nh, hd] → heads on tensor
    (r"layers/attn_qkv_kernel", P("fsdp", None, "tensor", None)),
    (r"layers/attn_qkv_bias", P(None, "tensor", None)),
    (r"layers/attn_out_kernel", P("tensor", None, "fsdp")),
    # mlp: ffn dim on tensor
    (r"layers/mlp_in_kernel", P("fsdp", "tensor")),
    (r"layers/mlp_in_bias", P("tensor")),
    (r"layers/mlp_out_kernel", P("tensor", "fsdp")),
    # everything else (lns, small biases): replicated
    (r".*", P()),
)


def pp_sharding_rules() -> tuple:
    """SHARDING_RULES variant for pipeline parallelism: the layer-stack dim
    (leading dim of every layers/* leaf) is pinned to the `stages` mesh axis,
    so each stage's device block holds only its own layers."""
    out = []
    for pat, spec in SHARDING_RULES:
        if pat.startswith("layers/"):
            out.append((pat, P("stages", *tuple(spec))))
        else:
            out.append((pat, spec))
    return tuple(out)


def _rules(config: BertConfig) -> tuple:
    """The rules the mesh path places the parameters by: the pipeline rules
    under ``pipeline_stages > 1``, so the layers stay where the Trainer put
    them."""
    return pp_sharding_rules() if config.pipeline_stages > 1 else SHARDING_RULES


# --------------------------------------------------------------------- init


class _Group(nn.Module):
    """One group of leaves, read as ``group["name"]``.  The leaves go into
    ``_parameters`` directly: ``embeddings.type`` shares its name with
    ``nn.Module.type``, which ``register_parameter`` (and so
    ``nn.ParameterDict``) refuses."""

    def __init__(self, leaves: dict):
        super().__init__()
        for name, t in leaves.items():
            self._parameters[name] = nn.Parameter(t)

    def __getitem__(self, name: str) -> nn.Parameter:
        return self._parameters[name]


class BertMLM(nn.Module):
    """The parameter tree as a module: one group per JAX subtree
    (``embeddings``, ``layers``, ``mlm``), leaves under the JAX names, so
    ``state_dict`` keys read ``embeddings.word``, ``layers.ln1_scale``..."""

    def __init__(self, tree: dict):
        super().__init__()
        for group, leaves in tree.items():
            self.add_module(group, _Group(leaves))

    def __getitem__(self, group: str) -> _Group:
        return getattr(self, group)


def init(config: BertConfig, device=None, seed: int = 0) -> BertMLM:
    """Random weights from an explicit ``torch.Generator``: N(0, 0.02²) for
    dense weights, ones for LayerNorm scales, zeros for biases, all f32.  The
    draws are made on the CPU, so a seed gives the same weights on any
    device (not the JAX package's numbers: use ``params_from_jax`` for
    those)."""
    dev = resolve_device(device)
    h, f = config.hidden_size, config.intermediate_size
    l, nh, hd = config.num_layers, config.num_heads, config.head_dim
    g = torch.Generator().manual_seed(seed)

    def dense(*shape, scale=0.02):
        return (torch.randn(shape, generator=g) * scale).to(dev)

    def ones(*shape):
        return torch.ones(shape, device=dev)

    def zeros(*shape):
        return torch.zeros(shape, device=dev)

    return BertMLM({
        "embeddings": {
            "word": dense(config.vocab_size, h),
            "position": dense(config.max_position, h),
            "type": dense(config.type_vocab_size, h),
            "ln_scale": ones(h),
            "ln_bias": zeros(h),
        },
        # layer-stacked params: leading dim = num_layers
        "layers": {
            "attn_qkv_kernel": dense(l, h, 3, nh, hd),
            "attn_qkv_bias": zeros(l, 3, nh, hd),
            "attn_out_kernel": dense(l, nh, hd, h),
            "attn_out_bias": zeros(l, h),
            "ln1_scale": ones(l, h),
            "ln1_bias": zeros(l, h),
            "mlp_in_kernel": dense(l, h, f),
            "mlp_in_bias": zeros(l, f),
            "mlp_out_kernel": dense(l, f, h),
            "mlp_out_bias": zeros(l, h),
            "ln2_scale": ones(l, h),
            "ln2_bias": zeros(l, h),
        },
        "mlm": {
            "transform_kernel": dense(h, h),
            "transform_bias": zeros(h),
            "ln_scale": ones(h),
            "ln_bias": zeros(h),
            "output_bias": zeros(config.vocab_size),
        },
    })


def params_from_jax(np_tree: dict, device=None) -> BertMLM:
    """The weight carrier: the JAX package's nested param dict as numpy
    arrays -> ``BertMLM`` on ``device`` (default ``"cuda"``), name for name
    and bit for bit."""
    dev = resolve_device(device)
    return BertMLM({group: {name: tensor_from_numpy(arr).to(dev)
                            for name, arr in leaves.items()}
                    for group, leaves in np_tree.items()})


# ------------------------------------------------------------------ forward


def _layer_norm(x, scale, bias, eps):
    """LayerNorm in f32 with population variance, f32 scale and bias, the
    result cast back to x's dtype."""
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = (x32 - mu).square().mean(-1, keepdim=True)
    out = (x32 - mu) * torch.rsqrt(var + eps) * scale + bias
    return out.to(x.dtype)


def _gelu(x):
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def encode(params, config: BertConfig, input_ids: torch.Tensor,
           attention_mask: Optional[torch.Tensor] = None,
           token_type_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, S] ids → [B, S, H] hidden states in ``config.dtype`` (under a
    mesh, a ShardedTensor split over the batch)."""
    mesh = current_mesh()
    if mesh is not None:
        xs = _mesh_encode(params, config, mesh, input_ids, attention_mask, token_type_ids)
        return _batch_sharded(xs, mesh)
    if config.pipeline_stages > 1 and attention_mask is not None:
        raise ValueError(_PP_MASK_ERROR)
    emb = params["embeddings"]
    s = input_ids.shape[1]
    # the embedding sum in f32, cast to the compute dtype before the LN
    x = emb["word"][input_ids.long()]
    x = x + emb["position"][None, :s]
    if token_type_ids is not None:
        x = x + emb["type"][token_type_ids.long()]
    else:
        x = x + emb["type"][0]
    x = _layer_norm(x.to(config.dtype), emb["ln_scale"], emb["ln_bias"], config.layer_norm_eps)

    mask = padding_mask(attention_mask) if attention_mask is not None else None
    lp = params["layers"]
    if config.pipeline_stages > 1:
        return _pipeline(config, lp, x, lambda lp_s, i, xm, names: _layer(
            lp_s, i, config, xm, None, None, names))
    keep = REMAT_SAVES[config.remat_policy]
    kw = {"use_reentrant": False}
    if keep:
        kw["context_fn"] = functools.partial(_ckpt.create_selective_checkpoint_contexts,
                                             _keep_policy("dots" in keep))
    for i in range(config.num_layers):
        if config.remat:
            x = _ckpt.checkpoint(_layer, lp, i, config, x, mask, attention_mask,
                                 keep - {"dots"}, **kw)
        else:
            x = _layer(lp, i, config, x, mask, attention_mask, frozenset())
    return x


_PP_MASK_ERROR = (
    "pipeline_stages > 1 requires attention_mask=None (the mask "
    "is full-batch shaped; microbatches would mis-slice it) — "
    "use packed/full-length sequences under pipeline parallelism")


def _pipeline(config: BertConfig, layers, x, run_layer):
    """The layer stack under GPipe (``pipeline_stages > 1``): each stage
    runs ``run_layer(stage_layers, i, x, names)`` over its L/S layers, the
    stage call under remat when ``config.remat`` (with the policy's kept
    names marked, as the per-layer remat marks them)."""
    keep = REMAT_SAVES[config.remat_policy] if config.remat else frozenset()

    def stage(lp, xm):
        for i in range(lp["ln1_scale"].shape[0]):
            xm = run_layer(lp, i, xm, keep - {"dots"})
        return xm

    return gpipe(stage, stack_stages(layers, config.pipeline_stages), x,
                 config.pipeline_microbatches, mb_spec=P(("data", "fsdp"), None, None),
                 remat=config.remat, remat_policy=_keep_policy("dots" in keep) if keep else None)


# ------------------------------------------------------------ one layer


@torch.library.custom_op("kubeflow_tpu_torch::checkpoint_name", mutates_args=())
def checkpoint_name(x: torch.Tensor, name: str) -> torch.Tensor:
    """``jax.ad_checkpoint.checkpoint_name``: a copy of ``x`` that a remat
    policy keeps for the backward (a custom op's output may not alias its
    input, hence the copy; it is made only for the values a policy keeps)."""
    return x.clone()


@checkpoint_name.register_fake
def _(x, name):
    return torch.empty_like(x)


checkpoint_name.register_autograd(lambda ctx, grad: (grad, None))

# what each JAX policy keeps (kubeflow_tpu/models/bert.py:254-269): "dots"
# stands for every matmul without a batch dimension, the other entries are
# checkpoint_name sites
REMAT_SAVES = {
    "nothing": frozenset(),
    "dots": frozenset({"dots"}),
    "save_qkv": frozenset({"qkv"}),
    "save_attn": frozenset({"qkv", "attn_out"}),
    "save_mlp": frozenset({"qkv", "attn_out", "attn_proj", "ffn1", "ffn2"}),
}
_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _keep_policy(dots: bool):
    """The selective checkpoint policy: keep every ``checkpoint_name`` copy
    (only kept names are marked) and, for ``dots``, every 2-d ``mm`` (the
    projections: a ``[B, S, H] @ [H, F]`` product runs as one; attention's
    products run as ``bmm``); recompute everything else."""
    def policy(ctx, op, *args, **kwargs):
        if op is torch.ops.kubeflow_tpu_torch.checkpoint_name.default or (dots and op in _MATMULS):
            return _ckpt.CheckpointPolicy.MUST_SAVE
        return _ckpt.CheckpointPolicy.PREFER_RECOMPUTE
    return policy


def _layer(lp, i, config: BertConfig, x, mask, attention_mask, names: frozenset):
    """Encoder layer ``i``; the values in ``names`` pass through
    ``checkpoint_name`` for the remat policy to keep."""
    def mark(t, name):
        return checkpoint_name(t, name) if name in names else t

    dt = config.dtype
    b, s = x.shape[:2]
    h, nh, hd = config.hidden_size, config.num_heads, config.head_dim
    qkv = x @ lp["attn_qkv_kernel"][i].to(dt).reshape(h, 3 * nh * hd)
    qkv = mark(qkv.reshape(b, s, 3, nh, hd) + lp["attn_qkv_bias"][i].to(dt), "qkv")
    q, k_, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    if config.attention == "flash":
        # kv_mask: key-side padding exclusion inside the kernel
        attn = flash_attention(q, k_, v, causal=False, kv_mask=attention_mask)
    else:
        attn = multihead_attention(q, k_, v, mask=mask)
    attn = mark(attn, "attn_out")
    attn = attn.reshape(b, s, nh * hd) @ lp["attn_out_kernel"][i].to(dt).reshape(nh * hd, h)
    attn = mark(attn + lp["attn_out_bias"][i].to(dt), "attn_proj")
    x = _layer_norm(x + attn, lp["ln1_scale"][i], lp["ln1_bias"][i], config.layer_norm_eps)

    hmid = mark(x @ lp["mlp_in_kernel"][i].to(dt), "ffn1")
    hmid = _gelu(hmid + lp["mlp_in_bias"][i].to(dt))
    hout = hmid @ lp["mlp_out_kernel"][i].to(dt)
    hout = mark(hout + lp["mlp_out_bias"][i].to(dt), "ffn2")
    return _layer_norm(x + hout, lp["ln2_scale"][i], lp["ln2_bias"][i], config.layer_norm_eps)


def mlm_logits(params, config: BertConfig, hidden: torch.Tensor) -> torch.Tensor:
    """MLM head with tied embeddings: [B, S, H] → [B, S, V] in ``config.dtype``
    (a ShardedTensor ``hidden`` gives one)."""
    if isinstance(hidden, ShardedTensor):
        mesh = hidden.mesh
        params = place_params(params, mesh, _rules(config))
        logits = each(lambda hs, *leaves: mlm_logits(_head_params(*leaves), config, hs),
                      hidden.shards, *_head_views(params, mesh))
        return _batch_sharded(logits, mesh)
    dt = config.dtype
    mlm = params["mlm"]
    h = hidden @ mlm["transform_kernel"].to(dt)
    h = _gelu(h + mlm["transform_bias"].to(dt))
    h = _layer_norm(h, mlm["ln_scale"], mlm["ln_bias"], config.layer_norm_eps)
    logits = h @ params["embeddings"]["word"].to(dt).t()
    return logits + mlm["output_bias"].to(dt)


def forward(params, config: BertConfig, input_ids: torch.Tensor,
            attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    return mlm_logits(params, config, encode(params, config, input_ids, attention_mask))


def mlm_loss(params, config: BertConfig, input_ids: torch.Tensor,
             labels: torch.Tensor, attention_mask: Optional[torch.Tensor] = None,
             max_predictions: Optional[int] = None) -> torch.Tensor:
    """Masked-LM cross entropy; positions with label == -100 are ignored.

    ``max_predictions``: gather only (up to) P masked positions per sequence
    before the vocab projection, so the [B, S, V] logits become [B, P, V].
    """
    mesh = current_mesh()
    if mesh is not None:
        return _mesh_mlm_loss(params, config, mesh, input_ids, labels, attention_mask,
                              max_predictions)
    hidden = encode(params, config, input_ids, attention_mask)
    total, count = _masked_sums(params, config, hidden, labels, max_predictions)
    return total / torch.clamp(count, min=1)


def _masked_sums(params, config: BertConfig, hidden, labels, max_predictions):
    """(sum of the masked positions' cross entropy, their count)."""
    valid = labels != -100
    if max_predictions is not None:
        # indices of masked positions, padded with unmasked (weight-0) slots.
        # lax.top_k breaks ties to the lowest index; torch.topk promises no
        # order, a stable descending sort does what top_k does
        weights, idx = torch.sort(valid.int(), dim=1, descending=True, stable=True)
        weights, idx = weights[:, :max_predictions], idx[:, :max_predictions]
        hidden = torch.take_along_dim(hidden, idx[..., None], dim=1)
        labels = torch.take_along_dim(labels, idx, dim=1)
        valid = weights.bool()
    logits = mlm_logits(params, config, hidden).float()
    safe_labels = torch.where(valid, labels, 0).long()
    logp = torch.log_softmax(logits, dim=-1)
    token_loss = -torch.take_along_dim(logp, safe_labels[..., None], dim=-1)[..., 0]
    return (token_loss * valid).sum(), valid.sum()


# ------------------------------------------------------------ on a mesh


def _batch_lists(mesh: Mesh, *ts) -> list:
    """Each batch input's per-position shards (split over the batch spec),
    None for an absent one."""
    spec = batch_spec(mesh)
    return [[None] * mesh.size if t is None else as_sharded(t, mesh, spec).shards
            for t in ts]


def _batch_sharded(shards: list, mesh: Mesh) -> ShardedTensor:
    shape = list(shards[0].shape)
    shape[0] *= mesh.shape["data"] * mesh.shape["fsdp"]
    return ShardedTensor(shards, shape, NamedSharding(mesh, batch_spec(mesh)))


def _mesh_encode(params, config: BertConfig, mesh: Mesh, input_ids, attention_mask,
                 token_type_ids) -> list:
    """``encode`` over the mesh: per-position hidden states, one tensor per
    batch shard and device."""
    tp = mesh.shape["tensor"]
    if config.num_heads % tp or config.intermediate_size % tp:
        raise ValueError(f"tensor={tp} must divide num_heads={config.num_heads} and "
                         f"intermediate_size={config.intermediate_size}")
    if config.pipeline_stages > 1 and attention_mask is not None:
        raise ValueError(_PP_MASK_ERROR)
    params = place_params(params, mesh, _rules(config))
    ids, am, tt = _batch_lists(mesh, input_ids, attention_mask, token_type_ids)
    emb = params["embeddings"]
    views = Views(mesh)

    def embed(ids_, tt_, word, position, typ, ln_s, ln_b):
        x = word[ids_.long()] + position[None, :ids_.shape[1]]
        x = x + (typ[tt_.long()] if tt_ is not None else typ[0])
        return _layer_norm(x.to(config.dtype), ln_s, ln_b, config.layer_norm_eps)

    xs = each(embed, ids, tt, *(views(emb[n]) for n in
                                ("word", "position", "type", "ln_scale", "ln_bias")))
    masks = each(lambda a: None if a is None else padding_mask(a), am)
    lp = params["layers"]
    if config.pipeline_stages > 1:
        def run_layer(lp_s, i, xm, names):
            none = [None] * xm.mesh.size
            return xm.like(_mesh_layer(lp_s, i, config, xm.mesh, xm.shards, none, none, names))

        return _pipeline(config, lp, _batch_sharded(xs, mesh), run_layer).shards
    keep = REMAT_SAVES[config.remat_policy]
    kw = {"use_reentrant": False}
    if keep:
        kw["context_fn"] = functools.partial(_ckpt.create_selective_checkpoint_contexts,
                                             _keep_policy("dots" in keep))
    for i in range(config.num_layers):
        if config.remat:
            xs = _ckpt.checkpoint(_mesh_layer, lp, i, config, mesh, xs, masks, am,
                                  keep - {"dots"}, **kw)
        else:
            xs = _mesh_layer(lp, i, config, mesh, xs, masks, am, frozenset())
    return xs


def _mesh_layer(lp, i, config: BertConfig, mesh: Mesh, xs, masks, kv_masks,
                names: frozenset) -> list:
    """Encoder layer ``i`` over the mesh's shards: each tensor shard its
    heads and its ``d_ff`` columns (the weights' ``fsdp`` dims gathered),
    the two row-parallel partials added by ``psum`` over ``tensor``."""
    def mark(t, name):
        return checkpoint_name(t, name) if name in names else t

    dt = config.dtype
    h, hd, eps = config.hidden_size, config.head_dim, config.layer_norm_eps
    views = Views(mesh)
    tp = ("tensor",)

    def attention(x, w_qkv, b_qkv, w_out, mask, kv_mask):
        b, s = x.shape[:2]
        nh = w_qkv.shape[2]
        qkv = x @ w_qkv.reshape(h, 3 * nh * hd)
        qkv = mark(qkv.reshape(b, s, 3, nh, hd) + b_qkv, "qkv")
        q, k_, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        if config.attention == "flash":
            attn = flash_attention(q, k_, v, causal=False, kv_mask=kv_mask)
        else:
            attn = multihead_attention(q, k_, v, mask=mask)
        attn = mark(attn, "attn_out")
        return attn.reshape(b, s, nh * hd) @ w_out.reshape(nh * hd, h)

    parts = each(attention, xs, views(lp["attn_qkv_kernel"], tp, i, dt),
                 views(lp["attn_qkv_bias"], tp, i, dt), views(lp["attn_out_kernel"], tp, i, dt),
                 masks, kv_masks)
    xs = each(lambda x, a, bias, ln_s, ln_b: _layer_norm(
        x + mark(a + bias, "attn_proj"), ln_s, ln_b, eps),
        xs, psum(parts, "tensor", mesh), views(lp["attn_out_bias"], (), i, dt),
        views(lp["ln1_scale"], (), i), views(lp["ln1_bias"], (), i))

    def mlp(x, w_in, b_in, w_out):
        hmid = _gelu(mark(x @ w_in, "ffn1") + b_in)
        return hmid @ w_out

    parts = each(mlp, xs, views(lp["mlp_in_kernel"], tp, i, dt),
                 views(lp["mlp_in_bias"], tp, i, dt), views(lp["mlp_out_kernel"], tp, i, dt))
    return each(lambda x, o, bias, ln_s, ln_b: _layer_norm(
        x + mark(o + bias, "ffn2"), ln_s, ln_b, eps),
        xs, psum(parts, "tensor", mesh), views(lp["mlp_out_bias"], (), i, dt),
        views(lp["ln2_scale"], (), i), views(lp["ln2_bias"], (), i))


_HEAD_LEAVES = ("transform_kernel", "transform_bias", "ln_scale", "ln_bias", "output_bias")


def _head_views(params, mesh: Mesh) -> list:
    """Per-position views of the MLM head's leaves, the tied embedding
    gathered whole (its vocabulary on ``tensor``, its width on ``fsdp``)."""
    views = Views(mesh)
    return ([views(params["mlm"][n]) for n in _HEAD_LEAVES]
            + [views(params["embeddings"]["word"])])


def _head_params(*leaves) -> dict:
    *mlm, word = leaves
    return {"mlm": dict(zip(_HEAD_LEAVES, mlm)), "embeddings": {"word": word}}


def _mesh_mlm_loss(params, config: BertConfig, mesh: Mesh, input_ids, labels,
                   attention_mask, max_predictions) -> torch.Tensor:
    """``mlm_loss`` over the mesh: each batch shard's masked sum and count,
    each summed over the batch axes, their quotient the global mean."""
    params = place_params(params, mesh, _rules(config))
    xs = _mesh_encode(params, config, mesh, input_ids, attention_mask, None)
    (labs,) = _batch_lists(mesh, labels)
    sums = each(lambda x, lab, *leaves: _masked_sums(_head_params(*leaves), config, x, lab,
                                                     max_predictions),
                xs, labs, *_head_views(params, mesh))
    axes = batch_spec(mesh)[0]
    totals = psum([t for t, _ in sums], axes, mesh)
    counts = psum([c for _, c in sums], axes, mesh)
    return each(lambda t, c: t / torch.clamp(c, min=1), totals, counts)[0]
