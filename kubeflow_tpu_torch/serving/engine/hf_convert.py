"""HuggingFace checkpoint -> engine params converter (Llama-family).

A copy of ``kubeflow_tpu/serving/engine/hf_convert.py`` (the port imports
nothing of the JAX package): ``is_hf_config``, ``hf_dir_needs_conversion``,
``_map_config``, ``_PER_LAYER``, ``_map_tensors``, ``convert_hf_checkpoint``
and ``main`` keep the JAX package's behaviour and every error message, and
write a byte-identical ``params.npz`` (fp16, or f32 with
``dtype="float32"``) and an equal ``config.json``, in the same order:
``params.npz`` first, ``config.json`` last, both through a temp file and
``os.replace``, so a conversion that crashed between the two re-runs on the
next load.

Only ``_LazyTensors`` differs: it reads ``*.safetensors`` shards with the
port's own reader (``lora.SafetensorsFile``: the header once, one tensor
per seek and read, bf16 as a torch bf16 tensor widened to f32 exactly,
never through a numpy ``bfloat16``), so the port needs neither the
``safetensors`` package nor ``ml_dtypes``; ``pytorch_model*.bin`` files load
with ``torch.load(..., weights_only=True)`` as in the JAX package.

Scope (as in the JAX package): Llama-architecture models (llama / llama2 /
llama3 / mistral, incl. Nemo-style decoupled head_dim) and Gemma-1, whose
block deltas the engine's config flags express (GeGLU via
act="gelu_tanh", sqrt(d_model) input-embedding scaling, explicit head_dim)
with the (1+w) norms folded into the stored weights here.  HF stores
projections as [out, in]; the engine right-multiplies, so every projection
transposes, and per-layer tensors stack into one [L, ...] array.
Architectures with block math the engine does NOT implement (gemma-2/3
softcapping, phi's partial rotary, rope_scaling, non-tanh GeLU) are
rejected loudly rather than converted wrong.
"""

from __future__ import annotations

import gc
import json
import os
import sys

import numpy as np
import torch

from .lora import SafetensorsFile

_LLAMA_TYPES = {"llama", "mistral"}
# Gemma-1: same projection layout, three block deltas the engine's config
# flags express (GeGLU activation, sqrt(d_model) input-embedding scaling,
# decoupled head_dim) plus (1+w) norms folded into the weights at
# conversion.  gemma2/gemma3 add softcapping / sliding-window / extra
# norms the engine does NOT implement — rejected, not approximated.
_GEMMA_TYPES = {"gemma"}


def is_hf_config(raw: dict) -> bool:
    """True if a config.json dict is a transformers config (not ours).
    HF configs always carry model_type/architectures; ours never do."""
    return "model_type" in raw or "architectures" in raw


def hf_dir_needs_conversion(model_dir: str) -> bool:
    """True while config.json is still HF-format.  config.json is the ONE
    gate — it is written LAST (atomically) by convert_hf_checkpoint, so a
    crash anywhere mid-conversion leaves it HF-format and conversion
    simply re-runs on the next load.  (Keying on params.npz existence
    would wedge a dir whose crash landed between the two writes: convert
    skipped, from_dir raising, forever.)"""
    cfg = os.path.join(model_dir, "config.json")
    if not os.path.exists(cfg):
        return False
    with open(cfg) as f:
        try:
            raw = json.load(f)
        except ValueError:
            return False
    return is_hf_config(raw)


def _map_config(raw: dict) -> dict:
    mt = raw.get("model_type", "")
    if mt not in _LLAMA_TYPES | _GEMMA_TYPES:
        raise ValueError(
            f"unsupported model_type {mt!r}: the engine decoder implements "
            f"the Llama block (+ Gemma-1's flagged deltas); supported: "
            f"{sorted(_LLAMA_TYPES | _GEMMA_TYPES)}.  Models with different "
            "block math (gemma2's softcapping, phi's partial rotary, ...) "
            "must not be silently mis-converted.")
    if raw.get("rope_scaling"):
        # llama-3.1+ long-context scaling changes the RoPE frequencies; the
        # engine applies plain theta-RoPE, so converting would produce
        # numerically wrong generations with no error — reject loudly
        raise ValueError(
            f"rope_scaling={raw['rope_scaling']!r} is not implemented in "
            "the engine's RoPE; refusing to convert to silently-wrong "
            "frequencies (base Llama-3 / Llama-2 / Mistral / Gemma work)")
    implied_hd = raw["hidden_size"] // raw["num_attention_heads"]
    explicit_hd = raw.get("head_dim") or implied_hd  # None = derive
    out = {
        "vocab_size": raw["vocab_size"],
        "d_model": raw["hidden_size"],
        "n_layers": raw["num_hidden_layers"],
        "n_heads": raw["num_attention_heads"],
        "n_kv_heads": raw.get("num_key_value_heads",
                              raw["num_attention_heads"]),
        "d_ff": raw["intermediate_size"],
        "rope_theta": float(raw.get("rope_theta", 10000.0)),
        "norm_eps": float(raw.get("rms_norm_eps", 1e-5)),
    }
    if "eos_token_id" in raw:
        # passthrough: DecoderConfig ignores it, but serve.py's EOS
        # fallback reads it — conversion overwrites the HF config.json,
        # so a checkout declaring eos only there must not lose it
        out["eos_token_id"] = raw["eos_token_id"]
    if mt in _GEMMA_TYPES:
        # only the tanh-approx GeLU is implemented: explicit
        # hidden_activation="gelu" (erf) or "gelu_new" would silently
        # diverge if mapped onto tanh — reject, never approximate.
        # (hidden_activation unset means transformers forces
        # gelu_pytorch_tanh regardless of the legacy hidden_act field.)
        act = raw.get("hidden_activation")
        if act not in (None, "gelu_pytorch_tanh"):
            raise ValueError(f"gemma hidden_activation {act!r} is not the "
                             "tanh-approx GeLU the engine implements")
        out.update(head_dim_override=explicit_hd, act="gelu_tanh",
                   scale_embed=True)
    elif explicit_hd != implied_hd:
        # Mistral-Nemo-class: head_dim decoupled from hidden/heads (e.g.
        # 128 with 5120/32=160) — expressible since head_dim_override
        out["head_dim_override"] = explicit_hd
    return out


class _LazyTensors:
    """name -> numpy array, materialized one tensor at a time.

    Eagerly loading every shard costs a full extra model copy in host RAM
    next to the stacked output (8B ≈ +16-32GB) — instead keep each shard's
    parsed header and read each tensor when the mapper asks for it (bf16
    widened to f32 exactly, f16 and f32 as stored).  The torch-bin fallback
    has no lazy API; it loads eagerly (legacy path)."""

    def __init__(self, src_dir: str):
        import glob

        self._by_name: dict = {}     # name -> (SafetensorsFile) or ndarray
        self._handles: list = []
        shards = sorted(glob.glob(os.path.join(src_dir, "*.safetensors")))
        if shards:
            for shard in shards:
                f = SafetensorsFile(shard)
                self._handles.append(f)
                for name in f.keys():
                    self._by_name[name] = f
            return
        bins = sorted(glob.glob(os.path.join(src_dir, "pytorch_model*.bin")))
        if not bins:
            raise FileNotFoundError(
                f"no *.safetensors or pytorch_model*.bin in {src_dir}")
        for b in bins:
            sd = torch.load(b, map_location="cpu", weights_only=True)
            for name, t in sd.items():
                self._by_name[name] = t.float().numpy()

    def pop(self, name):
        if name not in self._by_name:
            # a checkout whose shards hold fewer tensors/layers than its
            # config claims should fail with the tensor name, not a raw
            # KeyError from deep inside the mapper
            raise ValueError(
                f"checkpoint is missing tensor {name!r} (config declares "
                "more layers/weights than the shards contain)")
        src = self._by_name.pop(name)
        if isinstance(src, np.ndarray):
            return src
        t = src.get(name)
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    def close(self) -> None:
        # a SafetensorsFile holds no open descriptor between reads
        self._handles = []

    def __contains__(self, name) -> bool:
        return name in self._by_name

    def remaining(self) -> list:
        return sorted(self._by_name)


_PER_LAYER = {
    # engine name -> (HF suffix, transpose)
    "wq": ("self_attn.q_proj.weight", True),
    "wk": ("self_attn.k_proj.weight", True),
    "wv": ("self_attn.v_proj.weight", True),
    "wo": ("self_attn.o_proj.weight", True),
    "w1": ("mlp.gate_proj.weight", True),
    "w3": ("mlp.up_proj.weight", True),
    "w2": ("mlp.down_proj.weight", True),
    "ln_attn": ("input_layernorm.weight", False),
    "ln_mlp": ("post_attention_layernorm.weight", False),
}


def _map_tensors(tensors: "_LazyTensors", cfg: dict, raw: dict, store) -> dict:
    """Map every checkpoint tensor into the engine's layer-stacked layout;
    raises on missing/unmapped/non-finite weights (see convert docstring)."""

    def grab(name, transpose=False):
        """One tensor, downcast to the storage dtype immediately — only one
        fp32 tensor is ever alive, keeping peak RAM ~1x model size."""
        t = np.asarray(tensors.pop(name), np.float32)
        t = (t.T if transpose else t).astype(store)
        if not np.isfinite(t).all():
            # fp16 storage has a narrower exponent range than bf16: an
            # outlier weight > 65504 becomes inf here and NaN logits at
            # serve time — fail at conversion, where it is attributable
            raise ValueError(f"{name} has non-finite values after casting "
                             f"to {np.dtype(store).name} (outlier weight "
                             "beyond the storage dtype's range)")
        return t

    out = {"embed": grab("model.embed_tokens.weight")}
    for ours, (suffix, transpose) in _PER_LAYER.items():
        out[ours] = np.stack([
            grab(f"model.layers.{l}.{suffix}", transpose)
            for l in range(cfg["n_layers"])])
        gc.collect()
    out["ln_out"] = grab("model.norm.weight")
    if raw.get("model_type") in _GEMMA_TYPES:
        # gemma's RMSNorm multiplies by (1 + w); folding the +1 into the
        # stored weights keeps the runtime norm shared with llama
        for k in ("ln_attn", "ln_mlp", "ln_out"):
            out[k] = (out[k].astype(np.float32) + 1.0).astype(store)
    if "lm_head.weight" in tensors:
        out["unembed"] = grab("lm_head.weight", transpose=True)
    else:  # tied embeddings (gemma, llama3.2-1b, and most tiny test configs)
        out["unembed"] = out["embed"].T.copy()
    leftovers = [n for n in tensors.remaining() if "rotary_emb" not in n]
    if leftovers:
        raise ValueError(f"unmapped checkpoint tensors: {leftovers[:8]} — "
                         "refusing to drop weights silently")
    return out


def convert_hf_checkpoint(src_dir: str, out_dir: str,
                          dtype: str = "bfloat16") -> dict:
    """Convert an HF Llama-family checkout into ``out_dir`` (config.json +
    params.npz in the engine's format).  Returns the engine config dict.

    ``dtype``: storage dtype for params.npz — "bfloat16" (default; stored
    as float16, whose 10-bit mantissa strictly covers bf16's 7 — numpy's
    npz loader can't round-trip ml_dtypes.bfloat16) or "float32" (parity
    testing).  load_params casts to bf16 on load either way."""
    if dtype not in ("bfloat16", "float32"):
        raise ValueError(f"dtype must be 'bfloat16' or 'float32', got {dtype!r}")
    with open(os.path.join(src_dir, "config.json")) as f:
        raw = json.load(f)
    cfg = _map_config(raw)
    store = np.float32 if dtype == "float32" else np.float16

    tensors = _LazyTensors(src_dir)
    try:
        out = _map_tensors(tensors, cfg, raw, store)
    finally:
        tensors.close()

    # params FIRST, config LAST, both atomic: config.json is the one gate
    # hf_dir_needs_conversion reads, so a crash anywhere before the final
    # replace leaves the dir still recognized as unconverted and the next
    # load re-runs conversion.  (Config-first would make a later load fall
    # back to RANDOM params and serve garbage.)
    os.makedirs(out_dir, exist_ok=True)
    tmp = os.path.join(out_dir, "params.npz.tmp")
    with open(tmp, "wb") as f:
        np.savez(f, **out)
    os.replace(tmp, os.path.join(out_dir, "params.npz"))
    tmp_cfg = os.path.join(out_dir, "config.json.tmp")
    with open(tmp_cfg, "w") as f:
        json.dump(cfg, f, indent=1)
    os.replace(tmp_cfg, os.path.join(out_dir, "config.json"))
    return cfg


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) not in (2, 3):
        print("usage: python -m kubeflow_tpu_torch.serving.engine.hf_convert "
              "SRC_HF_DIR OUT_DIR [float32|bfloat16]", file=sys.stderr)
        return 2
    cfg = convert_hf_checkpoint(argv[0], argv[1],
                                argv[2] if len(argv) > 2 else "bfloat16")
    print(json.dumps(cfg))
    return 0


if __name__ == "__main__":
    sys.exit(main())
