"""Multi-LoRA adapter loading for the serving engine (PEFT format).

Counterpart of ``kubeflow_tpu/serving/engine/lora.py``: loads
``model_dir/adapters/<name>/`` PEFT directories (adapter_config.json +
adapter_model.safetensors) into ONE stacked table the batched decode
consumes:

    {proj: {"A": [n_adapters+1, L, in, r], "B": [n_adapters+1, L, r, out]}}

Adapter id 0 is reserved all-zeros ("no adapter"), so a mixed batch needs
no branching: every row pays two rank-r matmuls (model._proj), and rows
without an adapter multiply by zeros.  Adapters with different ranks are
right-padded to the largest rank (zero A columns times zero B rows add
nothing).  The PEFT scale (lora_alpha / r) is folded into B at load time,
in f32, before the table is rounded to bf16 (round to nearest even, as the
JAX package rounds it): A and B are the JAX package's bits.

The JAX package reads the files with the ``safetensors`` package; the port
reads the format itself (``read_safetensors``), so it needs no package
beyond torch and numpy.
"""

from __future__ import annotations

import json
import os
import struct

import numpy as np
import torch

from ...utils.device import resolve_device

# PEFT target_modules name -> engine param name
_PROJ_MAP = {"q_proj": "wq", "k_proj": "wk", "v_proj": "wv", "o_proj": "wo",
             "gate_proj": "w1", "up_proj": "w3", "down_proj": "w2"}

# safetensors dtype tag -> (numpy dtype of the raw little-endian data,
# whether the 16-bit pattern is bfloat16)
_ST_DTYPES = {"F32": (np.dtype("<f4"), False), "F16": (np.dtype("<f2"), False),
              "BF16": (np.dtype("<i2"), True)}


def read_safetensors(path: str) -> dict:
    """A ``.safetensors`` file -> {name: float32 numpy array}.

    The format: an 8-byte little-endian header length, a JSON header
    mapping each tensor name to its ``dtype``, ``shape`` and
    ``data_offsets`` (begin, end) into the data that follows, then the raw
    little-endian data.  ``__metadata__`` is ignored.  F32, F16 and BF16
    are read (BF16 as its 16-bit pattern, widened to f32 exactly); any
    other dtype or an inconsistent header raises ValueError."""
    with open(path, "rb") as f:
        raw = f.read()
    if len(raw) < 8:
        raise ValueError(f"{path}: not a safetensors file (too short)")
    (n,) = struct.unpack("<Q", raw[:8])
    if 8 + n > len(raw):
        raise ValueError(f"{path}: header length {n} runs past the file")
    try:
        header = json.loads(raw[8:8 + n])
    except ValueError as e:
        raise ValueError(f"{path}: unreadable safetensors header: {e}") from None
    data = memoryview(raw)[8 + n:]
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dt = _ST_DTYPES.get(info.get("dtype"))
        if dt is None:
            raise ValueError(f"{path}: tensor {name!r} has unsupported dtype "
                             f"{info.get('dtype')!r} (F32, F16, BF16)")
        shape = tuple(int(d) for d in info["shape"])
        lo, hi = (int(o) for o in info["data_offsets"])
        count = int(np.prod(shape, dtype=np.int64))
        if not 0 <= lo <= hi <= len(data) or hi - lo != count * dt[0].itemsize:
            raise ValueError(f"{path}: tensor {name!r} data_offsets {lo}..{hi} "
                             f"do not fit shape {shape}")
        arr = np.frombuffer(data[lo:hi], dtype=dt[0]).reshape(shape)
        if dt[1]:  # bf16: the high half of an f32
            arr = (arr.astype(np.uint16).astype(np.uint32) << 16).view(np.float32)
        out[name] = arr.astype(np.float32)
    return out


def _read_peft_dir(path: str) -> tuple:
    """One adapter dir -> (config dict, {(proj, layer): (A [r,in], B [out,r])})."""
    with open(os.path.join(path, "adapter_config.json")) as f:
        cfg = json.load(f)
    if cfg.get("peft_type", "LORA").upper() != "LORA":
        raise ValueError(f"{path}: unsupported peft_type {cfg.get('peft_type')!r}")
    if cfg.get("use_dora") or cfg.get("use_rslora"):
        raise ValueError(f"{path}: DoRA/rsLoRA variants are not implemented — "
                         "refusing to load with silently-wrong scaling")
    if cfg.get("rank_pattern") or cfg.get("alpha_pattern"):
        # per-module rank/alpha overrides change the scale per projection;
        # applying the global alpha/r to them would be silently wrong
        raise ValueError(f"{path}: rank_pattern/alpha_pattern overrides are "
                         "not implemented — refusing to mis-scale them")
    st = os.path.join(path, "adapter_model.safetensors")
    if not os.path.exists(st):
        raise FileNotFoundError(f"{path}: adapter_model.safetensors missing")
    pairs: dict = {}
    for name, t in read_safetensors(st).items():
        # ...model.layers.{l}.self_attn.q_proj.lora_A.weight
        parts = name.split(".")
        try:
            li = parts.index("layers")
            layer = int(parts[li + 1])
            proj = parts[li + 3]
            which = parts[li + 4]  # lora_A | lora_B
        except (ValueError, IndexError):
            raise ValueError(f"{path}: unrecognized tensor name {name!r}")
        if proj not in _PROJ_MAP:
            raise ValueError(f"{path}: target module {proj!r} is not a "
                             f"decoder projection ({sorted(_PROJ_MAP)})")
        key = (_PROJ_MAP[proj], layer)
        a, b = pairs.get(key, (None, None))
        if which == "lora_A":
            a = t  # [r, in]
        elif which == "lora_B":
            b = t  # [out, r]
        else:
            raise ValueError(f"{path}: unexpected component {which!r} in {name!r}")
        pairs[key] = (a, b)
    for key, (a, b) in pairs.items():
        if a is None or b is None:
            raise ValueError(f"{path}: incomplete A/B pair for {key}")
    return cfg, pairs


def load_adapters(model_dir: str, config, device=None) -> tuple:
    """Scan ``model_dir/adapters/*/`` -> (lora_params | None, {name: id}).

    ``config``: the engine DecoderConfig (shapes to validate against).
    Ids are 1-based (0 = the reserved zero adapter); names are the
    directory names, sorted for determinism.  The table's bf16 tensors
    land on ``device`` (default ``"cuda"``)."""
    root = os.path.join(model_dir, "adapters") if model_dir else ""
    if not root or not os.path.isdir(root):
        return None, {}
    names = sorted(d for d in os.listdir(root)
                   if os.path.isdir(os.path.join(root, d)))
    if not names:
        return None, {}
    dev = resolve_device(device)

    dims = {"wq": (config.d_model, config.n_heads * config.head_dim),
            "wk": (config.d_model, config.n_kv_heads * config.head_dim),
            "wv": (config.d_model, config.n_kv_heads * config.head_dim),
            "wo": (config.n_heads * config.head_dim, config.d_model),
            "w1": (config.d_model, config.d_ff),
            "w3": (config.d_model, config.d_ff),
            "w2": (config.d_ff, config.d_model)}
    L = config.n_layers
    loaded = []  # (name, scale, pairs)
    for name in names:
        cfg, pairs = _read_peft_dir(os.path.join(root, name))
        r = int(cfg.get("r", 8))
        scale = float(cfg.get("lora_alpha", r)) / r
        for (proj, layer), (a, b) in pairs.items():
            din, dout = dims[proj]
            if layer >= L or a.shape[1] != din or b.shape[0] != dout:
                raise ValueError(
                    f"adapter {name!r}: {proj} layer {layer} shapes "
                    f"A{a.shape} B{b.shape} do not match the base model "
                    f"(in={din}, out={dout}, layers={L})")
            if a.shape[0] != r:
                # scale is alpha/r from the config; a tensor whose actual
                # rank disagrees would be applied at the wrong magnitude
                raise ValueError(
                    f"adapter {name!r}: {proj} layer {layer} has rank "
                    f"{a.shape[0]} but adapter_config.json says r={r}")
        loaded.append((name, scale, pairs))

    projs = sorted({proj for _, _, pairs in loaded for (proj, _) in pairs})
    max_r = max(a.shape[0] for _, _, pairs in loaded for (a, _) in pairs.values())
    n = len(loaded)
    out = {}
    for proj in projs:
        din, dout = dims[proj]
        A = np.zeros((n + 1, L, din, max_r), np.float32)
        B = np.zeros((n + 1, L, max_r, dout), np.float32)
        for i, (name, scale, pairs) in enumerate(loaded, start=1):
            for (p, layer), (a, b) in pairs.items():
                if p != proj:
                    continue
                r = a.shape[0]
                A[i, layer, :, :r] = a.T
                B[i, layer, :r, :] = b.T * scale  # fold alpha/r into B
        out[proj] = {"A": torch.from_numpy(A).to(torch.bfloat16).to(dev),
                     "B": torch.from_numpy(B).to(torch.bfloat16).to(dev)}
    return out, {name: i for i, (name, _, _) in enumerate(loaded, start=1)}
