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
reads the format itself (``SafetensorsFile``, one tensor at a time, which
``hf_convert`` also reads checkpoint shards with), so it needs no package
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

# safetensors dtype tag -> (numpy dtype of the raw little-endian data, the
# torch dtype it is handed out as; bf16 travels as its 16-bit pattern)
_ST_DTYPES = {"F32": (np.dtype("<f4"), torch.float32),
              "F16": (np.dtype("<f2"), torch.float16),
              "BF16": (np.dtype("<i2"), torch.bfloat16),
              "F64": (np.dtype("<f8"), torch.float64),
              "I64": (np.dtype("<i8"), torch.int64),
              "I32": (np.dtype("<i4"), torch.int32),
              "I16": (np.dtype("<i2"), torch.int16),
              "I8": (np.dtype("i1"), torch.int8),
              "U8": (np.dtype("u1"), torch.uint8),
              "BOOL": (np.dtype("?"), torch.bool)}
# what an adapter may hold
_ADAPTER_DTYPES = ("F32", "F16", "BF16")


class SafetensorsFile:
    """Per-tensor access to one ``.safetensors`` file.

    The format: an 8-byte little-endian header length, a JSON header mapping
    each tensor name to its ``dtype``, ``shape`` and ``data_offsets`` (begin,
    end) into the data that follows, then the raw little-endian data.  The
    header is parsed and checked once; ``get`` then reads one tensor with a
    seek and a read, so a multi-GB checkpoint shard never sits in host RAM
    whole.  BF16 comes back as a torch bf16 tensor through its 16-bit
    pattern, never a numpy ``bfloat16``; the other float, integer and bool
    tags as their torch dtypes.  An unknown dtype or an inconsistent header
    raises ValueError.  ``__metadata__`` is ignored."""

    def __init__(self, path: str):
        self.path = path
        size = os.path.getsize(path)
        with open(path, "rb") as f:
            head = f.read(8)
            if len(head) < 8:
                raise ValueError(f"{path}: not a safetensors file (too short)")
            (n,) = struct.unpack("<Q", head)
            if 8 + n > size:
                raise ValueError(f"{path}: header length {n} runs past the file")
            try:
                header = json.loads(f.read(n))
            except ValueError as e:
                raise ValueError(f"{path}: unreadable safetensors header: {e}") from None
        self._base = 8 + n
        self._entries = {}
        self.dtypes: dict = {}  # name -> the header's dtype tag
        for name, info in header.items():
            if name == "__metadata__":
                continue
            dt = _ST_DTYPES.get(info.get("dtype"))
            if dt is None:
                raise ValueError(f"{path}: tensor {name!r} has unsupported dtype "
                                 f"{info.get('dtype')!r} ({', '.join(_ST_DTYPES)})")
            shape = tuple(int(d) for d in info["shape"])
            lo, hi = (int(o) for o in info["data_offsets"])
            count = int(np.prod(shape, dtype=np.int64))
            if not 0 <= lo <= hi <= size - self._base or hi - lo != count * dt[0].itemsize:
                raise ValueError(f"{path}: tensor {name!r} data_offsets {lo}..{hi} "
                                 f"do not fit shape {shape}")
            self._entries[name] = (dt, shape, lo, hi)
            self.dtypes[name] = info["dtype"]

    def keys(self) -> list:
        return list(self._entries)

    def get(self, name: str) -> torch.Tensor:
        """One tensor, read from disk now, as a CPU tensor of its dtype."""
        (np_dt, torch_dt), shape, lo, hi = self._entries[name]
        arr = np.empty(shape, dtype=np_dt)
        if hi == lo:  # an empty tensor: nothing to read
            return torch.from_numpy(arr).view(torch_dt)
        with open(self.path, "rb") as f:
            f.seek(self._base + lo)
            if f.readinto(memoryview(arr.reshape(-1)).cast("B")) != hi - lo:
                raise ValueError(f"{self.path}: tensor {name!r} is truncated")
        t = torch.from_numpy(arr)
        return t.view(torch.bfloat16) if torch_dt is torch.bfloat16 else t


def read_safetensors(path: str) -> dict:
    """A ``.safetensors`` file of F32, F16 or BF16 tensors -> {name: float32
    numpy array} (BF16 widened to f32 exactly); any other dtype or an
    inconsistent header raises ValueError."""
    f = SafetensorsFile(path)
    for name in f.keys():
        if f.dtypes[name] not in _ADAPTER_DTYPES:
            raise ValueError(f"{path}: tensor {name!r} has unsupported dtype "
                             f"{f.dtypes[name]!r} (F32, F16, BF16)")
    return {name: f.get(name).float().numpy() for name in f.keys()}


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
