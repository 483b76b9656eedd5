"""JetStreamModel: the engine behind the ``jetstream`` serving runtime.

Counterpart of ``kubeflow_tpu/serving/engine/serve.py``: plugs the engine
into the V1/V2 model server (serving/server.py) with the same request and
response shapes.

    V2 generate: {"text_input": "...", "parameters": {"max_tokens": N}}
      -> {"text_output": ..., "token_ids": [...], "tokens": N, ...}
    V1 predict:  {"instances": [{"prompt": "...", "max_tokens": 32} | "str"]}
      -> {"predictions": [{"text": ..., "tokens": N, "latency_s": ...}]}

QoS and sessions ride the generate parameters as in the JAX package:
``deadline_s``, ``priority`` (or an ``X-Priority`` header) and
``session_id`` (or an ``X-Session-Id`` header); bad values are refused with
a 400 before anything is submitted, and a session turn's response carries a
``session`` block.

Tokenization: a flat ``{token: id}`` ``tokenizer.json`` in the model dir
(greedy longest-match), else byte-level (ids 0..255).  The HF tokenizers
format, streaming, failover resume, adapters, disaggregation, the fabric,
brownout and constrained decoding come in later slices; their request
parameters are refused with a 400 rather than silently ignored.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Optional

from ...utils.device import resolve_device
from ..errors import EngineError, RequestError
from ..server import Model
from .engine import Engine, EngineConfig
from .kvstore import normalize_session_id
from .model import DecoderConfig, load_params
from .scheduler import normalize_priority

# parameters of the JAX package's generate surface that this port does not
# implement yet
_UNSUPPORTED_PARAMS = ("resume_token_ids", "adapter", "kv_handoff", "handoff",
                       "fabric", "brownout", "constrain")


def _header(headers: Optional[dict], name: str):
    """A request header's value by case-insensitive name, else None."""
    for k, v in (headers or {}).items():
        if k.lower() == name:
            return v
    return None


def _deadline(value) -> Optional[float]:
    if value is None:
        return None
    try:
        return float(value)
    except (TypeError, ValueError):
        raise RequestError(f"deadline_s must be a number, got {value!r}") from None


class ByteTokenizer:
    vocab_size = 256

    def encode(self, text: str) -> list[int]:
        return list(text.encode("utf-8", errors="replace"))

    def decode(self, ids: list[int]) -> str:
        return bytes(i % 256 for i in ids).decode("utf-8", errors="replace")


class VocabTokenizer:
    """Greedy longest-match over a {token_string: id} vocab."""

    def __init__(self, vocab: dict[str, int]):
        self.vocab = vocab
        self.inv = {i: t for t, i in vocab.items()}
        self.max_len = max(len(t) for t in vocab)
        self.vocab_size = max(vocab.values()) + 1

    def encode(self, text: str) -> list[int]:
        out, i = [], 0
        while i < len(text):
            for ln in range(min(self.max_len, len(text) - i), 0, -1):
                tid = self.vocab.get(text[i : i + ln])
                if tid is not None:
                    out.append(tid)
                    i += ln
                    break
            else:
                i += 1  # unknown char: skip
        return out

    def decode(self, ids: list[int]) -> str:
        return "".join(self.inv.get(i, "") for i in ids)


def load_tokenizer(model_dir: str):
    path = os.path.join(model_dir, "tokenizer.json")
    if model_dir and os.path.exists(path):
        with open(path) as f:
            raw = json.load(f)
        if isinstance(raw.get("model"), dict) and "type" in raw["model"]:
            raise ValueError(f"{path} is a HuggingFace tokenizers file, which "
                             "this port does not read yet")
        return VocabTokenizer(raw)
    return ByteTokenizer()


def _checkout_eos_ids(model_dir: str) -> list:
    """The checkpoint's declared end-of-sequence token ids, if any:
    generation_config.json first, else config.json; multi-EOS checkouts keep
    the WHOLE list."""
    for fname in ("generation_config.json", "config.json"):
        path = os.path.join(model_dir, fname) if model_dir else ""
        if not path or not os.path.exists(path):
            continue
        try:
            with open(path) as f:
                eos = json.load(f).get("eos_token_id")
        except (OSError, ValueError):
            continue
        if isinstance(eos, int):
            eos = [eos]
        if isinstance(eos, list):
            ids = [i for i in eos if isinstance(i, int) and i >= 0]
            if ids:
                return ids
    return []


class JetStreamModel(Model):
    """kserve-style Model serving generate() from the engine.  ``device``
    (default ``"cuda"``) is where ``load`` builds the engine when none is
    handed in."""

    def __init__(self, name: str, model_dir: str = "", engine: Optional[Engine] = None,
                 device=None):
        super().__init__(name)
        self.model_dir = model_dir
        self.engine = engine
        self.device = engine.device if engine is not None else resolve_device(device)
        self.tokenizer = load_tokenizer(model_dir)

    def load(self) -> None:
        """Build the engine from the model dir (``config.json`` +
        ``params.npz``, else the default config and random init, plus an
        optional ``engine.json``), unless one was handed in; start it."""
        if self.engine is None:
            config = DecoderConfig.from_dir(self.model_dir) or DecoderConfig()
            params = load_params(self.model_dir, config, self.device)
            ec = EngineConfig()
            eos_explicit = False
            path = os.path.join(self.model_dir, "engine.json")
            if self.model_dir and os.path.exists(path):
                with open(path) as f:
                    raw = json.load(f)
                fields = {f.name for f in dataclasses.fields(EngineConfig)}
                kw = {k: v for k, v in raw.items() if k in fields}
                if isinstance(kw.get("eos_ids"), list):  # keep config hashable
                    kw["eos_ids"] = tuple(kw["eos_ids"])
                ec = EngineConfig(**kw)
                # an operator's explicit eos_id — INCLUDING -1 "never stop
                # early" — wins over the checkout's declaration
                eos_explicit = "eos_id" in raw or "eos_ids" in raw
            if not eos_explicit:
                eos = _checkout_eos_ids(self.model_dir)
                if eos:
                    ec = dataclasses.replace(ec, eos_id=eos[0],
                                             eos_ids=tuple(eos[1:]))
            self.engine = Engine(params, config, ec, device=self.device)
        self.engine.start()
        self.ready = True

    def health(self) -> dict:
        if self.engine is None:
            return {"state": "DEAD", "reason": "no engine"}
        try:
            return self.engine.health()
        except Exception as e:  # noqa: BLE001 — a probe must answer
            return {"state": "DEAD", "reason": f"{type(e).__name__}: {e}"}

    def _parse_generate(self, payload: Any, headers: Optional[dict] = None):
        """-> (ids, max_tokens, deadline_s, priority, session_id); every
        value validated here, before anything is submitted (RequestError ->
        400).  The ``priority`` and ``session_id`` parameters win over the
        ``X-Priority`` and ``X-Session-Id`` headers."""
        prompt = payload.get("text_input", "") if isinstance(payload, dict) else str(payload)
        params = (payload.get("parameters") or {}) if isinstance(payload, dict) else {}
        if not isinstance(params, dict):
            raise RequestError(f"parameters must be an object, got {params!r}")
        unsupported = sorted(k for k in _UNSUPPORTED_PARAMS if k in params)
        if unsupported:
            raise RequestError(f"parameters {unsupported} are not supported "
                               "by this engine yet")
        try:
            max_tokens = int(params.get("max_tokens", 32))
        except (TypeError, ValueError):
            raise RequestError("max_tokens must be an integer, got "
                               f"{params.get('max_tokens')!r}") from None
        priority = params.get("priority")
        if priority is None:
            priority = _header(headers, "x-priority")
        if priority is not None:
            priority = normalize_priority(priority)
        session = params.get("session_id")
        if session is None:
            session = _header(headers, "x-session-id")
        if session is not None:
            session = normalize_session_id(session)
        return (self.tokenizer.encode(prompt) or [0], max_tokens,
                _deadline(params.get("deadline_s")), priority, session)

    def generate(self, payload: Any, headers: Optional[dict] = None) -> Any:
        """V2 generate extension (unary): {"text_input": str, "parameters":
        {"max_tokens": N, "deadline_s": S, "priority": "interactive" |
        "batch" | "best_effort", "session_id": id}} -> {"text_output": str,
        "token_ids", "tokens", "prompt_tokens", "max_tokens", "ttft_s",
        "latency_s"}, plus a ``session`` block (restore tier, pinned/durable
        flags, evictions) for a session turn."""
        ids, max_tokens, deadline, priority, session = self._parse_generate(payload, headers)
        r = self.engine.generate(ids, max_tokens, deadline=deadline,
                                 priority=priority, session_id=session)
        out = {"text_output": self.tokenizer.decode(r["tokens"]),
               "token_ids": r["tokens"],
               "tokens": r["num_tokens"],
               "prompt_tokens": len(ids), "max_tokens": max_tokens,
               "ttft_s": round(r["ttft_s"], 4),
               "latency_s": round(r["latency_s"], 4)}
        if "session" in r:
            out["session"] = r["session"]
        return out

    def predict(self, payload: Any, headers: Optional[dict] = None) -> Any:
        instances = payload.get("instances", []) if isinstance(payload, dict) else payload
        header_prio = _header(headers, "x-priority")
        # validate every instance BEFORE submitting anything: a bad value
        # mid-loop would 500 the request while earlier submissions burn slots
        parsed = []
        for inst in instances:
            if isinstance(inst, str):
                inst = {"prompt": inst}
            unsupported = sorted(k for k in _UNSUPPORTED_PARAMS if k in inst)
            if unsupported:
                raise RequestError(f"instance fields {unsupported} are not "
                                   "supported by this engine yet")
            try:
                n = int(inst.get("max_tokens", 32))
            except (TypeError, ValueError):
                raise RequestError("max_tokens must be an integer, got "
                                   f"{inst.get('max_tokens')!r}") from None
            prio = inst.get("priority")
            prio = normalize_priority(prio if prio is not None else header_prio)
            parsed.append((inst.get("prompt", ""), n, _deadline(inst.get("deadline_s")), prio))
        futures = [self.engine.generate_async(self.tokenizer.encode(p) or [0], n,
                                              deadline=d, priority=pr)
                   for p, n, d, pr in parsed]
        out = []
        for fut in futures:
            try:
                r = fut.result(timeout=300)
            except EngineError as e:
                # per-instance fault isolation: one failed instance becomes
                # an error entry; its siblings' results are still returned
                out.append({"error": f"{type(e).__name__}: {e}"})
                continue
            out.append({
                "text": self.tokenizer.decode(r["tokens"]),
                "token_ids": r["tokens"],
                "tokens": r["num_tokens"],
                "ttft_s": round(r["ttft_s"], 4),
                "latency_s": round(r["latency_s"], 4),
                "truncated": r["truncated"],
            })
        return out
