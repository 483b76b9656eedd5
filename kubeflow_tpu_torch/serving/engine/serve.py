"""JetStreamModel: the engine behind the ``jetstream`` serving runtime.

Counterpart of ``kubeflow_tpu/serving/engine/serve.py``: plugs the engine
into the V1/V2 model server (serving/server.py) with the same request and
response shapes.

    V2 generate: {"text_input": "...", "parameters": {"max_tokens": N}}
      -> {"text_output": ..., "token_ids": [...], "tokens": N, ...}
    V1 predict:  {"instances": [{"prompt": "...", "max_tokens": 32} | "str"]}
      -> {"predictions": [{"text": ..., "tokens": N, "latency_s": ...}]}

    V2 generate_stream: the same body -> Server-Sent Events
      {"text_output": piece}..., then {"text_output": "", "done": true,
      "tokens": N, ...}

QoS and sessions ride the generate parameters as in the JAX package:
``deadline_s``, ``priority`` (or an ``X-Priority`` header) and
``session_id`` (or an ``X-Session-Id`` header); bad values are refused with
a 400 before anything is submitted, and a session turn's response carries a
``session`` block.  ``resume_token_ids`` re-admits a request that failed
over from another replica: the ids fold into the prompt and only the
continuation is generated and returned.  A truthy ``X-Stream-Resume``
header makes every stream event carry the ``token_ids`` it covers, which is
what the ingress's failover relay reads.

Tracing rides headers as in the JAX package: an inbound ``traceparent``
(the ingress stamps one per relay) makes the engine span a child of the
relay hop, ``X-Resume-From`` (stamped on a failover re-admission) links the
failed hop, and a truthy ``X-Request-Trace`` adds the request's lifecycle
span as a ``trace`` field to the unary response or to the stream's final
event.  The engine's observability surfaces back the server's ``/metrics``
registry text (``metrics_text``) and its ``/engine/{perf, profile, trace,
incidents, waterfall, latency}`` routes.

Disaggregated serving and the fleet KV fabric ride the parameters as in
the JAX package: ``kv_handoff: true`` makes a unary request the PREFILL
phase (one token, its KV exported, a pull handle in the ``handoff``
block); ``handoff = {handle, source_port, token_ids}`` makes a request the
DECODE phase (the frame pulled over ``GET /engine/kv_handoff/<handle>`` and
imported, the full output returned); ``fabric = {key, source_port, pages}``
pulls a published prefix over ``GET /engine/kv_fabric/<key>`` before
submit.  Every pull is verified (KVPG magic, length, CRC32, geometry, chain
hashes) and any failure degrades to a re-prefill.

Structured output, brownout and LoRA ride the parameters as in the JAX
package: ``constrain`` = ``{"schema": {...}}`` | ``{"grammar": "..."}`` |
``{"format": "json"}`` | ``{"tool": {"name", "parameters"}}`` compiles at
admission (a bad spec is a 400 with the compiler's message) into a
per-request automaton, and the response carries a ``constrain`` receipt
plus the parsed ``json`` or ``tool_call`` of a valid completion (a stream
emits them as one typed event before its final record); ``brownout`` (an
integer stage in [0, 3], set by the ingress's overload controller) drops
speculation drafts from stage 2 and defers the fabric publish at stage 3;
``adapter`` names a LoRA adapter loaded from ``model_dir/adapters/``
(lora.py; an unknown name is a 400).

A model dir that holds an unconverted HuggingFace checkout (an HF
``config.json`` beside safetensors shards or ``pytorch_model*.bin``) is
converted in place on load (``hf_convert``), as the JAX package does.

Tokenization: ``tokenizer.json`` if the model dir has one — the HF
tokenizers-library format (detected by its ``{"model": {"type": ...}}``
shape; read by the port's own ``hf_tokenizer.HFTokenizer``, re-exported
here) or a flat ``{token: id}`` vocab with greedy longest-match — else
byte-level (ids 0..255).  A request parameter this port lacks would
be refused with a 400 rather than silently ignored (``_UNSUPPORTED_PARAMS``,
empty since every generate parameter of the JAX package is ported; a null
value counts as absent).  An ``engine.json`` key whose feature is not
ported is refused the same way unless it holds the JAX package's default.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import time
from typing import Any, Optional

import numpy as np
import torch

from ...core import tracing
from ...core.metrics import add_const_labels
from ...utils.device import pod_cards, resolve_device
from .. import kvfabric, transport
from ..constrain import ConstrainRegistry, GrammarError
from ..errors import EngineError, RequestError
from ..server import Model
from ..slo import SloConfig
from .engine import Engine, EngineConfig
from .faults import (ConstrainFaultConfig, FabricFaultConfig, FaultConfig,
                     HandoffFaultConfig, StorageFaultConfig)
from .hf_convert import convert_hf_checkpoint, hf_dir_needs_conversion
from .hf_tokenizer import HFTokenizer
from .kvstore import (BF16Bits, KVStoreConfig, normalize_session_id,
                      unpack_frame)
from .lora import load_adapters
from .model import DecoderConfig, load_params
from .scheduler import SchedulerConfig, normalize_priority

# parameters of the JAX package's generate surface that this port does not
# implement yet (null values count as absent); none since every one is
# ported, the mechanism kept for the slices to come
_UNSUPPORTED_PARAMS: tuple = ()

# engine.json keys of the JAX package's EngineConfig whose feature this port
# does not have yet -> (the JAX package's default, the ROADMAP item that
# brings it).  A file may name one at its default; any other value is
# refused, never dropped.  Empty since tensor parallelism landed; kept for
# the slices to come.
_UNPORTED_ENGINE_KEYS: dict = {}

# exported-KV pull handles are secrets.token_hex(16): exactly 32 hex chars.
# The decode phase interpolates them into a URL, so the shape is enforced
# at parse time (an SSRF guard); fabric keys likewise (kvfabric.KEY_RE)
_HANDOFF_HANDLE_RE = re.compile(r"[0-9a-f]{32}")
_FABRIC_KEY_RE = kvfabric.KEY_RE


def _header(headers: Optional[dict], name: str):
    """A request header's value by case-insensitive name, else None."""
    for k, v in (headers or {}).items():
        if k.lower() == name:
            return v
    return None


def _truthy_header(headers: Optional[dict], name: str) -> bool:
    v = _header(headers, name)
    return v is not None and str(v).strip().lower() not in ("", "0", "false", "no")


def _trace_ctx(headers: Optional[dict]):
    """Inbound W3C ``traceparent`` (the ingress relay stamps one per
    attempt): the engine span adopts its trace id and becomes a child of
    the relay hop.  Malformed headers mint a fresh trace instead of failing
    the request."""
    v = _header(headers, tracing.TRACEPARENT_HEADER)
    return tracing.parse_traceparent(v) if v is not None else None


def _resume_link(headers: Optional[dict]) -> Optional[list]:
    """``X-Resume-From`` (the failover relay's re-admission marker): the
    span id of the relay hop whose backend died mid-stream, linked from the
    engine span.  Anything that is not a bare span id is dropped: the header
    is client-controlled and span budgets charge links at fixed size."""
    v = _header(headers, "x-resume-from")
    if not v:
        return None
    sid = str(v).strip().lower()
    if tracing.SPAN_ID_RE.match(sid):
        return [{"type": "resumed_from", "span_id": sid}]
    return None


def _kv_leaves(part) -> list:
    """The leaves of one side of a KV blob or pool: one array, or the int8
    pool's ``{"q", "s"}`` in key order."""
    return [part[k] for k in sorted(part)] if isinstance(part, dict) else [part]


def _pool_geometry(pool) -> list:
    """``(shape, dtype name)`` of each leaf of one side of an engine's KV
    pool, the shape with the GLOBAL KV-head count: a tensor-parallel pool is
    a per-shard list, each shard holding 1/N of the heads."""
    shards = pool if isinstance(pool, list) else [pool]
    out = []
    for leaf in _kv_leaves(shards[0]):
        shape = list(leaf.shape)
        shape[2] *= len(shards)
        out.append((tuple(shape), _dtype_name(leaf)))
    return out


def _dtype_name(leaf) -> str:
    """A blob leaf's (numpy; bf16 as kvstore.BF16Bits) or a pool leaf's
    (torch) dtype, by the KVPG spec's name."""
    if isinstance(leaf, np.ndarray):
        return "bfloat16" if isinstance(leaf, BF16Bits) else str(leaf.dtype)
    return str(leaf.dtype).replace("torch.", "")


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
        with open(path, encoding="utf-8") as f:
            data = f.read()  # read once: sniff + construct from the string
        raw = json.loads(data)
        if isinstance(raw.get("model"), dict) and "type" in raw["model"]:
            return HFTokenizer(data)  # tokenizers-library format
        return VocabTokenizer(raw)  # a flat {token: id} vocab
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


def shard_devices(tensor_parallel: int) -> list:
    """One CUDA device per shard: shard ``i`` runs on the card of the
    ``i``-th entry of ``utils.device.pod_cards()``, which torch numbers by
    that entry's first place among the distinct entries (``"0,1"`` ->
    ``cuda:0, cuda:1``; ``"0,0"`` -> both shards on ``cuda:0``).  Raises
    with fewer cards than shards."""
    cards = pod_cards()
    if len(cards) < tensor_parallel:
        raise ValueError(f"tensor_parallel={tensor_parallel} needs {tensor_parallel} "
                         f"devices, have {len(cards)}")
    distinct = list(dict.fromkeys(cards))
    return [torch.device("cuda", distinct.index(c)) for c in cards[:tensor_parallel]]


def _engine_config(path: str, config: DecoderConfig, device: torch.device) -> tuple:
    """An ``engine.json`` -> ``(EngineConfig, raw dict)``, its blocks built into
    their config classes and its keys validated as the JAX package's
    ``JetStreamModel.load`` does, every message naming the file.  A key of
    neither package's EngineConfig is dropped, as the JAX package drops it;
    an unported key off its default raises ValueError.  ``tensor_parallel``
    is checked against ``config`` and, on a CUDA ``device``, against the
    cards the pod holds (``pod_cards()``: the entries of its
    ``CUDA_VISIBLE_DEVICES``, else ``torch.cuda.device_count()``): a pod
    with fewer cards than shards refuses the file, as the JAX package
    refuses with fewer devices.  On the CPU any number of shards may share
    it."""
    with open(path) as f:
        raw = json.load(f)
    fields = {f.name for f in dataclasses.fields(EngineConfig)}
    kw = {k: v for k, v in raw.items() if k in fields}
    if isinstance(kw.get("eos_ids"), list):  # keep config hashable
        kw["eos_ids"] = tuple(kw["eos_ids"])
    if isinstance(kw.get("scheduler"), dict):
        # adapter_weights arrives as a JSON list of [name, weight] pairs
        skw = dict(kw["scheduler"])
        if isinstance(skw.get("adapter_weights"), list):
            skw["adapter_weights"] = tuple((str(n), float(w))
                                           for n, w in skw["adapter_weights"])
        kw["scheduler"] = SchedulerConfig(**skw)
    if isinstance(kw.get("kv_store"), dict):
        # disk_dir on a persistent volume keeps pinned sessions across
        # restarts
        kkw = dict(kw["kv_store"])
        if isinstance(kkw.get("chaos"), dict):
            kkw["chaos"] = StorageFaultConfig(**kkw["chaos"])
        kw["kv_store"] = KVStoreConfig(**kkw)
    if isinstance(kw.get("chaos"), dict):
        # a chaos-under-load soak straight from an engine.json
        ckw = dict(kw["chaos"])
        if isinstance(ckw.get("target_rids"), list):
            ckw["target_rids"] = tuple(ckw["target_rids"])
        kw["chaos"] = FaultConfig(**ckw)
    if isinstance(kw.get("slo"), dict):
        # per-class SLO targets (the attainment/burn-rate gauges)
        kw["slo"] = SloConfig.from_json(kw["slo"])
    if isinstance(kw.get("constrain_chaos"), dict):
        # structured-output chaos: cache corruption must degrade to a
        # counted re-compile, stalls to a failed slot — never an invalid
        # output
        kw["constrain_chaos"] = ConstrainFaultConfig(**kw["constrain_chaos"])
    for key, cls in (("handoff_chaos", HandoffFaultConfig),
                     ("fabric_chaos", FabricFaultConfig)):
        if isinstance(kw.get(key), dict):
            # disaggregation and fabric chaos straight from an engine.json,
            # the shard_* sub-frame injectors included
            kw[key] = cls(**kw[key])
    ec = EngineConfig(**kw)
    # disaggregation role: validated HERE with a config-level message, so a
    # pod that crash-loops on a bad engine.json says which key to fix
    if ec.role not in ("prefill", "decode", "unified"):
        raise ValueError(f"{path}: role={ec.role!r} must be one of "
                         "\"prefill\" | \"decode\" | \"unified\"")
    if ec.speculative is not None:
        if ec.speculative != "prompt_lookup":
            raise ValueError(f"{path}: speculative={ec.speculative!r} is not "
                             "supported (only \"prompt_lookup\")")
        if ec.temperature > 0:
            raise ValueError(
                f"{path}: speculative=\"prompt_lookup\" requires "
                f"temperature 0, got {ec.temperature} — greedy acceptance is "
                "what makes speculative decoding lossless")
        if ec.spec_max_draft < 1 or ec.spec_ngram < 1:
            raise ValueError(f"{path}: spec_max_draft and spec_ngram must be "
                             f">= 1 (got {ec.spec_max_draft}, {ec.spec_ngram})")
    # tensor parallelism: validated HERE with a config-level message (the
    # engine and sharding.py raise too, but name no file)
    tp = ec.tensor_parallel
    if not isinstance(tp, int) or tp < 1:
        raise ValueError(f"{path}: tensor_parallel={tp!r} must be an integer >= 1")
    if tp > 1:
        if config.n_kv_heads % tp or config.n_heads % tp:
            raise ValueError(
                f"{path}: tensor_parallel={tp} must divide "
                f"n_heads={config.n_heads} and n_kv_heads={config.n_kv_heads}")
        if config.d_ff % tp:
            raise ValueError(f"{path}: tensor_parallel={tp} must divide "
                             f"d_ff={config.d_ff}")
        have = len(pod_cards()) if device.type == "cuda" else tp
        if have < tp:
            raise ValueError(
                f"{path}: tensor_parallel={tp} needs {tp} devices, have {have} "
                "— refusing to silently serve at a lower degree")
    for key in sorted(raw):
        if key not in _UNPORTED_ENGINE_KEYS:
            continue
        default, item = _UNPORTED_ENGINE_KEYS[key]
        if raw[key] != default:
            raise ValueError(
                f"{path}: {key}={raw[key]!r} is not supported by this port yet "
                f"(only the default {default!r}; ROADMAP item {item} brings it)"
                " — refusing to silently serve without it")
    return ec, raw


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
        # structured output: spec -> automaton compilation is memoized
        # here, built lazily so unconstrained deployments never pay the
        # vocabulary walk
        self._constrain_reg: Optional[ConstrainRegistry] = None
        if engine is not None:
            self._wire_fabric(engine)

    def _wire_fabric(self, engine: Engine) -> None:
        """Give the engine the tokenizer-aware fingerprint function its
        fabric publishes carry (token prefix -> decoded text ->
        kvfabric.fingerprints, which the router recomputes from any request
        body) and this model's name as the frames' model identity."""
        tok = self.tokenizer

        def fingerprint(token_ids):
            try:
                return kvfabric.fingerprints(tok.decode(list(token_ids)))
            except Exception:  # noqa: BLE001 — a publish must not fail
                return []

        engine.fabric_fingerprinter = fingerprint
        engine.fabric_model_id = self.name

    def load(self) -> None:
        """Build the engine from the model dir (``config.json`` +
        ``params.npz``, else the default config and random init, an
        optional ``engine.json`` and the PEFT adapters under
        ``adapters/``), unless one was handed in; start it.  An unconverted
        HuggingFace checkout is converted in place first."""
        if self.engine is None:
            if self.model_dir and hf_dir_needs_conversion(self.model_dir):
                # storage_uri pointed at a raw HuggingFace checkout: convert
                # its weights into engine params in place, next to the
                # originals (model_dir is the pod-local copy)
                convert_hf_checkpoint(self.model_dir, self.model_dir)
            config = DecoderConfig.from_dir(self.model_dir) or DecoderConfig()
            ec = EngineConfig()
            eos_explicit = False
            path = os.path.join(self.model_dir, "engine.json")
            if self.model_dir and os.path.exists(path):
                # validated before the weights load: a bad file fails fast
                ec, raw = _engine_config(path, config, self.device)
                # an operator's explicit eos_id — INCLUDING -1 "never stop
                # early" — wins over the checkout's declaration
                eos_explicit = "eos_id" in raw or "eos_ids" in raw
            if not eos_explicit:
                eos = _checkout_eos_ids(self.model_dir)
                if eos:
                    ec = dataclasses.replace(ec, eos_id=eos[0],
                                             eos_ids=tuple(eos[1:]))
            params = load_params(self.model_dir, config, self.device)
            lora_params, adapter_ids = load_adapters(self.model_dir, config, self.device)
            lora = (lora_params, adapter_ids) if lora_params is not None else None
            # at tensor_parallel N on the card: one shard per card of the pod
            device = (shard_devices(ec.tensor_parallel)
                      if ec.tensor_parallel > 1 and self.device.type == "cuda" else self.device)
            self.engine = Engine(params, config, ec, device=device, lora=lora)
            self._wire_fabric(self.engine)
        self.engine.start()
        self.ready = True

    @property
    def adapters(self) -> dict:
        """Loaded LoRA adapter names -> ids (each is also served as its own
        OpenAI model id)."""
        return self.engine.adapters if self.engine is not None else {}

    def health(self) -> dict:
        if self.engine is None:
            return {"state": "DEAD", "reason": "no engine"}
        try:
            return self.engine.health()
        except Exception as e:  # noqa: BLE001 — a probe must answer
            return {"state": "DEAD", "reason": f"{type(e).__name__}: {e}"}

    def extra_metrics(self) -> dict:
        """Per-replica engine state, under the JAX package's gauge names:
        the ingress's least-loaded pick reads ``engine_queue_depth`` +
        ``engine_active_slots``, the autoscaler the backlog."""
        if self.engine is None:
            return {}
        try:
            s = self.engine.stats
        except RuntimeError:  # engine stopped
            return {}
        health = self.engine.health()
        return {
            "engine_active_slots": s["active_slots"],
            "engine_queue_depth": s["queue_depth"],
            "engine_free_pages": s["free_pages"],
            "engine_cached_pages": s["cached_pages"],
            "engine_page_hits": s["page_hits"],
            # /metrics renders floats: health is a 1/0 gauge here
            "engine_serving": 1.0 if health["state"] == "SERVING" else 0.0,
            "engine_ticks_failed": s["ticks_failed"],
            "engine_requests_shed": s["requests_shed"],
            "engine_requests_rejected": s["requests_rejected"],
            "engine_restarts": s["restarts"],
            "engine_preemptions": s["preemptions"],
            "engine_swap_used_bytes": s["swap_used_bytes"],
            "engine_kv_host_used_bytes": s["kv_host_used_bytes"],
            "engine_kv_disk_used_bytes": s["kv_disk_used_bytes"],
            "engine_kv_verify_failures": s["kv_verify_failures"],
            "engine_sessions_pinned": s["sessions_pinned"],
            "engine_session_evictions": s["session_evictions"],
        }

    def metrics_text(self) -> str:
        """The engine's telemetry registry in Prometheus text format —
        TTFT/TPOT/queue-wait/tick-duration histograms, prefill-batch-size,
        KV-page gauges — appended to the server's /metrics after the load
        gauges, every sample labelled ``model="<name>"`` so two engines in
        one server render distinct series.  Occupancy, health, SLO,
        incident and perf gauges are refreshed here, at scrape time."""
        if self.engine is None:
            return ""
        eng = self.engine
        try:
            s = eng.stats
            eng.telemetry.set_kv_pages(s["free_pages"], s.get("cached_pages", 0),
                                       eng.ec.num_pages - 1)  # page 0 is trash
            eng.telemetry.set_kv_store_bytes(s["kv_host_used_bytes"],
                                             s["kv_disk_used_bytes"])
            eng.telemetry.set_health(eng.health()["state"])
            eng.telemetry.refresh_slo()
            eng.telemetry.set_incidents_open(eng.incident_open_count())
            eng.refresh_perf_metrics()
        except RuntimeError:  # engine stopped
            return ""
        return add_const_labels(eng.telemetry.render(), {"model": self.name})

    def perf_snapshot(self) -> dict:
        """The engine's performance-introspection snapshot (``GET
        /engine/perf``); ``{"enabled": False}`` once the engine is gone: a
        perf read must never 500 a replica."""
        if self.engine is None:
            return {"enabled": False}
        try:
            return self.engine.perf_snapshot()
        except Exception:  # noqa: BLE001 — introspection must answer
            return {"enabled": False}

    def start_profile(self, ticks: int, trace_dir: Optional[str] = None) -> dict:
        """Arm an on-demand torch.profiler capture of the next ``ticks``
        live engine work ticks (``POST /engine/profile``).  Raises
        RuntimeError (-> 409) while a capture is in flight and RequestError
        (-> 400) on a bad tick count."""
        if self.engine is None:
            raise RuntimeError("no engine to profile")
        try:
            d = self.engine.trace_n_ticks(int(ticks), trace_dir)
        except ValueError as e:
            raise RequestError(str(e)) from e
        return {"dir": d, "ticks": int(ticks), "started": True}

    def trace_spans(self, trace_id: str) -> dict:
        """Engine spans + flight-dump references for one distributed trace
        id — the replica-local half of ``GET /engine/trace/<id>``."""
        if self.engine is None:
            return {"trace_id": trace_id, "spans": [], "flight_dumps": []}
        try:
            return self.engine.trace_by_id(trace_id)
        except Exception:  # noqa: BLE001 — a debug read must answer
            return {"trace_id": trace_id, "spans": [], "flight_dumps": []}

    def incident_list(self) -> list:
        """Classified incidents of this engine's incident plane (``GET
        /engine/incidents``); empty when the plane is off."""
        if self.engine is None:
            return []
        try:
            return self.engine.incident_list()
        except Exception:  # noqa: BLE001 — a debug read must answer
            return []

    def incident_get(self, incident_id: str):
        """One incident by id (``GET /engine/incidents/<id>``); None when
        unknown here."""
        if self.engine is None:
            return None
        try:
            return self.engine.incident_get(incident_id)
        except Exception:  # noqa: BLE001 — a debug read must answer
            return None

    def waterfall(self, rid):
        """Latency waterfall for one engine request id (``GET
        /engine/waterfall/<rid>``); None when unknown here."""
        if self.engine is None:
            return None
        try:
            return self.engine.waterfall(int(rid))
        except Exception:  # noqa: BLE001 — a debug read must answer
            return None

    def latency_budget(self) -> dict:
        """Per-SLO-class latency budget samples from this replica's trace
        ring (``GET /engine/latency``)."""
        if self.engine is None:
            return {"classes": {}, "samples": {}}
        try:
            return self.engine.latency_budget()
        except Exception:  # noqa: BLE001 — a debug read must answer
            return {"classes": {}, "samples": {}}

    def _parse_generate(self, payload: Any, headers: Optional[dict] = None):
        """-> (ids, max_tokens, deadline_s, priority, resume_token_ids,
        session_id, adapter); every value validated here, before anything
        is submitted (RequestError -> 400; an unknown adapter is refused by
        the engine at submit, before anything is queued).  The ``priority``
        and ``session_id`` parameters win over the ``X-Priority`` and
        ``X-Session-Id`` headers."""
        prompt = payload.get("text_input", "") if isinstance(payload, dict) else str(payload)
        params = (payload.get("parameters") or {}) if isinstance(payload, dict) else {}
        if not isinstance(params, dict):
            raise RequestError(f"parameters must be an object, got {params!r}")
        unsupported = sorted(k for k in _UNSUPPORTED_PARAMS if params.get(k) is not None)
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
        # failover re-admission: token ids an earlier replica already
        # generated fold into the prompt, so generation resumes after them
        resume = params.get("resume_token_ids")
        if resume is not None:
            if (not isinstance(resume, list)
                    or not all(isinstance(i, int) and i >= 0 for i in resume)):
                raise RequestError("resume_token_ids must be a list of "
                                   "non-negative token ids, got "
                                   f"{resume!r}")
            resume = list(resume)
        session = params.get("session_id")
        if session is None:
            session = _header(headers, "x-session-id")
        if session is not None:
            session = normalize_session_id(session)
        return (self.tokenizer.encode(prompt) or [0], max_tokens,
                _deadline(params.get("deadline_s")), priority, resume or [], session,
                params.get("adapter"))

    @staticmethod
    def _parse_brownout(payload: Any) -> int:
        """The ingress brownout stage -> ``parameters.brownout`` (or, on the
        V1 predict and OpenAI bodies, the top-level ``brownout``) as an int
        in [0, 3].  Raises RequestError (-> 400) on anything else: a
        malformed stage must not silently serve at full quality mid-storm,
        and ``true`` is refused although bool subclasses int."""
        params = (payload.get("parameters") or {}) if isinstance(payload, dict) else {}
        if not isinstance(params, dict):
            return 0
        stage = params.get("brownout")
        if stage is None and isinstance(payload, dict):
            stage = payload.get("brownout")
        if stage is None:
            return 0
        if isinstance(stage, bool) or not isinstance(stage, int) or not 0 <= stage <= 3:
            raise RequestError(f"brownout must be an integer stage in [0, 3], "
                               f"got {stage!r}")
        return stage

    # -------------------------------------------------- structured output
    # parameters.constrain = {"schema": {...}} | {"grammar": "..."} |
    # {"format": "json"} | {"tool": {name, parameters}} compiles HERE, at
    # admission: a bad schema is a 400 with the compiler's message, never
    # an engine-side fault

    def _constrain_registry(self) -> ConstrainRegistry:
        if self._constrain_reg is None:
            cache = os.path.join(self.model_dir, ".constrain") if self.model_dir else None
            # the ENGINE owns the chaos plane: the registry consults the
            # same injector, so corrupt-cache faults show in its counts
            chaos = getattr(self.engine, "_constrain_chaos", None)
            self._constrain_reg = ConstrainRegistry(cache_dir=cache, chaos=chaos)
        return self._constrain_reg

    def _build_constraint(self, spec):
        """Compile + tokenizer-map one request's spec (both memoized) into a
        fresh automaton.  RequestError (-> 400) on any compile problem; a
        corrupt token-map cache is a counted ``recompile``, never a fault."""
        reg = self._constrain_registry()
        before = reg.stats()["table_cache_recompiles"]
        try:
            c = reg.constraint(spec, self.tokenizer)
        except GrammarError as e:
            raise RequestError(str(e)) from None
        tel = getattr(self.engine, "telemetry", None)
        if tel is not None:
            for _ in range(reg.stats()["table_cache_recompiles"] - before):
                tel.count_constrain("recompile")
        return c

    def _parse_constrain(self, payload: Any):
        params = (payload.get("parameters") or {}) if isinstance(payload, dict) else {}
        if not isinstance(params, dict) or params.get("constrain") is None:
            return None
        return self._build_constraint(params["constrain"])

    @staticmethod
    def _structured_fields(rec: dict, text: str) -> dict:
        """The parsed payload a grammar-valid completion earns: ``json`` for
        the schema and json kinds, ``tool_call`` for the tool kind.  Empty
        for a truncated output (a legal PREFIX is not a sentence, and a
        client must see the difference)."""
        if not isinstance(rec, dict) or rec.get("outcome") != "valid":
            return {}
        kind = rec.get("kind")
        if kind in ("schema", "json"):
            try:
                return {"json": json.loads(text)}
            except ValueError:
                return {}
        if kind == "tool":
            try:
                return {"tool_call": {"name": rec.get("tool"),
                                      "arguments": json.loads(text)}}
            except ValueError:
                return {}
        return {}

    @staticmethod
    def _parse_disagg_params(params: dict):
        """Disaggregation phase markers -> ``(kv_handoff, handoff)``:
        ``parameters.kv_handoff`` marks the PREFILL phase (one token, the KV
        exported, a pull handle returned); ``parameters.handoff = {handle,
        source_port, token_ids}`` marks the DECODE phase (pull + import the
        pages, decode the continuation, return the FULL output — the first
        token's text never reached the client, unlike a failover resume).
        Raises RequestError (-> 400) on malformed blocks."""
        kv_handoff = bool(params.get("kv_handoff"))
        hand = params.get("handoff")
        if hand is None:
            return kv_handoff, None
        if not isinstance(hand, dict):
            raise RequestError(f"handoff must be an object, got {hand!r}")
        ids = hand.get("token_ids")
        if (not isinstance(ids, list) or not ids
                or not all(isinstance(i, int) and i >= 0 for i in ids)):
            raise RequestError("handoff.token_ids must be a non-empty list of "
                               f"non-negative token ids, got {ids!r}")
        handle = hand.get("handle")
        if handle is not None and (not isinstance(handle, str)
                                   or not _HANDOFF_HANDLE_RE.fullmatch(handle)):
            # handles are secrets.token_hex(16); anything else is forged,
            # and it is interpolated into a localhost URL (SSRF guard)
            raise RequestError(f"handoff.handle must be a 32-char hex "
                               f"token, got {handle!r}")
        port = hand.get("source_port")
        if port is not None and (not isinstance(port, int) or not 0 < port < 65536):
            raise RequestError(f"handoff.source_port must be a port "
                               f"number, got {port!r}")
        out = {"handle": handle, "source_port": port,
               "token_ids": [int(i) for i in ids]}
        for k in ("phase_ttft_s", "phase_latency_s"):
            try:
                out[k] = max(0.0, float(hand.get(k) or 0.0))
            except (TypeError, ValueError):
                out[k] = 0.0
        return kv_handoff, out

    @staticmethod
    def _parse_fabric_params(params: dict):
        """Fleet-fabric pull hint -> ``parameters.fabric = {key, source_port,
        pages}`` or None (the router injects it when placement lands a
        request away from its prefix's owner).  Raises RequestError (-> 400)
        on malformed blocks: the key and port interpolate into a localhost
        URL, so their shape is the SSRF guard."""
        fab = params.get("fabric")
        if fab is None:
            return None
        if not isinstance(fab, dict):
            raise RequestError(f"fabric must be an object, got {fab!r}")
        key = fab.get("key")
        if not isinstance(key, str) or not _FABRIC_KEY_RE.fullmatch(key):
            raise RequestError(f"fabric.key must be a 16-char hex chain "
                               f"hash, got {key!r}")
        port = fab.get("source_port")
        if not isinstance(port, int) or not 0 < port < 65536:
            raise RequestError(f"fabric.source_port must be a port "
                               f"number, got {port!r}")
        try:
            pages = int(fab.get("pages") or 0)
        except (TypeError, ValueError):
            pages = 0
        return {"key": key, "source_port": port, "pages": pages}

    def _parse_all(self, payload: Any, headers: Optional[dict]):
        """``_parse_generate`` plus the disaggregation and fabric blocks, the
        brownout stage (counted here) and the compiled constraint, with the
        JAX package's composition rules (RequestError -> 400).  Returns
        ``(parsed, kv_handoff, handoff, fabric, brownout, constrain)``."""
        parsed = self._parse_generate(payload, headers)  # params is a dict now
        params = (payload.get("parameters") or {}) if isinstance(payload, dict) else {}
        kv_handoff, hand = self._parse_disagg_params(params)
        fab = self._parse_fabric_params(params)
        brownout = self._parse_brownout(payload)
        constrain = self._parse_constrain(payload)
        if brownout:
            self.engine.telemetry.count_brownout(brownout)
        if constrain is not None:
            if kv_handoff or hand is not None:
                # the automaton would have to ride the KV handoff between
                # replicas: refuse rather than serve an unconstrained
                # decode phase
                raise RequestError("constrain does not compose with "
                                   "disaggregated phases (kv_handoff/handoff)")
            if parsed[4]:
                raise RequestError("constrain and resume_token_ids are mutually "
                                   "exclusive — resumed tokens never advanced "
                                   "this automaton")
        if fab is not None and hand is not None:
            # a decode phase imports the FULL prompt KV; a prefix pull on
            # top is contradictory
            raise RequestError("fabric and handoff are mutually exclusive")
        return parsed, kv_handoff, hand, fab, brownout, constrain

    def generate(self, payload: Any, headers: Optional[dict] = None) -> Any:
        """V2 generate extension (unary): {"text_input": str, "parameters":
        {"max_tokens": N, "deadline_s": S, "priority": "interactive" |
        "batch" | "best_effort", "session_id": id, "resume_token_ids":
        [...], "kv_handoff": bool, "handoff": {...}, "fabric": {...},
        "adapter": name, "brownout": stage, "constrain": spec}} ->
        {"text_output": str, "token_ids", "tokens", "prompt_tokens",
        "max_tokens", "ttft_s", "latency_s"}, plus a ``session`` block
        (restore tier, pinned/durable flags, evictions) for a session turn,
        a ``fabric`` block after a fabric pull, and a ``constrain`` receipt
        (with ``json`` or ``tool_call`` when valid).  A resumed request
        returns the continuation only; its ``tokens`` counts the resumed ids
        too.  ``kv_handoff`` answers with the prefill phase's record
        (``_prefill_phase``)."""
        ((ids, max_tokens, deadline, priority, resume, session, adapter),
         kv_handoff, hand, fab, brownout, constrain) = self._parse_all(payload, headers)
        if kv_handoff:
            if session is not None or resume or hand is not None:
                raise RequestError("kv_handoff composes with none of session_id, "
                                   "resume_token_ids or handoff")
            return self._prefill_phase(ids, max_tokens, deadline, priority, headers,
                                       fab=fab, adapter=adapter, brownout=brownout)
        if hand is not None:
            if resume:
                raise RequestError("handoff and resume_token_ids are mutually exclusive")
            return self._decode_phase_unary(ids, max_tokens, deadline, priority,
                                            session, hand, headers, adapter=adapter,
                                            brownout=brownout)
        max_new = max_tokens - len(resume)
        if resume and max_new <= 0:
            # the run was already complete when the failover happened
            return {"text_output": "", "token_ids": [],
                    "tokens": len(resume), "prompt_tokens": len(ids),
                    "max_tokens": max_tokens, "ttft_s": 0.0, "latency_s": 0.0}
        # the pull sits on the client's critical path: its wall time joins
        # the reported TTFT and latency
        fimp, pull_s = self._timed_fabric_import(fab, adapter)
        r = self.engine.generate(ids + resume, max_new, deadline=deadline,
                                 priority=priority, session_id=session,
                                 fabric_import=fimp, adapter=adapter,
                                 brownout=brownout, constrain=constrain,
                                 trace=_trace_ctx(headers),
                                 links=_resume_link(headers),
                                 pre_hints={"fabric_pull": pull_s} if pull_s > 0 else None,
                                 # a failover re-admission re-prefills tokens
                                 # the dead replica already produced, and a
                                 # degraded pull recomputes the prefix: waste
                                 waste_hint=self._waste_hint(resume, fab, fimp))
        if resume:
            # the seam slices at the STABLE prefix of the resumed text: the
            # resumed ids may end mid-UTF-8 sequence, whose completed
            # decoding spans another char count than its U+FFFD
            # placeholders (the stream's rule, _stable_len)
            text = self.tokenizer.decode(resume + r["tokens"])[
                self._stable_len(self.tokenizer.decode(resume)):]
        else:
            text = self.tokenizer.decode(r["tokens"])
        out = {"text_output": text,
               "token_ids": r["tokens"],
               "tokens": r["num_tokens"] + len(resume),
               "prompt_tokens": len(ids), "max_tokens": max_tokens,
               "ttft_s": round(pull_s + r["ttft_s"], 4),
               "latency_s": round(pull_s + r["latency_s"], 4)}
        if "constrain" in r:
            out["constrain"] = r["constrain"]
            out.update(self._structured_fields(r["constrain"], out["text_output"]))
        if "session" in r:
            out["session"] = r["session"]
        if "fabric" in r:
            out["fabric"] = r["fabric"]
        elif fab is not None and fimp is None:
            # the pull itself degraded, before submit
            out["fabric"] = {"restore": "degraded"}
        if _truthy_header(headers, "x-request-trace"):
            out["trace"] = self.engine.trace(r["rid"])
        return out

    @staticmethod
    def _waste_hint(resume: list, fab, fimp) -> Optional[str]:
        if resume:
            return "failover_reprefill"
        if fab is not None and fimp is None:
            return "fabric_degraded"
        return None

    def _timed_fabric_import(self, fab, adapter=None) -> tuple:
        """``(fabric_import or None, pull wall seconds)``; no hint: (None, 0)."""
        if fab is None:
            return None, 0.0
        t_pull = time.perf_counter()
        fimp = self._fabric_import(fab, adapter)
        return fimp, time.perf_counter() - t_pull

    def _adapter_id(self, adapter) -> int:
        """The engine's id of a LoRA adapter name (0 = the base model): the
        ``adapter_id`` an imported frame's meta must carry."""
        return self.engine.adapters.get(adapter, 0) if adapter is not None else 0

    # -------------------------------- disaggregated prefill/decode phases
    # The service proxy splits an eligible request into a unary PREFILL phase
    # on a prefill-role replica and a DECODE phase, carrying the pull handle,
    # on a decode replica.  Every handoff problem degrades to a plain
    # re-prefill; under greedy decoding that re-derives the same tokens.

    _HANDOFF_PULL_TIMEOUT_S = 10.0

    def _prefill_phase(self, ids: list, max_tokens: int, deadline, priority,
                       headers, fab=None, adapter=None, brownout: int = 0) -> dict:
        """``parameters.kv_handoff: true``: prefill the prompt, sample exactly
        the first token a unified engine would, export the committed KV
        pages, and answer with the token and the one-shot pull handle.
        ``complete`` tells the proxy no decode phase is needed (EOS on the
        first token, or max_tokens == 1).  A fabric hint composes: its pull
        time joins this phase's TTFT (this phase IS the request's TTFT)."""
        fimp, pull_s = self._timed_fabric_import(fab, adapter)
        r = self.engine.generate(ids, 1, deadline=deadline, priority=priority,
                                 handoff=True, fabric_import=fimp,
                                 adapter=adapter, brownout=brownout,
                                 trace=_trace_ctx(headers),
                                 links=_resume_link(headers),
                                 pre_hints={"fabric_pull": pull_s} if pull_s > 0 else None,
                                 waste_hint=self._waste_hint([], fab, fimp))
        toks = r["tokens"]
        complete = bool(toks and toks[-1] in self.engine._stop_ids) or max_tokens <= len(toks)
        out = {"token_ids": toks, "prompt_tokens": len(ids),
               "max_tokens": max_tokens, "complete": complete,
               "ttft_s": round(pull_s + r["ttft_s"], 4),
               "latency_s": round(pull_s + r["latency_s"], 4)}
        if "handoff" in r:
            out["handoff"] = dict(r["handoff"])
            if complete and out["handoff"].get("handle"):
                # the generation finished on its only token: nobody will
                # pull this frame, so its bytes go now, not at TTL expiry
                self.engine.drop_handoff(out["handoff"].pop("handle"))
        if _truthy_header(headers, "x-request-trace"):
            out["trace"] = self.engine.trace(r["rid"])
        return out

    def _handoff_import(self, hand: dict, adapter=None):
        """Pull + verify the prefill replica's exported KV frame ->
        ``(blob, nbytes, resume_len)`` for ``Engine.generate(kv_import=)``,
        or None (degrade to re-prefill) on ANY problem: a missing handle, an
        unreachable, slow or dead source, a torn transfer (KVPG magic /
        length), a bit flip (CRC32), a geometry, adapter or dtype mismatch
        with this engine's pools."""
        tele = self.engine.telemetry
        handle, port = hand.get("handle"), hand.get("source_port")
        if not handle or not port:
            tele.count_handoff("degraded")
            return None
        chaos = self.engine._handoff_chaos
        try:
            # pooled keepalive pull: KVPG frames ride persistent sockets
            data = transport.get(int(port), f"/engine/kv_handoff/{handle}",
                                 timeout=self._HANDOFF_PULL_TIMEOUT_S)
            if chaos is not None:
                data = chaos.on_pull(data)  # may truncate, sleep or raise
            blob, header = unpack_frame(data)
        except Exception:  # noqa: BLE001 — torn/flipped (KVStoreCorrupt),
            tele.count_handoff("degraded")  # dead link, 404, timeout
            return None
        try:
            meta = header.get("meta") or {}
            ec = self.engine.ec
            resume_len = int(meta.get("resume_len") or 0)
            pages = -(-resume_len // ec.page_size)
            if (meta.get("page_size") != ec.page_size or resume_len < 2
                    or int(meta.get("adapter_id") or 0) != self._adapter_id(adapter)):
                raise ValueError("handoff meta mismatch")
            # a legitimate export covers pages or pages-1 (the boundary
            # prompt whose finishing commit granted no next page); anything
            # SHORTER would decode silently from garbage KV
            self._verify_kv_layout(blob, meta, max(1, pages - 1), pages)
        except Exception:  # noqa: BLE001 — degrade, never fail
            tele.count_handoff("degraded")
            return None
        return blob, int(header.get("nbytes") or 0), resume_len

    def _verify_kv_layout(self, blob, meta: dict, min_pages: int, max_pages: int) -> None:
        """The degree-aware KV frame geometry gate of the handoff and fabric
        importers.  A version-2 frame arrives as a LIST of per-shard ``(k,
        v)`` pairs, a version-1 frame as one pair.  Every shard must carry
        1/degree of this engine's KV heads (the FRAME's degree, which must
        equal its declared ``tp``) and match the pools in every other dim
        but the page count (which must lie in [min_pages, max_pages]) and
        in dtype: a frame of this engine's degree scatters shard to shard,
        one of another degree is resharded on the host (the engine's
        counted slow path), and anything else is refused here.  Raises
        ValueError."""
        shards = blob if isinstance(blob, list) else [blob]
        degree = len(shards)
        if int(meta.get("tp") or 1) != degree:
            raise ValueError(f"frame degree {degree} != declared tp {meta.get('tp')}")
        for shard in shards:
            if not (isinstance(shard, tuple) and len(shard) == 2):
                raise ValueError("frame blob is not a (k, v) pair")
            for side, pool in ((shard[0], self.engine.k_pool),
                               (shard[1], self.engine.v_pool)):
                bl, pl = _kv_leaves(side), _pool_geometry(pool)
                if len(bl) != len(pl):
                    raise ValueError("frame blob leaf-count mismatch")
                for b, (shape, dtype) in zip(bl, pl):
                    # each shard carries 1/degree of the kv-head axis (2)
                    if (b.ndim != len(shape) or b.shape[0] != shape[0]
                            or b.shape[2] * degree != shape[2]
                            or tuple(b.shape[3:]) != tuple(shape[3:])
                            or _dtype_name(b) != dtype
                            or not min_pages <= b.shape[1] <= max_pages):
                        raise ValueError(f"frame leaf {tuple(b.shape)}/{_dtype_name(b)} "
                                         f"(degree {degree}) does not fit pool "
                                         f"{shape}/{dtype}")

    _FABRIC_PULL_TIMEOUT_S = 5.0

    def _fabric_import(self, fab: dict, adapter=None):
        """Pull + verify a remote replica's published prefix frame ->
        ``(blob, hashes, nbytes)`` for ``Engine.generate(fabric_import=)``,
        or None (degrade to re-prefill) on ANY problem: an unreachable,
        slow (past the budget, fetch and verify together) or dead owner, a
        torn transfer, a bit flip, a geometry or model mismatch, missing
        chain hashes.  The engine re-checks the chain hashes against the
        actual prompt before scattering a page."""
        tele = self.engine.telemetry
        chaos = self.engine._fabric_chaos
        t0 = time.perf_counter()
        try:
            data = transport.get(int(fab["source_port"]),
                                 f"/engine/kv_fabric/{fab['key']}",
                                 timeout=self._FABRIC_PULL_TIMEOUT_S)
            if chaos is not None:
                data = chaos.on_pull(data)  # may truncate/flip/sleep/raise
            blob, header = unpack_frame(data)
            if time.perf_counter() - t0 > self._FABRIC_PULL_TIMEOUT_S:
                # a chronically slow link must not hold admission hostage
                # for a prefix the tail prefill could have recomputed
                raise TimeoutError("fabric pull overran its budget")
        except Exception:  # noqa: BLE001 — torn/flipped (KVStoreCorrupt),
            tele.count_fabric("degraded")  # dead link, slow, 404
            return None
        try:
            meta = header.get("meta") or {}
            ec = self.engine.ec
            hashes = meta.get("hashes")
            pages = int(meta.get("pages") or 0)
            if (meta.get("page_size") != ec.page_size or pages < 1
                    or not isinstance(hashes, list) or len(hashes) < pages
                    or int(meta.get("adapter_id") or 0) != self._adapter_id(adapter)
                    # model identity: chain hashes seed on tokens, not
                    # weights — a same-shape sibling model's frame would
                    # pass every other gate and decode silently wrong
                    or meta.get("model") != self.name):
                raise ValueError("fabric meta mismatch")
            # a prefix frame covers exactly its declared page count
            self._verify_kv_layout(blob, meta, pages, pages)
        except Exception:  # noqa: BLE001 — degrade, never fail
            tele.count_fabric("degraded")
            return None
        return blob, [int(h) for h in hashes[:pages]], int(header.get("nbytes") or 0)

    def pull_fabric(self, key: str, count_miss: bool = True) -> Optional[bytes]:
        """Serve one published prefix frame (``GET /engine/kv_fabric/<key>``).
        Multi-reader: never consumed.  None = unknown or expired."""
        if self.engine is None:
            return None
        try:
            return self.engine.pull_fabric(key, count_miss=count_miss)
        except Exception:  # noqa: BLE001 — a pull must answer
            return None

    def pull_handoff(self, handle: str, count_miss: bool = True) -> Optional[bytes]:
        """Serve one exported KV frame (``GET /engine/kv_handoff/<handle>``).
        None = unknown, expired or already pulled."""
        if self.engine is None:
            return None
        try:
            return self.engine.pull_handoff(handle, count_miss=count_miss)
        except Exception:  # noqa: BLE001 — a pull must answer
            return None

    def _decode_phase_unary(self, ids: list, max_tokens: int, deadline, priority,
                            session, hand: dict, headers, adapter=None,
                            brownout: int = 0) -> dict:
        """Decode phase, unary: fold the prefill phase's token(s) into the
        prompt, import the verified KV (or degrade to re-prefill), and
        return the FULL output — the handoff tokens included.  TTFT is the
        prefill phase's (the proxy passes its timing through), and the
        latency adds both phases and the pull."""
        prior = hand["token_ids"]
        max_new = max_tokens - len(prior)
        base_ttft = hand.get("phase_ttft_s", 0.0)
        base_lat = hand.get("phase_latency_s", 0.0)
        if max_new <= 0 or prior[-1] in self.engine._stop_ids:
            # the prefill phase already finished the generation
            return {"text_output": self.tokenizer.decode(prior),
                    "token_ids": list(prior), "tokens": len(prior),
                    "prompt_tokens": len(ids), "max_tokens": max_tokens,
                    "ttft_s": round(base_ttft, 4), "latency_s": round(base_lat, 4)}
        t_pull = time.perf_counter()
        imp = self._handoff_import(hand, adapter)
        pull_s = time.perf_counter() - t_pull
        r = self.engine.generate(ids + prior, max_new, deadline=deadline,
                                 priority=priority, session_id=session,
                                 kv_import=imp, adapter=adapter, brownout=brownout,
                                 trace=_trace_ctx(headers),
                                 links=_resume_link(headers),
                                 pre_hints={"handoff_import": pull_s} if pull_s > 0 else None,
                                 # an import that degraded before submit
                                 # re-prefills the prefill replica's work
                                 waste_hint=None if imp is not None else "handoff_degraded")
        out_ids = list(prior) + r["tokens"]
        out = {"text_output": self.tokenizer.decode(out_ids),
               "token_ids": out_ids,
               "tokens": r["num_tokens"] + len(prior),
               "prompt_tokens": len(ids), "max_tokens": max_tokens,
               "ttft_s": round(base_ttft if base_ttft > 0 else r["ttft_s"], 4),
               "latency_s": round(base_lat + pull_s + r["latency_s"], 4)}
        if "session" in r:
            out["session"] = r["session"]
        if _truthy_header(headers, "x-request-trace"):
            out["trace"] = self.engine.trace(r["rid"])
        return out

    def _handoff_complete(self, prior: list, ids: list, max_tokens: int, hand: dict):
        """Degenerate decode phase: the prefill phase already produced every
        token — emit its text, then the final record with its timing."""
        full = self.tokenizer.decode(prior)
        if full:
            yield {"text_output": full, "token_ids": list(prior)}
        yield {"text_output": "", "done": True, "tokens": len(prior),
               "prompt_tokens": len(ids), "max_tokens": max_tokens,
               "ttft_s": round(hand.get("phase_ttft_s", 0.0), 4),
               "latency_s": round(hand.get("phase_latency_s", 0.0), 4)}

    def generate_stream(self, payload: Any, headers: Optional[dict] = None):
        """V2 generate_stream: yields {"text_output": piece} per token, then
        a final record with the run stats.

        Parsing and submission happen EAGERLY (a plain method returning a
        generator), so client faults raise HERE, before the server commits
        to SSE headers, and take the unary 400 path.

        Pieces come from decoding the WHOLE generated-id prefix and emitting
        the delta, holding back trailing replacement chars (a multi-byte
        UTF-8 char split across byte tokens decodes to U+FFFD until its tail
        arrives), so the concatenated stream equals the unary text_output.
        A truthy ``X-Stream-Resume`` header makes every event carry the
        ``token_ids`` it covers, including empty-text events whose piece is
        held back; ``resume_token_ids`` folds earlier ids into the prompt so
        the stream emits only the continuation.  A ``handoff`` block streams
        the decode phase: the handoff tokens' text rides out with the first
        events.  ``kv_handoff`` is unary only."""
        ((ids, max_tokens, deadline, priority, resume, session, adapter),
         kv_handoff, hand, fab, brownout, constrain) = self._parse_all(payload, headers)
        if kv_handoff:
            raise RequestError("kv_handoff is the unary prefill-phase parameter; "
                               "POST /generate")
        with_trace = _truthy_header(headers, "x-request-trace")
        emit_ids = _truthy_header(headers, "x-stream-resume")
        if hand is not None:
            if resume:
                raise RequestError("handoff and resume_token_ids are mutually exclusive")
            prior = hand["token_ids"]
            if max_tokens - len(prior) <= 0 or prior[-1] in self.engine._stop_ids:
                return self._handoff_complete(prior, ids, max_tokens, hand)
            t_pull = time.perf_counter()
            imp = self._handoff_import(hand, adapter)
            pull_s = time.perf_counter() - t_pull
            stream = self.engine.generate_stream(
                ids + prior, max_tokens - len(prior), deadline=deadline,
                priority=priority, session_id=session, kv_import=imp,
                adapter=adapter, brownout=brownout,
                trace=_trace_ctx(headers), links=_resume_link(headers),
                pre_hints={"handoff_import": pull_s} if pull_s > 0 else None,
                waste_hint=None if imp is not None else "handoff_degraded")
            # the handoff tokens were generated elsewhere but never
            # DELIVERED: their text (and ids) go out with the first events;
            # the pull's wall time joins the prefill phase's in the latency
            return self._stream_pieces(
                stream, ids, max_tokens, with_trace=with_trace, emit_ids=emit_ids,
                prior_ids=prior, prior_emitted=False,
                phase_ttft=hand.get("phase_ttft_s", 0.0),
                phase_latency=hand.get("phase_latency_s", 0.0) + pull_s)
        max_new = max_tokens - len(resume)
        if resume and max_new <= 0:
            return self._resume_complete(resume, ids, max_tokens)
        # the pull's wall time joins the final record's TTFT and latency:
        # the client's clock started before the pull
        fimp, pull_s = self._timed_fabric_import(fab, adapter)
        stream = self.engine.generate_stream(
            ids + resume, max_new, deadline=deadline, priority=priority,
            session_id=session, fabric_import=fimp, adapter=adapter,
            brownout=brownout, constrain=constrain, trace=_trace_ctx(headers),
            links=_resume_link(headers),
            pre_hints={"fabric_pull": pull_s} if pull_s > 0 else None,
            waste_hint=self._waste_hint(resume, fab, fimp))
        return self._stream_pieces(stream, ids, max_tokens, with_trace=with_trace,
                                   emit_ids=emit_ids, prior_ids=resume, pull_s=pull_s)

    @staticmethod
    def _stable_len(full: str, floor: int = 0) -> int:
        """Length of the stable (client-safe) prefix of ``full``: up to 3
        trailing U+FFFD chars may be an incomplete UTF-8 sequence still
        waiting for its tail bytes and are held back."""
        stable = len(full)
        while (stable > floor and full[stable - 1] == "\ufffd"
               and len(full) - stable < 3):
            stable -= 1
        return stable

    def _resume_complete(self, resume: list, ids: list, max_tokens: int):
        """Degenerate resume: every token was already generated before the
        failover — emit any held-back text tail, then the final record."""
        full = self.tokenizer.decode(resume)
        emitted = self._stable_len(full)
        if full[emitted:]:
            yield {"text_output": full[emitted:]}
        yield {"text_output": "", "done": True, "tokens": len(resume),
               "prompt_tokens": len(ids), "max_tokens": max_tokens,
               "ttft_s": 0.0, "latency_s": 0.0}

    def _stream_pieces(self, stream, ids: list, max_tokens: int,
                       with_trace: bool = False, emit_ids: bool = False,
                       prior_ids: Optional[list] = None, prior_emitted: bool = True,
                       phase_ttft: float = 0.0, phase_latency: float = 0.0,
                       pull_s: float = 0.0):
        out_ids: list[int] = list(prior_ids or [])
        base = len(out_ids)
        # prior_emitted (failover resume): the text already delivered by the
        # previous replica is the stable prefix of the resumed ids (the
        # ingress relayed exactly the stable pieces).  Not prior_emitted
        # (disaggregation handoff): nothing has reached the client yet
        emitted = (self._stable_len(self.tokenizer.decode(out_ids))
                   if out_ids and prior_emitted else 0)
        reported = base if prior_emitted else 0
        try:
            for item in stream:
                if isinstance(item, dict):
                    full = self.tokenizer.decode(out_ids)
                    if len(full) > emitted:  # flush held-back tail
                        yield {"text_output": full[emitted:]}
                    if "constrain" in item:
                        # the structured event: a grammar-valid completion
                        # re-emits the whole utterance PARSED, as its own
                        # typed event before the final record, so a tool
                        # dispatcher never re-assembles text pieces
                        sf = self._structured_fields(item["constrain"], full)
                        if sf:
                            ev = {"text_output": "", "event": next(iter(sf))}
                            ev.update(sf)
                            yield ev
                    final = {"text_output": "", "done": True,
                             "tokens": item["num_tokens"] + base,
                             "prompt_tokens": len(ids), "max_tokens": max_tokens,
                             # a decode phase reports the prefill phase's
                             # TTFT (the client's first token came from it);
                             # a fabric pull ran before submit, so it shifts
                             # both TTFT and latency
                             "ttft_s": round(phase_ttft if phase_ttft > 0
                                             else pull_s + item["ttft_s"], 4),
                             "latency_s": round(phase_latency + pull_s
                                                + item["latency_s"], 4)}
                    if "constrain" in item:
                        final["constrain"] = item["constrain"]
                    if "session" in item:
                        final["session"] = item["session"]
                    if "fabric" in item:
                        final["fabric"] = item["fabric"]
                    if with_trace:
                        final["trace"] = self.engine.trace(item["rid"])
                    yield final
                    return
                out_ids.append(item)
                full = self.tokenizer.decode(out_ids)
                stable = self._stable_len(full, emitted)
                if emit_ids:
                    # one event per token so every id reaches the failover
                    # relay promptly, even when its text is held back
                    ev = {"text_output": full[emitted:stable],
                          "token_ids": out_ids[reported:]}
                    reported = len(out_ids)
                    emitted = max(emitted, stable)
                    yield ev
                elif stable > emitted:
                    yield {"text_output": full[emitted:stable]}
                    emitted = stable
        finally:
            # disconnected client (GeneratorExit) or any early close: free
            # the slot instead of generating to the budget for nobody — a
            # no-op when the request already finished
            self.engine.cancel(stream.future)

    def predict(self, payload: Any, headers: Optional[dict] = None) -> Any:
        instances = payload.get("instances", []) if isinstance(payload, dict) else payload
        header_prio = _header(headers, "x-priority")
        # the V1 surface carries the ingress brownout stage top-level; every
        # instance of the batch degrades together
        brownout = self._parse_brownout(payload)
        if brownout:
            self.engine.telemetry.count_brownout(brownout)
        # validate every instance BEFORE submitting anything: a bad value
        # mid-loop would 500 the request while earlier submissions burn slots
        parsed = []
        for inst in instances:
            if isinstance(inst, str):
                inst = {"prompt": inst}
            unsupported = sorted(k for k in _UNSUPPORTED_PARAMS if inst.get(k) is not None)
            if unsupported:
                raise RequestError(f"instance fields {unsupported} are not "
                                   "supported by this engine yet")
            ad = inst.get("adapter")
            if ad is not None and ad not in self.adapters:
                raise RequestError(f"unknown adapter {ad!r} "
                                   f"(loaded: {sorted(self.adapters)})")
            try:
                n = int(inst.get("max_tokens", 32))
            except (TypeError, ValueError):
                raise RequestError("max_tokens must be an integer, got "
                                   f"{inst.get('max_tokens')!r}") from None
            prio = inst.get("priority")
            prio = normalize_priority(prio if prio is not None else header_prio)
            # a FRESH automaton per instance, compiled (and so validated)
            # before anything is submitted
            spec = inst.get("constrain")
            con = self._build_constraint(spec) if spec is not None else None
            parsed.append((inst.get("prompt", ""), n, _deadline(inst.get("deadline_s")),
                           prio, ad, con))
        futures = [self.engine.generate_async(self.tokenizer.encode(p) or [0], n,
                                              deadline=d, priority=pr, adapter=ad,
                                              brownout=brownout, constrain=con)
                   for p, n, d, pr, ad, con in parsed]
        out = []
        for fut in futures:
            try:
                r = fut.result(timeout=300)
            except EngineError as e:
                # per-instance fault isolation: one failed instance becomes
                # an error entry; its siblings' results are still returned
                out.append({"error": f"{type(e).__name__}: {e}"})
                continue
            entry = {
                "text": self.tokenizer.decode(r["tokens"]),
                "token_ids": r["tokens"],
                "tokens": r["num_tokens"],
                "ttft_s": round(r["ttft_s"], 4),
                "latency_s": round(r["latency_s"], 4),
                "truncated": r["truncated"],
            }
            if "constrain" in r:
                entry["constrain"] = r["constrain"]
                entry.update(self._structured_fields(r["constrain"], entry["text"]))
            out.append(entry)
        return out
