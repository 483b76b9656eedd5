"""The decoder trained on a mesh, then served: the port's twin of
tests/test_hf_convert.py's ``test_hf_checkpoint_finetunes_then_serves``, and
the served paths on weights trained to a large logit scale.

* A tiny Llama checkout (built with ``transformers`` in ``tmp_path``) is
  converted by the port's ``hf_convert``, fine-tuned 6 steps on ``d2f2t2``
  (8 shards of the CPU) through ``decoder.SHARDING_RULES``, and the tuned
  weights serve finite logits through the engine's ``forward_full``.
* A tiny decoder trained on the same mesh until its logits reach ~17 (the
  scale of the fine-tuned pipeline model on which a served token once lay
  0.625 below the oracle's max) is served greedily by the JAX engine's
  default path (the gather path: no ``PAGED_CHIP_VALIDATED`` marker, and the
  Pallas kernel is off off the TPU), by the port's paged path (on the CPU,
  the kernel's plain version, which keeps the softmax probabilities in f32
  as the kernel and the Pallas kernel do) and by the port's gather path
  (``paged_kernel=False``, which rounds them to bf16 as the JAX gather
  path does).  Each path's tokens are held against the JAX ``forward_full``
  along its own trajectory, tie-aware; the largest logit lag and the first
  token where a port path parts from the JAX engine are printed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.serving.engine import Engine as JEngine
from kubeflow_tpu.serving.engine import EngineConfig as JEngineConfig
from kubeflow_tpu.serving.engine import model as JM
from kubeflow_tpu_torch.models import decoder as tdec
from kubeflow_tpu_torch.parallel import mesh as tmesh
from kubeflow_tpu_torch.serving.engine import model as TM
from kubeflow_tpu_torch.serving.engine.engine import Engine, EngineConfig
from kubeflow_tpu_torch.train.trainer import Trainer, TrainerConfig

D2F2T2 = dict(data=2, fsdp=2, tensor=2)
# the cross-framework bf16 logit tolerance (tests/test_torch_model.py)
TIE_EPS = 5e-2
# the served-token bound of the card's parity runs (ROADMAP Queue 3 item 2)
LAG_BOUND = 0.2
# trained until the largest logit on the probe reaches this
LOGIT_SCALE = 17.0
GEO = dict(max_slots=4, num_pages=64, page_size=8, max_pages_per_slot=16)
NEW_TOKENS, ORACLE_LEN = 24, 64


def _mesh():
    return tmesh.build_mesh(tmesh.MeshConfig(**D2F2T2), ["cpu"] * 8)


def test_hf_checkpoint_finetunes_on_a_mesh_then_serves(tmp_path):
    transformers = pytest.importorskip("transformers")
    from kubeflow_tpu_torch.serving.engine.hf_convert import convert_hf_checkpoint

    cfg = transformers.LlamaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=112, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, rope_theta=10000.0,
        rms_norm_eps=1e-5, tie_word_embeddings=False, attention_bias=False, mlp_bias=False)
    torch.manual_seed(0)
    src = tmp_path / "hf"
    transformers.LlamaForCausalLM(cfg).eval().save_pretrained(src)
    out = tmp_path / "engine"
    convert_hf_checkpoint(str(src), str(out), dtype="float32")
    config = TM.DecoderConfig.from_dir(str(out))
    params = {k: torch.from_numpy(np.array(v, np.float32))
              for k, v in np.load(out / "params.npz").items()}
    tr = Trainer(lambda p, b: tdec.lm_loss(p, config, b["tokens"]), params,
                 TrainerConfig(learning_rate=5e-3, warmup_steps=1, total_steps=8),
                 mesh=_mesh(), rules=tdec.SHARDING_RULES)
    data = tdec.synthetic_lm_batches(config.vocab_size, 4, 16)
    losses = [tr.train_step(next(data))["loss"] for _ in range(6)]
    assert losses[-1] < losses[0], losses  # it trains
    tuned = tr.global_params()
    assert not torch.equal(tuned["wq"], params["wq"])
    toks = torch.tensor([[5, 17, 9]])
    logits = TM.forward_full(tuned, config, toks)  # tuned weights serve
    assert tuple(logits.shape) == (1, 3, 128) and torch.isfinite(logits).all()


def _counting_batches(vocab: int, batch: int, seq: int, seed: int = 0):
    """Sequences that count up by one from a random start (mod vocab): a
    law the model learns to near certainty, so its logits keep growing."""
    rng = np.random.default_rng(seed)
    while True:
        start = rng.integers(0, vocab, (batch, 1))
        yield {"tokens": ((start + np.arange(seq)[None]) % vocab).astype(np.int32)}


def _trained(cfg):
    """The JAX init's weights (bf16), trained on the mesh until the probe's
    largest logit reaches LOGIT_SCALE; the tuned tree and that logit."""
    jcfg = JM.DecoderConfig(**{f: getattr(cfg, f) for f in TM.DecoderConfig.__dataclass_fields__})
    jp = JM.init(jax.random.PRNGKey(0), jcfg)
    tr = Trainer(lambda p, b: tdec.lm_loss(p, cfg, b["tokens"]),
                 TM.params_from_jax({k: np.asarray(v) for k, v in jp.items()}, "cpu"),
                 TrainerConfig(learning_rate=5e-2, warmup_steps=2, total_steps=200,
                               weight_decay=0.0),
                 mesh=_mesh(), rules=tdec.SHARDING_RULES)
    data = _counting_batches(cfg.vocab_size, 8, ORACLE_LEN)
    probe = torch.arange(0, 32)[None]
    for _ in range(40):
        tr.train_step(next(data))
        tuned = tr.global_params()
        top = float(TM.forward_full(tuned, cfg, probe).max())
        if top >= LOGIT_SCALE:
            return jcfg, tuned, top
    raise AssertionError(f"the logits reached {top} only")


def _oracle_logits(jp, jcfg, toks):
    padded = np.zeros((1, ORACLE_LEN), np.int32)
    padded[0, :len(toks)] = toks
    return np.asarray(JM.forward_full(jp, jcfg, jnp.asarray(padded)))[0, :len(toks)]


def _lags(jp, jcfg, prompt, got) -> list:
    """Each served token's oracle logit below the oracle's max, along the
    served trajectory."""
    logits = _oracle_logits(jp, jcfg, list(prompt) + list(got))
    return [float(logits[len(prompt) - 1 + i].max() - logits[len(prompt) - 1 + i][t])
            for i, t in enumerate(got)]


def test_served_paths_at_a_trained_logit_scale():
    cfg = TM.DecoderConfig(vocab_size=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
                           d_ff=128)
    jcfg, tuned, top = _trained(cfg)
    jp = {k: jnp.asarray(v.float().numpy(), jnp.bfloat16) for k, v in tuned.items()}
    rng = np.random.default_rng(1)
    prompts = [[5, 6, 7, 8], [100, 3, 77, 20, 9], [1], [50, 51, 52, 90, 91],
               rng.integers(0, 128, 12).tolist(), rng.integers(0, 128, 7).tolist()]
    eng = JEngine(jp, jcfg, JEngineConfig(**GEO))
    assert not eng.ec.paged_kernel  # the reference's default path: gather
    eng.start()
    try:
        want = [eng.generate_async(p, NEW_TOKENS).result(timeout=300)["tokens"]
                for p in prompts]
    finally:
        eng.stop()
    report = {}
    for path, paged in (("paged", True), ("gather", False)):
        e = Engine(tuned, cfg, EngineConfig(**GEO, paged_kernel=paged), device="cpu")
        e.start()
        try:
            got = [e.generate_async(p, NEW_TOKENS).result(timeout=300)["tokens"]
                   for p in prompts]
        finally:
            e.stop()
        parts = [next((i for i, (a, b) in enumerate(zip(g, w)) if a != b), None)
                 for g, w in zip(got, want)]
        lag = max(max(_lags(jp, jcfg, p, g)) for p, g in zip(prompts, got))
        report[path] = {"max_lag": lag, "first_parting": parts}
        assert lag <= TIE_EPS <= LAG_BOUND, (path, lag)
    report["jax_gather_max_lag"] = max(max(_lags(jp, jcfg, p, w))
                                       for p, w in zip(prompts, want))
    print(f"logit scale {top}: {report}")
    assert report["jax_gather_max_lag"] <= TIE_EPS
    # the gather paths round the probabilities alike: the same tokens
    assert report["gather"]["first_parting"] == [None] * len(prompts), report
