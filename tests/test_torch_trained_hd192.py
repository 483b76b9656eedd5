"""The served paths on trained weights at head_dim 192, the Gemma pipeline's
served head width (Gemma-7B's d_model 3072 over 16 heads).

tests/test_torch_decoder_mesh.py's ``test_served_paths_at_a_trained_logit_scale``
at head_dim 16, copied at head_dim 192: a 2-layer decoder of d_model 384
over 2 query heads, with 1 KV head (grouped, two query heads a KV head) or
2 (one a query head, as the pipeline's model), is trained on the CPU mesh
until its logits reach the same scale (~17, the scale of the fine-tuned
pipeline model on which a served token once lay 0.625 below the oracle's
max).  The JAX engine's default path (gather) serves it greedily, and so do
the port's paged path (the kernel's plain version on the CPU) and the port's
gather path (``paged_kernel=False``).

Each served token is held, tie-aware along its own trajectory, within
``TIE_EPS`` of its package's ``forward_full`` max: the JAX engine's against
the JAX oracle, the port's against the port's (the oracle of the card's 0.2
gate, phases 5–15 of ``chip_smoke.py``).  Across the packages, each port
token lies within that gate's 0.2 of the JAX oracle's max, and the two
oracles' max logits along every served trajectory agree within the
cross-framework logit tolerance of tests/test_torch_model.py.  At d_model
384 the two packages' bf16 GEMMs on the CPU sum in different orders, so a
few outputs round one bf16 ulp apart (none at d_model 64; in f32 the
oracles agree to ~2e-5): at a tie of one ulp a port path can part from the
JAX engine.  The largest lags and the first partings are printed."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.serving.engine import Engine as JEngine
from kubeflow_tpu.serving.engine import EngineConfig as JEngineConfig
from kubeflow_tpu_torch.serving.engine import model as TM
from kubeflow_tpu_torch.serving.engine.engine import Engine, EngineConfig
from test_torch_decoder_mesh import (GEO, LAG_BOUND, NEW_TOKENS, ORACLE_LEN, TIE_EPS, _lags,
                                     _oracle_logits, _trained)

HEAD_DIM = 192
# tests/test_torch_model.py's tolerance between the two packages' logits
XF_RTOL = XF_ATOL = 5e-2


def _port_oracle_logits(tuned, cfg, toks):
    padded = torch.zeros((1, ORACLE_LEN), dtype=torch.long)
    padded[0, :len(toks)] = torch.tensor(toks)
    return TM.forward_full(tuned, cfg, padded)[0, :len(toks)].numpy()


def _port_lags(tuned, cfg, prompt, got) -> list:
    """``_lags`` against the port's own ``forward_full``."""
    logits = _port_oracle_logits(tuned, cfg, list(prompt) + list(got))
    return [float(logits[len(prompt) - 1 + i].max() - logits[len(prompt) - 1 + i][t])
            for i, t in enumerate(got)]


@pytest.mark.parametrize("kv_heads", [1, 2], ids=["gqa", "mha"])
def test_served_paths_at_hd192_on_trained_weights(kv_heads):
    cfg = TM.DecoderConfig(vocab_size=128, d_model=2 * HEAD_DIM, n_layers=2, n_heads=2,
                           n_kv_heads=kv_heads, d_ff=256)
    assert cfg.head_dim == HEAD_DIM
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
    report = {"jax_gather_max_lag": max(max(_lags(jp, jcfg, p, w))
                                        for p, w in zip(prompts, want))}
    assert report["jax_gather_max_lag"] <= TIE_EPS, report
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
        own = max(max(_port_lags(tuned, cfg, p, g)) for p, g in zip(prompts, got))
        report[path] = {"max_lag": own, "first_parting": parts,
                        "jax_oracle_max_lag": max(max(_lags(jp, jcfg, p, g))
                                                  for p, g in zip(prompts, got))}
        assert own <= TIE_EPS <= LAG_BOUND, (path, report)
        assert report[path]["jax_oracle_max_lag"] <= LAG_BOUND, (path, report)
        for p, g in zip(prompts, got):
            toks = list(p) + list(g)
            jl = _oracle_logits(jp, jcfg, toks)[len(p) - 1:]
            tl = _port_oracle_logits(tuned, cfg, toks)[len(p) - 1:]
            np.testing.assert_allclose(tl.max(-1), jl.max(-1), rtol=XF_RTOL, atol=XF_ATOL)
    print(f"head_dim {HEAD_DIM}, {kv_heads} KV heads, logit scale {top}: {report}")
