"""ROADMAP Queue 3 item 1, replayed on the CPU: a grammar that masks
nothing, on one slot of four, must not change that slot's tokens except at
a near tie.

On the card (``chip_smoke.py`` 5i (c)) phase 5's four prompts ran plain,
then again on the same engine with prompt 4 under an all-bytes grammar, and
prompt 4's tokens parted after the sixth.  This replays that pair at a
small width with the same prompts (bytes): on the same engine (the second
run adopts the first's prefix-cache pages) and on a fresh one.  Where the
tokens part, the ``forward_full`` oracle's top two logits for the shared
prefix must stand within the oracle bound of each other (a near tie that
either run may take), and each run's token within the bound of the max."""

import dataclasses

import pytest
import torch

from kubeflow_tpu_torch.serving import constrain as C
from kubeflow_tpu_torch.serving.engine import engine as E
from kubeflow_tpu_torch.serving.engine import model as M

CFG = M.DecoderConfig(vocab_size=256, d_model=128, n_layers=4, n_heads=4, n_kv_heads=2,
                      d_ff=256)
TEXT = ("Kubeflow serves Llama-3-8B on one H100: requests enter through the "
        "model server, queue in the C++ batcher, prefill in buckets or chunks, "
        "and decode over the paged KV pool. ")
PROMPTS = [list(p.encode()) for p in (TEXT[:60], TEXT[:150], (TEXT * 3)[:300],
                                      (TEXT * 5)[:600])]
ALL_BYTES = r"start ::= [\x00-\xff]* ;"
TABLE = C.TokenTable([bytes([i]) for i in range(256)])
MAX_TOKENS = 32
# chip_smoke.py's oracle bound at 32 layers: 5e-2 * sqrt(32 / 2)
ORACLE_BOUND = 0.2
GEO = dict(max_slots=8, num_pages=256, page_size=32, max_pages_per_slot=32)


def _four(eng, constrained: bool) -> list:
    futs = [eng.generate_async(p, MAX_TOKENS, constrain=(
        C.GrammarConstraint(C.compile_grammar(ALL_BYTES), TABLE)
        if constrained and i == 3 else None)) for i, p in enumerate(PROMPTS)]
    return [f.result(timeout=300)["tokens"] for f in futs]


def _gap(params, a: list, b: list):
    """(first index where a and b part, oracle top-2 gap there, lag of a's
    token, lag of b's) or None when they agree."""
    k = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
    if k is None:
        return None
    with torch.inference_mode():
        logits = M.forward_full(params, CFG, torch.tensor([PROMPTS[3] + a[:k]]))[0, -1]
    top = logits.topk(2).values
    return k, float(top[0] - top[1]), float(top[0] - logits[a[k]]), float(top[0] - logits[b[k]])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_all_bytes_slot_parts_only_at_a_near_tie(seed):
    params = M.init(CFG, "cpu", seed=seed)
    ec = E.EngineConfig(**GEO)
    eng = E.Engine(params, CFG, ec, device="cpu")
    eng.start()
    try:
        plain = _four(eng, False)
        same = _four(eng, True)
    finally:
        eng.stop()
    eng = E.Engine(params, CFG, dataclasses.replace(ec), device="cpu")
    eng.start()
    try:
        fresh = _four(eng, True)
    finally:
        eng.stop()
    assert all(len(t) == MAX_TOKENS for t in plain + same + fresh)
    assert same[:3] == plain[:3] and fresh[:3] == plain[:3]
    for other in (same[3], fresh[3]):
        parted = _gap(params, plain[3], other)
        if parted is not None:
            k, gap, lag_a, lag_b = parted
            assert gap <= ORACLE_BOUND and max(lag_a, lag_b) <= ORACLE_BOUND, parted
