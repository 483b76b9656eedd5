"""The generator: the same seed gives the same inputs, another seed other
token ids and order but the same set of sizes."""

from __future__ import annotations

import random

import torch

from portbench import generator, spec

SEEDS = (2**31 + 11, 2**40 + 3, -5)


def test_stratified_gives_every_seed_the_same_sizes():
    dist = {"dist": "uniform", "range": [2, 512]}
    block = 32
    draw = lambda seed: [x for _, x in zip(range(2 * block), generator.stratified(
        dist, block, random.Random(generator.subseed(seed, "short"))))]
    a, b, c = draw(SEEDS[0]), draw(SEEDS[0]), draw(SEEDS[1])
    assert a == b and a != c
    for k in range(2):
        assert sorted(a[k * block:(k + 1) * block]) == sorted(c[k * block:(k + 1) * block])
    assert all(2 <= x <= 512 for x in a)
    # large seeds, past 64 bits and negative, give streams of their own
    assert len({generator.subseed(s, "x") for s in SEEDS + (2**70,)}) == len(SEEDS) + 1


def test_mlm_batches_are_the_seeds():
    mix = dict(spec.traffic("mlm-s128"), batch=16, seq_len=64, max_predictions=10)
    a = generator.mlm_batches(mix, SEEDS[0], 30522, 3, "cpu")
    b = generator.mlm_batches(mix, SEEDS[0], 30522, 3, "cpu")
    c = generator.mlm_batches(mix, SEEDS[1], 30522, 3, "cpu")
    for x, y in zip(a, b):
        assert all(torch.equal(x[k], y[k]) for k in x)
    assert not torch.equal(a[0]["input_ids"], c[0]["input_ids"])
    for batch in a + c:
        real = batch["attention_mask"].sum(1)
        assert int((real < 64).sum()) == round(0.1 * 16)
        pred = (batch["labels"] != -100).sum(1)
        assert int(pred.max()) <= 10 and int(pred.min()) >= 0
        assert bool((batch["input_ids"][:, 0] == 101).all())
        ids = batch["input_ids"]
        assert bool(((ids == 0) == (batch["attention_mask"] == 0)).all())
        # the masked share of the long rows' tokens: 15% of 62, rounded
        long = real == 64
        assert set(pred[long].tolist()) == {9}
    # the batches of the checked steps hold rows that all differ
    rows = torch.cat([x["input_ids"] for x in a])
    assert len({tuple(r.tolist()) for r in rows}) == rows.shape[0]
