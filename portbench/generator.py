"""The one traffic generator: every mix is a data file of parameters
(``traffic/<mix>.json``) that this module reads.

Every quantity drawn from a distribution is drawn *stratified in blocks*: a
block of ``block`` consecutive values holds exactly the block's quantiles
``F^-1((j + 0.5) / block)``, in an order the seed shuffles.  So every seed
gets the same set of sizes, in another order, and the work of a run does
not change with its seed; only token ids and the order do.

Training mixes (``"driver": "train"``): MLM batches of ``batch`` rows of
``seq_len`` made on the device (``mlm_batches``).  Lengths are
``{"dist": "uniform", "range": [lo, hi]}`` (whole numbers, both ends
included); token ids are uniform in ``token_ids`` (a half-open range that
leaves out the tokenizer's special ids).
"""

from __future__ import annotations

import hashlib
import math
import random


def subseed(seed: int, *names) -> int:
    """A 63-bit seed for one named stream of a run's seed (any whole
    number, negative or past 64 bits included)."""
    key = "|".join([str(int(seed))] + [str(n) for n in names]).encode()
    return int.from_bytes(hashlib.sha256(key).digest()[:8], "little") >> 1


def _quantile(dist: dict, q: float) -> int:
    kind = dist["dist"]
    if kind == "uniform":
        lo, hi = dist["range"]
        return lo + math.floor(q * (hi - lo + 1))
    raise ValueError(f"unknown distribution {kind!r}")


def stratified(dist: dict, block: int, rng: random.Random):
    """Endless values of ``dist``: each block of ``block`` holds the block's
    quantiles, shuffled by ``rng``."""
    qs = [_quantile(dist, (j + 0.5) / block) for j in range(block)]
    while True:
        order = list(qs)
        rng.shuffle(order)
        yield from order


def mlm_batches(mix: dict, seed: int, vocab_size: int, count: int, device) -> list:
    """``count`` MLM batches made on ``device`` from the seed, as BERT's
    ``create_pretraining_data.py`` makes them: rows of ``seq_len`` tokens,
    ``[CLS]`` first and ``[SEP]`` last, ``short_seq_prob`` of them (stratified:
    the same count in every batch) shorter, uniform in ``[2, seq_len]`` and
    padded with 0; ``mask_prob`` of each row's tokens (``[CLS]``/``[SEP]``
    left out; at least 1, at most ``max_predictions``) chosen for
    prediction, 80% of those replaced by ``[MASK]``, 10% by a random token,
    10% kept.  Each batch: ``input_ids`` and ``labels`` (-100 where nothing
    is predicted) int64, ``attention_mask`` int32, all ``[batch,
    seq_len]``."""
    import torch

    B, S, P = mix["batch"], mix["seq_len"], mix["max_predictions"]
    cls_id, sep_id, mask_id = mix["special_ids"]["cls"], mix["special_ids"]["sep"], mix["special_ids"]["mask"]
    lo, hi = mix["token_ids"]
    n_short = round(mix["short_seq_prob"] * B)
    rng = random.Random(subseed(seed, "short"))
    short_len = stratified({"dist": "uniform", "range": [2, S]}, max(1, n_short) * 8, rng)
    g = torch.Generator(device=device)
    g.manual_seed(subseed(seed, "batches"))
    pos = torch.arange(S, device=device)
    out = []
    for _ in range(count):
        lens = [S] * B
        for row in rng.sample(range(B), n_short):
            lens[row] = int(next(short_len))
        lens_t = torch.tensor(lens, device=device)
        real = pos[None, :] < lens_t[:, None]
        ids = torch.randint(lo, hi, (B, S), generator=g, device=device)
        ids = torch.where(real, ids, 0)
        ids[:, 0] = cls_id
        ids[torch.arange(B, device=device), lens_t - 1] = sep_id
        cand = real & (pos[None, :] > 0) & (pos[None, :] < lens_t[:, None] - 1)
        score = torch.rand((B, S), generator=g, device=device).masked_fill(~cand, 2.0)
        rank = torch.empty_like(pos).expand(B, S).clone()
        rank.scatter_(1, score.argsort(dim=1), pos.expand(B, S).contiguous())
        n_pred = ((lens_t - 2).clamp(min=0).double() * mix["mask_prob"]).round().long()
        n_pred = n_pred.clamp(min=1, max=P)
        chosen = (rank < n_pred[:, None]) & cand
        u = torch.rand((B, S), generator=g, device=device)
        rand_ids = torch.randint(lo, hi, (B, S), generator=g, device=device)
        inp = torch.where(chosen & (u < 0.8), mask_id, ids)
        inp = torch.where(chosen & (u >= 0.8) & (u < 0.9), rand_ids, inp)
        out.append({"input_ids": inp, "labels": torch.where(chosen, ids, -100),
                    "attention_mask": real.to(torch.int32)})
    return out
