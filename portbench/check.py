"""The comparisons that decide ``correct``: each number the program's
outputs give against the plain reference, beside its limit from the cell's
file (``limits``).  A number is within its limit when it is at most the
limit; ``correct`` needs every number within."""

from __future__ import annotations

import math
import statistics

# a leaf whose reference gradient is under this share of the median leaf's
# is nought to rounding (a key's bias under softmax): its change is
# round-off, so it is left out of the change's comparison
NOUGHT_SHARE = 1e-3


def within(checks: dict) -> bool:
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
               for c in checks.values())


def leaf_gaps(prog: dict, ref: dict, names) -> dict:
    """Each leaf's gap between the program's norm and the reference's, over
    the larger of that leaf's reference norm and the median leaf's."""
    med = statistics.median(ref[n] for n in names)
    return {n: abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30) for n in names}


def trained(prog: dict, ref: dict, limits: dict) -> dict:
    """A training step followed through its first steps: each step's loss,
    each leaf's first gradient as the optimizer got it, and each leaf's
    change over those steps (leaves whose reference gradient is nought
    left out), the last two by the worst leaf."""
    loss_gap = max(abs(a - b) for a, b in zip(prog["loss"], ref["loss"]))
    if len(prog["loss"]) != len(ref["loss"]):
        loss_gap = math.inf
    names = sorted(ref["grad1"])
    med = statistics.median(ref["grad1"][n] for n in names)
    moved = [n for n in names if ref["grad1"][n] >= NOUGHT_SHARE * med]
    return {
        "loss_gap": {"value": loss_gap, "limit": limits["loss_gap"]},
        "grad_gap": {"value": max(leaf_gaps(prog["grad1"], ref["grad1"], names).values()),
                     "limit": limits["grad_gap"]},
        "change_gap": {"value": max(leaf_gaps(prog["change"], ref["change"], moved).values()),
                       "limit": limits["change_gap"]},
    }
