"""Sobol quasi-random search (upstream: katib `sobol` via goptuna).

A copy of ``kubeflow_tpu/katib/suggest/sobol.py``
(the port imports nothing of the JAX package).

A digital (t, s)-sequence in base 2: successive points fill the unit cube
far more evenly than i.i.d. random draws, so low-budget sweeps cover the
search space without the clumping/gaps random search produces.  Numpy-only
construction (no scipy.qmc in the image): Gray-code Sobol with Joe–Kuo-style
direction numbers for the first 21 dimensions, plus a seeded digital shift
(per-dimension XOR mask) so different ``random_state`` settings give
different — still low-discrepancy — sequences.
"""

from __future__ import annotations

import numpy as np

from . import register
from .space import from_unit, param_specs, settings_dict

_BITS = 30

# (s, a, m) primitive-polynomial parameters per dimension (dimension 1 is the
# van der Corput sequence).  Any valid set (odd m_i < 2^i) yields a digital
# sequence with the base-2 stratification property the tests pin down.
_JOE_KUO = (
    (1, 0, (1,)),
    (2, 1, (1, 3)),
    (3, 1, (1, 3, 1)),
    (3, 2, (1, 1, 1)),
    (4, 1, (1, 1, 3, 3)),
    (4, 4, (1, 3, 5, 13)),
    (5, 2, (1, 1, 5, 5, 17)),
    (5, 4, (1, 1, 5, 5, 5)),
    (5, 7, (1, 1, 7, 11, 19)),
    (5, 11, (1, 1, 5, 1, 1)),
    (5, 13, (1, 1, 1, 3, 11)),
    (5, 14, (1, 3, 5, 5, 31)),
    (6, 1, (1, 3, 3, 9, 7, 49)),
    (6, 13, (1, 1, 1, 15, 21, 21)),
    (6, 16, (1, 3, 1, 13, 27, 49)),
    (6, 19, (1, 1, 1, 15, 7, 5)),
    (6, 22, (1, 3, 1, 15, 13, 25)),
    (6, 25, (1, 1, 5, 5, 19, 61)),
    (7, 1, (1, 3, 7, 11, 23, 15, 103)),
    (7, 4, (1, 3, 7, 13, 13, 45, 109)),
)
MAX_DIMS = 1 + len(_JOE_KUO)

# the stratification property needs every m_i odd and < 2^i — guard the
# table itself so a bad edit fails at import, not as out-of-range samples
for _s, _a, _m in _JOE_KUO:
    for _i, _mi in enumerate(_m, start=1):
        assert _mi % 2 == 1 and _mi < (1 << _i), (_s, _a, _m)


def _direction_numbers(dim: int) -> np.ndarray:
    """V[i] (i < _BITS) for 0-based dimension ``dim``."""
    v = np.zeros(_BITS, dtype=np.int64)
    if dim == 0:  # van der Corput
        for i in range(_BITS):
            v[i] = 1 << (_BITS - 1 - i)
        return v
    s, a, m = _JOE_KUO[dim - 1]
    for i in range(min(s, _BITS)):
        v[i] = m[i] << (_BITS - 1 - i)
    for i in range(s, _BITS):
        x = v[i - s] ^ (v[i - s] >> s)
        for k in range(1, s):
            if (a >> (s - 1 - k)) & 1:
                x ^= v[i - k]
        v[i] = x
    return v


def sobol_points(start: int, count: int, dims: int, shift: np.ndarray) -> np.ndarray:
    """Points ``start .. start+count-1`` of the shifted sequence, [count, dims]
    in [0, 1).  Gray-code order: point n XORs V[j] for the set bits of
    gray(n) = n ^ (n >> 1)."""
    if dims > MAX_DIMS:
        raise ValueError(f"sobol supports up to {MAX_DIMS} parameters, got {dims}")
    vs = [_direction_numbers(d) for d in range(dims)]
    out = np.empty((count, dims))
    for row, n in enumerate(range(start, start + count)):
        gray = n ^ (n >> 1)
        for d in range(dims):
            x = int(shift[d])
            g = gray
            j = 0
            while g:
                if g & 1:
                    x ^= int(vs[d][j])
                g >>= 1
                j += 1
            out[row, d] = x / float(1 << _BITS)
    return out


@register("sobol")
class SobolSuggester:
    def suggest(self, experiment, trials, count):
        specs = param_specs(experiment)
        raw = settings_dict(experiment).get("random_state")
        if raw is None:
            shift = np.zeros(len(specs), dtype=np.int64)  # the pure sequence
        else:
            rng = np.random.default_rng(int(raw))
            shift = rng.integers(0, 1 << _BITS, size=len(specs), dtype=np.int64)
        # resume where the experiment left off; skip index 0 (the origin)
        start = len(trials) + 1
        pts = sobol_points(start, count, len(specs), shift)
        return [
            {p["name"]: from_unit(p, u) for p, u in zip(specs, row)}
            for row in pts
        ]
