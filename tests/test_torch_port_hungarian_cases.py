"""Assignment problems for the exact Hungarian solver, shared by the CPU
parity tests (the plain version against JAX and scipy) and the CUDA tests
(the kernel against the plain version). It imports numpy and scipy only, so
that it loads on the card's machine, which has no JAX. This file holds no
tests.

Each case is (cost [S, B, G, Q] f32, valid [B, G] bool) from a seed, the
first image without a valid row, pad rows costing 0 as the matcher's do:

- ``pads_q40``, ``pads_q300``: random rows valid, the second image of
  ``pads_q40`` wholly;
- ``square``: G = Q = 40, every row valid (argmin collisions and long
  augmenting paths);
- ``square_pads``: G = Q = 30 with pad rows;
- ``g1``: one row;
- ``train_m``: the m train step's stack, 100 GT slots of which 5-40 valid,
  Q = 300;
- ``q500``: the train step's 500 queries (300 matching and 200 CDN) as
  columns.
"""

from __future__ import annotations

import numpy as np
from scipy.optimize import linear_sum_assignment

CASES = ("pads_q40", "pads_q300", "square", "square_pads", "g1", "train_m", "q500")


def hungarian_case(case: str):
    rng = np.random.default_rng(CASES.index(case))
    if case == "pads_q40":
        s, b, g, q = 3, 4, 9, 40
        valid = rng.uniform(size=(b, g)) < 0.6
        valid[1] = True
    elif case == "pads_q300":
        s, b, g, q = 2, 3, 30, 300
        valid = rng.uniform(size=(b, g)) < 0.5
    elif case == "square":
        s, b, g, q = 2, 3, 40, 40
        valid = np.ones((b, g), bool)
    elif case == "square_pads":
        s, b, g, q = 2, 3, 30, 30
        valid = rng.uniform(size=(b, g)) < 0.7
    elif case == "g1":
        s, b, g, q = 3, 3, 1, 40
        valid = np.asarray([[True], [False], [True]])
    elif case in ("train_m", "q500"):
        s, b, g, q = 6, 8, 100, 300 if case == "train_m" else 500
        valid = np.arange(g)[None] < rng.integers(5, 41, (b, 1))
    else:
        raise KeyError(case)
    valid[0] = False  # an image without boxes
    cost = rng.normal(size=(s, b, g, q)).astype(np.float32)
    if case == "square":
        cost += rng.uniform(0, 0.3, (s, b, g, 1)).astype(np.float32)
    return np.where(valid[None, :, :, None], cost, 0.0).astype(np.float32), valid


def integer_case(g: int, q: int):
    """Integer costs in [0, 4), ties everywhere, every row valid."""
    rng = np.random.default_rng(g * 1000 + q)
    return rng.integers(0, 4, (3, 4, g, q)).astype(np.float32), np.ones((4, g), bool)


def assert_optimal(cost, valid, col4row, rtol=1e-6):
    """Pad rows -1; each problem's valid rows an assignment (distinct
    columns) whose total equals scipy's optimum within rtol (totals in
    float64)."""
    s, b = cost.shape[:2]
    for si in range(s):
        for bi in range(b):
            rows = np.flatnonzero(valid[bi])
            got = col4row[si, bi]
            assert (got[~valid[bi]] == -1).all()
            if not rows.size:
                continue
            assert len(set(got[rows].tolist())) == rows.size and (got[rows] >= 0).all()
            c = cost[si, bi][rows].astype(np.float64)
            r, col = linear_sum_assignment(c)
            best = c[r, col].sum()
            total = c[np.arange(rows.size), got[rows]].sum()
            np.testing.assert_allclose(total, best, rtol=rtol, atol=1e-9 * rows.size)
