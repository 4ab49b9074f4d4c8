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


def no_pending_case():
    """The m stack's shape with every valid row's first argmin its own
    column (row i's at column i, below the rest of its row): the row
    reduction assigns every valid row, and no path step is taken."""
    cost, valid = hungarian_case("train_m")
    rows = np.arange(cost.shape[2])
    cost[:, :, rows, rows] = cost.min(-1) - 1.0
    return np.where(valid[None, :, :, None], cost, 0.0).astype(np.float32), valid


# the dynamic shared memory a block of the kernel takes (csrc/hungarian_lap.cu:
# kMaxSmem), which holds 28 G + 8 Q bytes of state and the staged rows
MAX_SMEM = 232448


def cap_rows(g: int, q: int) -> int:
    """The valid rows a problem may have for the kernel to stage them in
    shared memory (csrc/hungarian_lap.cu: ``launch``); a problem with more
    reads its rows from global memory."""
    state = (g * 28 + q * 8 + 15) // 16 * 16
    return min(g, (MAX_SMEM - state) // (q * 4))


# (G, Q, valid rows per image (low, high)) of the cases at the kernel's
# boundaries: columns per lane 10 up to Q = 320, 16 up to 512, 32 up to
# 1024; square problems; and at each columns-per-lane instance, problems
# whose valid rows do not all fit the kernel's shared memory (``cap_rows``:
# 172 rows of 320 columns in ``square_g320``, 116 of 480, 91 of 600, 54 of
# 1024), the ``unstaged`` cases in one launch with problems that do
SIZE_CASES = {
    "q32": (20, 32, (1, 21)), "q320": (100, 320, (40, 101)), "q321": (100, 321, (40, 101)),
    "q512": (100, 512, (40, 101)), "q1024": (100, 1024, (30, 54)),
    "square_g128": (128, 128, (128, 129)), "square_g320": (320, 320, (300, 321)),
    "unstaged_q480": (160, 480, (60, 161)), "unstaged_q600": (300, 600, (60, 201)),
    "unstaged_q1024": (64, 1024, (30, 65)),
}


def size_case(case: str):
    """(cost [2, 4, G, Q] f32, valid [4, G] bool) of ``SIZE_CASES[case]``,
    the first image of the non-square cases without a valid row, pad rows
    costing 0. In the ``unstaged`` cases the second image has the fewest
    valid rows (staged) and the last every row (read from global memory)."""
    g, q, (lo, hi) = SIZE_CASES[case]
    rng = np.random.default_rng(100 + list(SIZE_CASES).index(case))
    n_valid = rng.integers(lo, hi, (4, 1))
    if case.startswith("unstaged"):
        n_valid[1], n_valid[-1] = lo, g
    valid = np.arange(g)[None] < n_valid
    if g < q:
        valid[0] = False
    cost = rng.normal(size=(2, 4, g, q)).astype(np.float32)
    return np.where(valid[None, :, :, None], cost, 0.0).astype(np.float32), valid
