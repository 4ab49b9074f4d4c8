"""Edge-case inputs of the row scatter-adds, shared by the CPU parity tests
(port against JAX and numpy) and the CUDA tests (kernel against plain). It
imports numpy only, so that it loads on the card's machine, which has no
JAX. This file holds no tests.

Each case is (idx [R, N] int32, contrib [R, N, d] f32, hw), from a seed, at
any head dim ``d``; ``CASE_WIDTHS`` are the ones the kernels take (64: the
widened decoder layers past ``eval_idx`` at ``layer_scale`` 2):

- ``hw_edges``: hw = 1500, a multiple of neither the JAX kernels' 512-row
  tiles nor the CUDA kernels' 128-row tiles; entries at 0, at hw - 1, at the
  first and last row of every 128-row (so also every 512-row) tile, and
  dropped ones at -1 and at hw;
- ``dense_duplicates``: every index in [0, 4);
- ``long_n``: N = 9000, more than one 6144-entry window of the CUDA tile
  kernels' walk;
- ``clustered``: 300 entries of a row on one destination (37) and 300 on a
  second in another 128-row tile (421), the rest uniform over [-1, hw], so
  some dropped: the hot pixels of a train step's sampling points.
"""

from __future__ import annotations

import numpy as np

EDGE_CASES = ("hw_edges", "dense_duplicates", "long_n", "clustered")
CASE_WIDTHS = (16, 32, 64)


def scatter_case(name: str, d: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    if name == "hw_edges":
        hw, r, n = 1500, 3, 1000
        edges = {0, hw - 1, -1, hw}
        for t in range(128, hw, 128):
            edges |= {t - 1, t}
        idx = rng.choice(np.array(sorted(edges)), (r, n))
    elif name == "dense_duplicates":
        hw, r, n = 300, 3, 600
        idx = rng.integers(0, 4, (r, n))
    elif name == "long_n":
        hw, r, n = 700, 2, 9000
        idx = rng.integers(-1, hw, (r, n))
    elif name == "clustered":
        hw, r, n = 700, 2, 1500
        idx = rng.integers(-1, hw + 1, (r, n))
        for row in idx:
            hot = rng.permutation(n)[:600]
            row[hot[:300]], row[hot[300:]] = 37, 421
    else:
        raise KeyError(name)
    contrib = rng.normal(size=(r, n, d)).astype(np.float32)
    return idx.astype(np.int32), contrib, hw
