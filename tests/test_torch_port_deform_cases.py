"""Inputs of the deformable-attention sampling core, shared by the CPU parity
test (plain version against JAX) and the CUDA tests (kernel against plain).
It imports numpy only, so that it loads on the card's machine, which has no
JAX. This file holds no tests.

Each case is (value [B, S, 8, d] f32, spatial_shapes, loc [B, Q, 8, P, 2]
f32, att [B, Q, 8, P] f32 softmaxed, num_points), from a seed:

- ``pixel_edges``: every location on a pixel edge, u = k / W (k = 0 .. W,
  so 0 and 1 too), or on a pixel centre, u = (k + 0.5) / W, and the same for
  v, per level: the bilinear weights are 0, 1/2 or 1, the border corners
  fall just outside the map;
- ``one_level``: one level (9 x 13) of 4 points;
- ``n_points``: head dim 16 with points (6, 6) on two levels, as in the n
  model;
- ``head_dim_64``: head dim 64 (the widened decoder layers past
  ``eval_idx`` at ``layer_scale`` 2) with points (3, 6, 3) on three levels,
  locations on pixel edges and centres as in ``pixel_edges``;
- ``four_levels``: points (3, 6, 3, 3) on four levels, the last one
  extra-level-sized (2 x 2), head dim 32;
- ``off_the_map``: ``pixel_edges``' levels with every location off the map
  on one axis, drawn at random (-0.6, 1.7 or +-1e9 there): every corner
  outside, so the output and every gradient are 0.

``TILING_CASES`` (``tiling_case``) are the edges of the backward kernel's
work tiling (``csrc/ms_deform_attn_bwd.cu``: a warp takes a run of
consecutive (query, point) slots of one level, batch and head):

- ``q1``, ``q7``, ``q301``, ``q500``: that many queries, so that the last
  run of a level's slots is cut short (points (3, 6, 3), 300 and 500 are
  the serving and the train step's counts);
- ``one_row``: B = 1 and one head, B * H = 1;
- ``one_point_level``: points (3, 1, 4), a level with a single point;
- ``p16_four_levels``: 16 points over 4 levels, (4, 4, 4, 4).

Each has a head dim of its own (``TILING_DIMS``), so that the CPU test
meets 16, 32 and 64; the CUDA tests take each case at every head dim.
"""

from __future__ import annotations

import numpy as np

DEFORM_CASES = ("pixel_edges", "one_level", "n_points", "head_dim_64", "four_levels",
                "off_the_map")
HEADS = 8
TILING_CASES = ("q1", "q7", "q301", "q500", "one_row", "one_point_level", "p16_four_levels")
TILING_DIMS = {"q1": 16, "q7": 64, "q301": 32, "q500": 32, "one_row": 64,
               "one_point_level": 16, "p16_four_levels": 32}


def _softmax(x):
    e = np.exp(x - x.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def deform_case(name: str, b: int = 2, q: int = 17, seed: int = 0):
    rng = np.random.default_rng(seed)
    if name in ("pixel_edges", "off_the_map"):
        d, shapes, pts = 32, ((12, 10), (6, 5), (3, 3)), (3, 6, 3)
    elif name == "one_level":
        d, shapes, pts = 32, ((9, 13),), (4,)
    elif name == "n_points":
        d, shapes, pts = 16, ((10, 10), (5, 5)), (6, 6)
    elif name == "head_dim_64":
        d, shapes, pts = 64, ((12, 10), (6, 5), (3, 3)), (3, 6, 3)
    elif name == "four_levels":
        d, shapes, pts = 32, ((16, 16), (8, 8), (4, 4), (2, 2)), (3, 6, 3, 3)
    else:
        raise KeyError(name)
    s, p = sum(h * w for h, w in shapes), sum(pts)
    value = rng.normal(size=(b, s, HEADS, d)).astype(np.float32)
    loc = rng.uniform(-0.15, 1.15, (b, q, HEADS, p, 2)).astype(np.float32)
    if name in ("pixel_edges", "head_dim_64"):
        start = 0
        for (h, w), n in zip(shapes, pts):
            for axis, size in ((0, w), (1, h)):
                grid = np.concatenate([np.arange(size + 1) / size,
                                       (np.arange(size) + 0.5) / size]).astype(np.float32)
                loc[:, :, :, start:start + n, axis] = rng.choice(grid, (b, q, HEADS, n))
            start += n
    if name == "off_the_map":
        far = np.asarray([-0.6, 1.7, -1e9, 1e9], np.float32)
        axis = rng.integers(0, 2, loc.shape[:-1])
        off = far[rng.integers(0, 4, loc.shape[:-1])]
        for k in (0, 1):
            loc[..., k] = np.where(axis == k, off, loc[..., k])
    att = _softmax(rng.normal(size=(b, q, HEADS, p)))
    return value, shapes, loc, att, pts


def tiling_case(name: str, d: int = None, seed: int = 0):
    """A case of ``TILING_CASES`` at head dim ``d`` (default
    ``TILING_DIMS[name]``): (value [B, S, heads, d], spatial_shapes, loc [B,
    Q, heads, P, 2], att [B, Q, heads, P], num_points), locations in
    [-0.15, 1.15]."""
    rng = np.random.default_rng(seed)
    d = TILING_DIMS[name] if d is None else d
    b, q, heads = 2, 17, HEADS
    shapes, pts = ((12, 10), (6, 5), (3, 3)), (3, 6, 3)
    if name in ("q1", "q7", "q301", "q500"):
        q = int(name[1:])
        b = 1 if q > 100 else 2
    elif name == "one_row":
        b, q, heads = 1, 45, 1
    elif name == "one_point_level":
        pts = (3, 1, 4)
    elif name == "p16_four_levels":
        shapes, pts = ((16, 16), (8, 8), (4, 4), (2, 2)), (4, 4, 4, 4)
    else:
        raise KeyError(name)
    s, p = sum(h * w for h, w in shapes), sum(pts)
    value = rng.normal(size=(b, s, heads, d)).astype(np.float32)
    loc = rng.uniform(-0.15, 1.15, (b, q, heads, p, 2)).astype(np.float32)
    att = _softmax(rng.normal(size=(b, q, heads, p)))
    return value, shapes, loc, att, pts
