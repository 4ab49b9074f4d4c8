"""Binary mask -> simplified polygons without cv2 (the port of
``BaseServing.mask2poly``, ``dfine_tpu/infer/base.py:234-249``, which calls
``cv2.findContours(RETR_EXTERNAL, CHAIN_APPROX_SIMPLE)``, ``cv2.arcLength``
and ``cv2.approxPolyDP``; the card's machine has no cv2).

- Outer borders: Suzuki and Abe's border following (8-connected
  foreground, 4-connected background) from the raster-first pixel of each
  foreground component that borders the background outside every hole,
  which is what ``RETR_EXTERNAL`` keeps. Components come from
  ``scipy.ndimage.label``.
- ``CHAIN_APPROX_SIMPLE``: only the points where the chain turns.
- ``approxPolyDP`` on a closed curve: two mutually far points split the
  curve (three rounds of "farthest from the last", as OpenCV starts), then
  Douglas-Peucker on each half with the distance to the line through a
  chain's ends.
"""

from __future__ import annotations

from typing import List

import numpy as np
from scipy import ndimage

# the 8 neighbours of a pixel, counter-clockwise as shown (row i grows down)
_DIRS = ((0, 1), (-1, 1), (-1, 0), (-1, -1), (0, -1), (1, -1), (1, 0), (1, 1))
_DIR_OF = {d: k for k, d in enumerate(_DIRS)}
_EIGHT = np.ones((3, 3), int)


def _follow(img: np.ndarray, i: int, j: int) -> np.ndarray:
    """The outer border through (i, j), the raster-first pixel of its
    component, as [N, 2] (row, col) points of the padded image."""
    # 3.1: clockwise around (i, j) from its west neighbour (background)
    for k in range(8):
        di, dj = _DIRS[(4 - k) % 8]
        if img[i + di, j + dj]:
            i1, j1 = i + di, j + dj
            break
    else:
        return np.asarray([(i, j)])
    pts = []
    i2, j2, i3, j3 = i1, j1, i, j
    while True:
        pts.append((i3, j3))
        # 3.3: counter-clockwise around (i3, j3), from the one after (i2, j2)
        start = _DIR_OF[(i2 - i3, j2 - j3)]
        for k in range(1, 9):
            di, dj = _DIRS[(start + k) % 8]
            if img[i3 + di, j3 + dj]:
                i4, j4 = i3 + di, j3 + dj
                break
        if (i4, j4) == (i, j) and (i3, j3) == (i1, j1):
            return np.asarray(pts)
        i2, j2, i3, j3 = i3, j3, i4, j4


def _turns(pts: np.ndarray) -> np.ndarray:
    """CHAIN_APPROX_SIMPLE: drop the points where the chain goes straight on."""
    if len(pts) < 3:
        return pts
    step_in = pts - np.roll(pts, 1, axis=0)
    step_out = np.roll(pts, -1, axis=0) - pts
    return pts[(step_in != step_out).any(1)]


def find_external_contours(mask: np.ndarray) -> List[np.ndarray]:
    """The outer contour of every component that ``RETR_EXTERNAL`` keeps,
    each [N, 2] int (x, y), compressed as ``CHAIN_APPROX_SIMPLE`` does."""
    img = np.pad(mask.astype(bool), 1)
    comps, n = ndimage.label(img, structure=_EIGHT)
    outside = ndimage.label(~img)[0]  # 4-connected background regions
    outside = outside == outside[0, 0]
    if n == 0:
        return []
    flat = comps.ravel()
    nz = np.flatnonzero(flat)
    labels, first = np.unique(flat[nz], return_index=True)  # raster-first pixel of each
    contours = []
    for start in nz[first]:
        i, j = divmod(int(start), img.shape[1])
        if not outside[i - 1, j]:  # inside a hole of another component
            continue
        pts = _turns(_follow(img, i, j)) - 1  # back to the unpadded frame
        contours.append(pts[:, ::-1].copy())
    return contours


def arc_length(pts: np.ndarray, closed: bool = True) -> float:
    p = pts.astype(np.float64)
    seg = np.diff(np.concatenate([p, p[:1]]) if closed else p, axis=0)
    return float(np.sqrt((seg ** 2).sum(1)).sum())


def _dp(chain: np.ndarray, eps: float) -> List[int]:
    """Douglas-Peucker on an open chain: indices kept, both ends included."""
    keep = [0, len(chain) - 1]
    stack = [(0, len(chain) - 1)]
    while stack:
        a, b = stack.pop()
        if b - a < 2:
            continue
        d = chain[b] - chain[a]
        rel = chain[a + 1 : b] - chain[a]
        norm = np.hypot(*d)
        dist = (np.abs(rel[:, 0] * d[1] - rel[:, 1] * d[0]) / norm if norm > 0
                else np.hypot(rel[:, 0], rel[:, 1]))
        k = int(dist.argmax())
        if dist[k] > eps:
            keep.append(a + 1 + k)
            stack += [(a, a + 1 + k), (a + 1 + k, b)]
    return sorted(keep)


def approx_poly_closed(pts: np.ndarray, eps: float) -> np.ndarray:
    """``cv2.approxPolyDP(pts, eps, closed=True)`` for [N, 2] points."""
    p = pts.astype(np.float64)
    n = len(p)
    if n < 3:
        return pts
    a = 0
    for _ in range(3):
        d2 = ((p - p[a]) ** 2).sum(1)
        b = int(d2.argmax())
        if d2[b] <= eps * eps:
            return pts[a : a + 1]
        a, b = b, a
    # the two halves a -> b and b -> a of the closed curve, each with its ends
    first = np.arange(a, a + (b - a) % n + 1) % n
    second = np.arange(b, b + (a - b) % n + 1) % n
    idx = [first[k] for k in _dp(p[first], eps)[:-1]] + [second[k] for k in _dp(p[second], eps)[:-1]]
    return pts[np.asarray(idx)]


def mask2poly(mask: np.ndarray, epsilon_frac: float = 0.005) -> List[np.ndarray]:
    """Binary mask [H, W] -> the simplified outer polygons of its
    components, each [K, 2] float32 (x, y) in pixels with K >= 3."""
    polys = []
    for c in find_external_contours(mask):
        if len(c) < 3:
            continue
        approx = approx_poly_closed(c, epsilon_frac * arc_length(c)).astype(np.float32)
        if len(approx) >= 3:
            polys.append(approx)
    return polys
