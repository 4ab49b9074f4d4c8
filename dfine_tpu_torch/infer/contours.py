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
  Douglas-Peucker on each half with the distance to the chord as a
  segment, then OpenCV's clean-up of nearly straight runs.
- ``arcLength`` and ``contourArea`` in OpenCV's arithmetic (float32
  segment lengths summed in order; the shoelace sum from the last point).

Contours, polygons, lengths and areas equal cv2's (OpenCV 5.0), the order
of the contours included (``tests/test_torch_port_etl.py``).
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
    each [N, 2] int (x, y), compressed as ``CHAIN_APPROX_SIMPLE`` does, in
    cv2's order: the component met last in a raster scan first."""
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
    return contours[::-1]


def arc_length(pts: np.ndarray, closed: bool = True) -> float:
    """``cv2.arcLength``: each segment's length in float32 (``std::sqrt``
    of a float), summed in float64 in order, a closed curve starting with
    its last point's segment."""
    p = pts.astype(np.float32).reshape(-1, 2)
    if len(p) <= 1:
        return 0.0
    seg = np.diff(np.concatenate([p[-1:], p]) if closed else p, axis=0)
    lengths = np.sqrt((seg * seg).sum(1, dtype=np.float32)).astype(np.float64)
    return float(np.cumsum(lengths)[-1])  # cumsum adds in order, as the C loop does


def contour_area(pts: np.ndarray) -> float:
    """``cv2.contourArea(pts)`` (not oriented): the shoelace sum from the
    last point, exact for integer points."""
    p = pts.astype(np.float64).reshape(-1, 2)
    if len(p) == 0:
        return 0.0
    prev = np.roll(p, 1, axis=0)
    terms = prev[:, 0] * p[:, 1] - prev[:, 1] * p[:, 0]
    return float(abs(np.cumsum(terms)[-1] * 0.5))


def _first_max(d: np.ndarray):
    """(index, value) of the first largest element of ``d`` that is above 0
    (OpenCV's ``if (dist > max_dist)`` from 0); (None, 0.0) where none is."""
    k = int(d.argmax()) if len(d) else 0
    if not len(d) or d[k] <= 0:
        return None, 0.0
    return k, float(d[k])


def _segment_dist2(q: np.ndarray, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Squared distance of each point of ``q`` to the segment a-b: to a
    where the projection falls before a, to b where it falls after b, else
    the squared cross product over the squared length."""
    d = b - a
    rel = q - a
    t = rel @ d
    l2 = d @ d
    cross = rel[:, 1] * d[0] - rel[:, 0] * d[1]
    to_b = q - b
    return np.where(t <= 0, (rel * rel).sum(1),
                    np.where(t >= l2, (to_b * to_b).sum(1), cross * cross / max(l2, 1e-300)))


def approx_poly_closed(pts: np.ndarray, eps: float) -> np.ndarray:
    """``cv2.approxPolyDP(pts, eps, closed=True)`` for [N, 2] integer points,
    as OpenCV 5.0 computes it (held against cv2, point for point): three
    rounds of "the point farthest from the last" choose two points a and b;
    the slices a -> b and b -> a are split, depth first, at their point
    farthest from the slice's chord as a segment (the first such point)
    while its squared distance exceeds eps^2, each final slice writing its
    start; then one pass drops the points that sit on a nearly straight run
    (OpenCV's clean-up)."""
    p = pts.astype(np.float64).reshape(-1, 2)
    n = len(p)
    if n == 0:
        return pts[:0]
    eps2 = eps * eps
    # 1. two far points: three rounds of "farthest from the last"
    pos, right, le_eps = 0, 0, False
    for _ in range(3):
        pos = (pos + right) % n
        q = p[(pos + np.arange(1, n)) % n] - p[pos]
        k, best = _first_max((q * q).sum(1))
        right = right if k is None else k + 1
        le_eps = best <= eps2
    out: List[int] = []
    stack = [] if le_eps else [((right + pos) % n, pos), (pos, (right + pos) % n)]
    if le_eps:
        out.append(pos)
    # 2. split each slice at its farthest point while that lies beyond eps
    while stack:
        s, e = stack.pop()
        span = (e - s) % n
        k = None
        if span > 1:
            k, best = _first_max(_segment_dist2(p[(s + np.arange(1, span)) % n], p[s], p[e]))
        if k is None or best <= eps2:
            out.append(s)
        else:
            mid = (s + k + 1) % n
            stack += [(mid, e), (s, mid)]
    # 3. drop the points on nearly straight runs, in place as OpenCV does
    keep = list(out)
    count = new_count = len(keep)
    start, wpos, mid, rpos = keep[-1], 0, keep[0], 1 % count
    i = 0
    while i < count and new_count > 2:
        end = keep[rpos]
        rpos = (rpos + 1) % count
        (sx, sy), (mx, my), (ex, ey) = p[start], p[mid], p[end]
        dx, dy = ex - sx, ey - sy
        dist = abs((mx - sx) * dy - (my - sy) * dx)
        inner = (mx - sx) * (ex - mx) + (my - sy) * (ey - my)
        if dist * dist <= 0.5 * eps2 * (dx * dx + dy * dy) and dx != 0 and dy != 0 and inner >= 0:
            new_count -= 1
            keep[wpos] = start = end
            wpos = (wpos + 1) % count
            mid = keep[rpos]
            rpos = (rpos + 1) % count
            i += 2
            continue
        keep[wpos] = start = mid
        wpos = (wpos + 1) % count
        mid = end
        i += 1
    return pts.reshape(-1, 2)[np.asarray(keep[:new_count])]


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
