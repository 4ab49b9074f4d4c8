"""YOLO-format label IO and polygon helpers (port of
``dfine_tpu/data/labels.py``, without cv2).

Detection rows are ``cls xc yc w h`` (normalized cxcywh); segmentation rows
are ``cls x1 y1 x2 y2 ...`` normalized polygon vertices, and boxes are
derived from the polygon extent.

``fill_poly`` is OpenCV's ``fillPoly`` (8-connected, no shift) on integer
vertices, as OpenCV 5.0 draws it: every edge is first drawn as an
8-connected Bresenham line (``LineIterator``, left to right, clipped to the
image by ``clipLine``), then the interior is filled scanline by scanline
from the edges in 16.16 fixed point: an edge covers rows y0 <= y < y1,
starts at its first vertex (an edge that leaves the image at the clipped
ends of its line), steps by its slope truncated toward zero, and each pair
of crossings fills [ceil(x_left), floor(x_right)], clipped to the image.
Against ``cv2.fillPoly`` (``tests/test_torch_port_data.py``) it is bit-equal
on polygons inside the image; on polygons that cross the image's edge a
span wholly outside may differ on the border column.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT


def parse_yolo_label_file(
    path: str | Path, segment: bool = False
) -> Tuple[np.ndarray, np.ndarray, Optional[List[np.ndarray]]]:
    """Returns (labels [N] int32, boxes [N,4] cxcywh normalized,
    polygons list of [Pi,2] normalized or None)."""
    labels, boxes, polys = [], [], []
    p = Path(path)
    if not p.exists():
        return np.zeros((0,), np.int32), np.zeros((0, 4), np.float32), ([] if segment else None)
    for line in p.read_text().splitlines():
        parts = line.split()
        if not parts:
            continue
        cls = int(float(parts[0]))
        vals = np.asarray([float(v) for v in parts[1:]], np.float32)
        if len(vals) >= 6:
            # polygon row: box from the extent in both tasks; an odd
            # coordinate count drops the trailing value
            if len(vals) % 2 == 1:
                vals = vals[:-1]
            poly = vals.reshape(-1, 2)
            x0, y0 = poly.min(0)
            x1, y1 = poly.max(0)
            boxes.append([(x0 + x1) / 2, (y0 + y1) / 2, x1 - x0, y1 - y0])
            if segment:
                polys.append(poly)
        elif len(vals) == 4:
            boxes.append(vals.tolist())
            if segment:
                # box-only row in a segmentation dataset: rectangle polygon
                xc, yc, w, h = vals
                polys.append(np.asarray([[xc - w / 2, yc - h / 2], [xc + w / 2, yc - h / 2],
                                         [xc + w / 2, yc + h / 2], [xc - w / 2, yc + h / 2]],
                                        np.float32))
        else:
            continue
        labels.append(cls)
    return (
        np.asarray(labels, np.int32),
        np.asarray(boxes, np.float32).reshape(-1, 4),
        polys if segment else None,
    )


def save_yolo_label_file(path: str | Path, labels, boxes=None, polygons=None) -> None:
    """Inverse of ``parse_yolo_label_file``."""
    lines = []
    for i, cls in enumerate(labels):
        if polygons is not None:
            pts = " ".join(f"{v:.6f}" for v in np.asarray(polygons[i]).reshape(-1))
            lines.append(f"{int(cls)} {pts}")
        else:
            b = boxes[i]
            lines.append(f"{int(cls)} {b[0]:.6f} {b[1]:.6f} {b[2]:.6f} {b[3]:.6f}")
    Path(path).write_text("\n".join(lines) + ("\n" if lines else ""))


# ------------------------------------------------------------ fillPoly --


def _trunc_div(a: int, b: int) -> int:
    """C integer division (toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def clip_line(w: int, h: int, x1: int, y1: int, x2: int, y2: int):
    """OpenCV's ``clipLine`` on [0, w-1] x [0, h-1]: (inside, x1, y1, x2, y2)."""
    right, bottom = w - 1, h - 1

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, x1, y1, x2, y2


def _draw_line(img: np.ndarray, x1: int, y1: int, x2: int, y2: int) -> None:
    """8-connected ``LineIterator(img, pt1, pt2, 8, leftToRight=True)``:
    along the major axis one pixel a step, the minor coordinate after k
    steps ceil((2 dy k - dx) / (2 dx)) (Bresenham's error term, closed)."""
    h, w = img.shape
    if not (0 <= x1 < w and 0 <= x2 < w and 0 <= y1 < h and 0 <= y2 < h):
        ok, x1, y1, x2, y2 = clip_line(w, h, x1, y1, x2, y2)
        if not ok:
            return
    if x2 < x1:
        x1, y1, x2, y2 = x2, y2, x1, y1
    dx, dy = x2 - x1, y2 - y1
    sy = -1 if dy < 0 else 1
    dy = abs(dy)
    vert = dy > dx
    major, minor = (dy, dx) if vert else (dx, dy)
    k = np.arange(major + 1, dtype=np.int64)
    m = -((major - 2 * minor * k) // (2 * major)) if major else k
    if vert:
        img[y1 + sy * k, x1 + m] = 1
    else:
        img[y1 + sy * m, x1 + k] = 1


def fill_poly(img: np.ndarray, pts: np.ndarray, value: int = 1) -> np.ndarray:
    """``cv2.fillPoly(img, [pts], value)`` for one contour of integer
    vertices on a 2-D uint8 image, in place (see the module doc)."""
    h, w = img.shape
    pts = np.asarray(pts, np.int64).reshape(-1, 2)
    drawn = np.zeros((h, w), bool)
    edges = []  # (y0, y1, x, dx) in 16.16
    n = len(pts)
    for i in range(n):
        (ax, ay), (bx, by) = pts[i - 1], pts[i]
        _draw_line(drawn, int(ax), int(ay), int(bx), int(by))
        p0x, p0y, p1x, p1y = int(ax) << XY_SHIFT, int(ay), int(bx) << XY_SHIFT, int(by)
        c0x, c0y, c1x, c1y = p0x, p0y, p1x, p1y
        if not (0 <= ax < w and 0 <= bx < w and 0 <= ay < h and 0 <= by < h):
            _, tx0, ty0, tx1, ty1 = clip_line(w, h, int(ax), int(ay), int(bx), int(by))
            if ty0 != ty1:
                c0x, c0y, c1x, c1y = tx0 << XY_SHIFT, ty0, tx1 << XY_SHIFT, ty1
        if p0y == p1y:
            continue
        dx = _trunc_div(c1x - c0x, c1y - c0y)
        if p0y < p1y:
            edges.append((p0y, p1y, c0x + (p0y - c0y) * dx, dx))
        else:
            edges.append((p1y, p0y, c1x + (p1y - c1y) * dx, dx))
    if len(edges) >= 2:
        e = np.asarray(edges, np.int64)
        y_lo, y_hi = max(int(e[:, 0].min()), 0), min(int(e[:, 1].max()), h)
        if y_hi > y_lo:
            ys = np.arange(y_lo, y_hi, dtype=np.int64)[:, None]
            active = (ys >= e[None, :, 0]) & (ys < e[None, :, 1])
            xs = e[None, :, 2] + (ys - e[None, :, 0]) * e[None, :, 3]
            xs = np.sort(np.where(active, xs, np.iinfo(np.int64).max), axis=1)
            n_act = active.sum(1)
            for j in range(0, int(n_act.max()) - 1, 2):
                rows = np.nonzero(n_act >= j + 2)[0]
                a = (xs[rows, j] + XY_ONE - 1) >> XY_SHIFT
                b = xs[rows, j + 1] >> XY_SHIFT
                keep = (a < w) & (b >= 0)
                rows, a, b = rows[keep], np.maximum(a[keep], 0), np.minimum(b[keep], w - 1)
                span = np.zeros((len(rows), w + 1), np.int32)
                np.add.at(span, (np.arange(len(rows)), a), 1)
                np.add.at(span, (np.arange(len(rows)), b + 1), -1)
                drawn[ys[rows, 0]] |= np.cumsum(span, 1)[:, :w] > 0
    img[drawn] = value
    return img


def polygons_to_masks(
    polygons: List[np.ndarray], h: int, w: int, scale: float = 1.0
) -> np.ndarray:
    """Rasterize absolute-pixel polygons to per-instance binary masks, each
    vertex rounded to the nearest pixel (half to even) after ``scale``.
    ``scale`` renders at a reduced resolution (mask targets live at the
    prediction stride so the criterion never resizes)."""
    hh, ww = int(round(h * scale)), int(round(w * scale))
    out = np.zeros((len(polygons), hh, ww), np.uint8)
    for i, poly in enumerate(polygons):
        if len(poly) < 3:
            continue
        pts = np.round(np.asarray(poly, np.float32) * scale).astype(np.int32)
        fill_poly(out[i], pts, 1)
    return out


def clip_polygon(poly: np.ndarray, w: float, h: float) -> np.ndarray:
    """Sutherland-Hodgman clip of an absolute-pixel polygon to [0,w]x[0,h]."""
    def clip_edge(pts, inside, intersect):
        out = []
        n = len(pts)
        for i in range(n):
            cur, nxt = pts[i], pts[(i + 1) % n]
            cin, nin = inside(cur), inside(nxt)
            if cin:
                out.append(cur)
                if not nin:
                    out.append(intersect(cur, nxt))
            elif nin:
                out.append(intersect(cur, nxt))
        return out

    def ix(p1, p2, axis, val):
        t = (val - p1[axis]) / (p2[axis] - p1[axis] + 1e-12)
        q = p1 + t * (p2 - p1)
        q[axis] = val
        return q

    pts = [p.astype(np.float64) for p in np.asarray(poly, np.float64)]
    for axis, val, keep_ge in ((0, 0.0, True), (0, float(w), False),
                               (1, 0.0, True), (1, float(h), False)):
        if not pts:
            break
        if keep_ge:
            pts = clip_edge(pts, lambda p: p[axis] >= val, lambda a, b: ix(a, b, axis, val))
        else:
            pts = clip_edge(pts, lambda p: p[axis] <= val, lambda a, b: ix(a, b, axis, val))
    return np.asarray(pts, np.float32).reshape(-1, 2)
