"""Image and geometry augmentations in numpy (port of
``dfine_tpu/data/augment.py``, without cv2).

Every aug draws from the caller's ``np.random.Generator`` in the JAX
package's order, each probability gate included whether it fires or not,
so a sample seeded alike comes out alike. Geometric ops move boxes (xyxy
absolute) and polygons together.

The cv2 calls of the JAX package, reproduced in numpy as OpenCV 5.0
computes them for uint8 images (``tests/test_torch_port_data.py`` holds each
against cv2):

- ``resize_linear`` (``cv2.resize``, ``INTER_LINEAR``): source positions
  ``(d + 0.5) * scale - 0.5`` in float32, 11-bit weights (``* 2048``,
  rounded), the columns clamped at the borders with their weights, the rows
  clamped with theirs kept; a horizontal pass in integers, then OpenCV's
  vector form of the vertical pass, ``((S0 >> 4) * b0 >> 16) + ((S1 >> 4) *
  b1 >> 16)``, rounded ``(+2) >> 2``. Bit-equal.
- ``warp_affine`` (``cv2.warpAffine``, ``INTER_LINEAR``, constant border):
  the inverse map in float64, cast to float32; source coordinates
  ``fma(m0, x, m1 * y + m2)`` in float32, bilinear by fused multiply-adds
  in float32 over the four neighbours (a neighbour outside the image is the
  border value), rounded half to even. Bit-equal on the tested maps; an FMA
  emulated in float64 can round twice, so a pixel may come out 1 apart.
- ``gaussian_blur`` (``cv2.GaussianBlur(img, (k, k), 0)``): for k in {3, 5,
  7} OpenCV takes its fixed small kernels (sigma 0.3((k-1)0.5-1)+0.8 is the
  rule only beyond 7), exact in 8 fractional bits; separable, reflect-101
  borders, rounded ``(+2^15) >> 16``. Bit-equal.
- ``rgb_to_gray`` (``COLOR_RGB2GRAY``): ``(9798 R + 19235 G + 3735 B +
  2^14) >> 15``, OpenCV 5.0's weights (bit-equal on all 2^24 colours; the
  14-bit ``4899/9617/1868`` of older OpenCV differ on 0.25 % of them).
- ``rotation_matrix`` (``cv2.getRotationMatrix2D``): the closed form.
- ``resize_area`` (``cv2.resize``, ``INTER_AREA``, shrinking): block sums
  at integer factors, float32 area weights otherwise. Bit-equal.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np

from .labels import clip_polygon

_SMALL_GAUSSIAN = {3: (64, 128, 64), 5: (16, 64, 96, 64, 16),
                   7: (8, 28, 56, 72, 56, 28, 8)}  # x 1/256


# --------------------------------------------------------- cv2 in numpy --


def _linear_coeffs(src: int, dst: int, clamp: bool):
    """Source indices and 11-bit weights of ``cv2.resize``'s linear rule."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = f - s.astype(np.float32)
    if clamp:  # columns: clamped with their weights
        f[s < 0] = 0
        s[s < 0] = 0
        hi = s >= src - 1
        f[hi] = 0
        s[hi] = src - 1
    w0 = np.rint((np.float32(1) - f) * np.float32(2048)).astype(np.int32)
    w1 = np.rint(f * np.float32(2048)).astype(np.int32)
    return np.clip(s, 0, src - 1), np.clip(s + 1, 0, src - 1), w0, w1


def resize_linear(img: np.ndarray, size_wh: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, (w, h), interpolation=INTER_LINEAR)`` on uint8
    [H, W] or [H, W, C] (see the module doc)."""
    ow, oh = size_wh
    h, w = img.shape[:2]
    src = img.reshape(h, w, -1).astype(np.int32)
    x0, x1, a0, a1 = _linear_coeffs(w, ow, clamp=True)
    y0, y1, b0, b1 = _linear_coeffs(h, oh, clamp=False)
    rows = src[:, x0] * a0[None, :, None] + src[:, x1] * a1[None, :, None]
    out = ((((rows[y0] >> 4) * b0[:, None, None]) >> 16)
           + (((rows[y1] >> 4) * b1[:, None, None]) >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8).reshape((oh, ow) + img.shape[2:])


def _area_tab(src: int, dst: int, scale: float):
    """``computeResizeAreaTab``: for each destination index, the source
    indices it covers and their float32 weights, in source order, as
    [dst, slots] arrays (index, weight; weight 0 in unused slots)."""
    rows = []
    for d in range(dst):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, src - f1)
        s2 = min(math.floor(f2), src - 1)
        s1 = min(math.ceil(f1), s2)
        row = []
        if s1 - f1 > 1e-3:
            row.append((s1 - 1, (s1 - f1) / cell))
        row += [(s, 1.0 / cell) for s in range(s1, s2)]
        if f2 - s2 > 1e-3:
            row.append((s2, min(min(f2 - s2, 1.0), cell) / cell))
        rows.append(row)
    slots = max(len(r) for r in rows)
    idx = np.zeros((dst, slots), np.int64)
    wt = np.zeros((dst, slots), np.float32)
    for d, row in enumerate(rows):
        for k, (s, a) in enumerate(row):
            idx[d, k], wt[d, k] = s, a
    return idx, wt


def resize_area(img: np.ndarray, size_wh: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, (w, h), interpolation=INTER_AREA)`` on uint8
    [H, W] or [H, W, C], shrinking in both directions, as OpenCV 5.0
    computes it:

    - integer factors (``resizeAreaFast``): each output the sum of its
      source block; 2x2 blocks (1, 3 or 4 channels) ``(sum + 2) >> 2``, any
      other block ``sum * float32(1 / area)`` rounded half to even;
    - other factors (``resizeArea_``): float32 weights per source column
      and row (a partly covered cell weighs its covered share over the cell
      width), a horizontal pass per source row and a vertical one, each
      summing its terms in source order in float32, then rounded half to
      even."""
    ow, oh = size_wh
    h, w = img.shape[:2]
    if ow > w or oh > h or ow < 1 or oh < 1:
        raise ValueError(f"resize_area shrinks only: {w}x{h} -> {ow}x{oh}")
    src = img.reshape(h, w, -1)
    sx, sy = 1.0 / (ow / w), 1.0 / (oh / h)  # cv::resize's scale_x, scale_y
    ix, iy = round(sx), round(sy)
    if abs(sx - ix) < 2.220446049250313e-16 and abs(sy - iy) < 2.220446049250313e-16:
        blocks = src[: oh * iy, : ow * ix].astype(np.int64).reshape(oh, iy, ow, ix, -1)
        total = blocks.sum((1, 3))
        if ix == iy == 2 and src.shape[2] in (1, 3, 4):
            out = (total + 2) >> 2
        else:
            out = np.rint(total.astype(np.float32) * np.float32(1.0 / (ix * iy)))
    else:
        xi, xw = _area_tab(w, ow, sx)
        yi, yw = _area_tab(h, oh, sy)
        srcf = src.astype(np.float32)
        rows = np.zeros((h, ow, src.shape[2]), np.float32)
        for k in range(xi.shape[1]):  # the horizontal pass, term by term
            rows = rows + srcf[:, xi[:, k]] * xw[:, k, None]
        acc = np.zeros((oh, ow, src.shape[2]), np.float32)
        for k in range(yi.shape[1]):  # the vertical pass, term by term
            acc = acc + yw[:, k, None, None] * rows[yi[:, k]]
        out = np.rint(acc)
    return np.clip(out, 0, 255).astype(np.uint8).reshape((oh, ow) + img.shape[2:])


def _fma32(a, b, c) -> np.ndarray:
    """float32 fused multiply-add (the product is exact in float64)."""
    return (np.asarray(a, np.float64) * b + c).astype(np.float32)


def warp_affine(img: np.ndarray, M: np.ndarray, size_wh: Tuple[int, int],
                border_value: int = 114) -> np.ndarray:
    """``cv2.warpAffine(img, M, (w, h), flags=INTER_LINEAR,
    borderValue=(v, v, v))`` on uint8 [H, W, C] (see the module doc)."""
    ow, oh = size_wh
    h, w = img.shape[:2]
    m = np.asarray(M, np.float64).reshape(-1)
    det = m[0] * m[4] - m[1] * m[3]
    det = 1.0 / det if det != 0 else 0.0
    a11, a22 = m[4] * det, m[0] * det
    a12, a21 = -m[1] * det, -m[3] * det
    b1 = -a11 * m[2] - a12 * m[5]
    b2 = -a21 * m[2] - a22 * m[5]
    inv = np.asarray([a11, a12, b1, a21, a22, b2]).astype(np.float32)
    xs = np.arange(ow, dtype=np.float32)[None, :]
    ys = np.arange(oh, dtype=np.float32)[:, None]
    sx = _fma32(inv[0], xs, inv[1] * ys + inv[2])
    sy = _fma32(inv[3], xs, inv[4] * ys + inv[5])
    ix, iy = np.floor(sx), np.floor(sy)
    ax, ay = (sx - ix)[..., None], (sy - iy)[..., None]
    # one pixel of border around the source: an index clamped to it reads the border value
    src = np.pad(img.reshape(h, w, -1), ((1, 1), (1, 1), (0, 0)),
                 constant_values=border_value).astype(np.float32)
    x0, x1 = (np.clip(v, -1, w).astype(np.int64) + 1 for v in (ix, ix + 1))
    y0, y1 = (np.clip(v, -1, h).astype(np.int64) + 1 for v in (iy, iy + 1))
    p00, p01, p10, p11 = src[y0, x0], src[y0, x1], src[y1, x0], src[y1, x1]
    v0 = _fma32(ax, p01 - p00, p00)
    v1 = _fma32(ax, p11 - p10, p10)
    out = np.rint(_fma32(ay, v1 - v0, v0))
    return np.clip(out, 0, 255).astype(np.uint8).reshape((oh, ow) + img.shape[2:])


def _reflect101(n: int, r: int) -> np.ndarray:
    idx = np.abs(np.arange(-r, n + r))
    return np.where(idx >= n, 2 * (n - 1) - idx, idx)


def gaussian_blur(img: np.ndarray, k: int) -> np.ndarray:
    """``cv2.GaussianBlur(img, (k, k), 0)`` on uint8, k in {3, 5, 7}."""
    if k not in _SMALL_GAUSSIAN:
        raise ValueError(f"gaussian_blur takes k in {sorted(_SMALL_GAUSSIAN)}, got {k}")
    kern = np.asarray(_SMALL_GAUSSIAN[k], np.int32)
    h, w = img.shape[:2]
    r = k // 2
    src = img.astype(np.int32)  # sums stay under 255 * 2^16
    xi, yi = _reflect101(w, r), _reflect101(h, r)
    rows = sum(kern[i] * src[:, xi[i:i + w]] for i in range(k))
    out = sum(kern[i] * rows[yi[i:i + h]] for i in range(k))
    return ((out + (1 << 15)) >> 16).astype(np.uint8)


def rgb_to_gray(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, COLOR_RGB2GRAY)`` on uint8 [H, W, 3]."""
    r, g, b = (img[..., i].astype(np.int32) for i in range(3))
    return ((9798 * r + 19235 * g + 3735 * b + (1 << 14)) >> 15).astype(np.uint8)


def rotation_matrix(center: Tuple[float, float], angle: float, scale: float) -> np.ndarray:
    """``cv2.getRotationMatrix2D(center, angle, scale)`` (float64 [2, 3];
    the centre goes through float32 as OpenCV's ``Point2f``)."""
    cx, cy = (float(np.float32(v)) for v in center)
    a = math.radians(angle)
    alpha, beta = math.cos(a) * scale, math.sin(a) * scale
    return np.asarray([[alpha, beta, (1 - alpha) * cx - beta * cy],
                       [-beta, alpha, beta * cx + (1 - alpha) * cy]], np.float64)


# ------------------------------------------------------------- photometric


def aug_brightness_contrast(img, rng, limit=0.2):
    alpha = 1.0 + rng.uniform(-limit, limit)
    beta = rng.uniform(-limit, limit) * 255 * 0.5
    return np.clip(img.astype(np.float32) * alpha + beta, 0, 255).astype(np.uint8)


def aug_gamma(img, rng, limit=(80, 120)):
    g = rng.uniform(*limit) / 100.0
    lut = (np.linspace(0, 1, 256) ** g * 255).astype(np.uint8)
    return lut[img]


def aug_blur(img, rng, max_k=7):
    k = int(rng.integers(1, max_k // 2 + 1)) * 2 + 1
    return gaussian_blur(img, k)


def aug_gauss_noise(img, rng, var_limit=(10.0, 50.0)):
    sigma = math.sqrt(rng.uniform(*var_limit))
    noise = rng.normal(0.0, sigma, img.shape).astype(np.float32)
    return np.clip(img.astype(np.float32) + noise, 0, 255).astype(np.uint8)


def aug_to_gray(img, rng=None):
    g = rgb_to_gray(img)
    return np.stack([g, g, g], -1)


def aug_coarse_dropout(img, rng, max_holes=8, max_frac=0.1):
    img = img.copy()
    h, w = img.shape[:2]
    for _ in range(int(rng.integers(1, max_holes + 1))):
        hh = int(rng.uniform(0.02, max_frac) * h)
        ww = int(rng.uniform(0.02, max_frac) * w)
        y = int(rng.integers(0, max(1, h - hh)))
        x = int(rng.integers(0, max(1, w - ww)))
        img[y : y + hh, x : x + ww] = 114
    return img


# --------------------------------------------------------------- geometric


def _apply_affine_to_geoms(sample, M, out_w, out_h, clip=True, min_size=2.0):
    """Transform boxes/polygons by a 2x3 affine M, clip, filter degenerates."""
    boxes = sample["boxes"]
    polys = sample.get("polygons")
    n = len(boxes)
    if n == 0:
        return sample

    if polys is not None:
        new_polys, new_boxes, keep = [], [], []
        for poly in polys:
            pts = np.concatenate([poly, np.ones((len(poly), 1), np.float32)], 1) @ M.T
            if clip:
                pts = clip_polygon(pts, out_w, out_h)
            if len(pts) < 3:
                keep.append(False)
                new_polys.append(np.zeros((0, 2), np.float32))
                new_boxes.append([0, 0, 0, 0])
                continue
            x0, y0 = pts.min(0)
            x1, y1 = pts.max(0)
            keep.append((x1 - x0) >= min_size and (y1 - y0) >= min_size)
            new_polys.append(pts)
            new_boxes.append([x0, y0, x1, y1])
        keep = np.asarray(keep, bool)
        sample["boxes"] = np.asarray(new_boxes, np.float32).reshape(-1, 4)[keep]
        sample["labels"] = sample["labels"][keep]
        sample["polygons"] = [p for p, k in zip(new_polys, keep) if k]
        return sample

    corners = np.stack([boxes[:, [0, 1]], boxes[:, [2, 1]], boxes[:, [2, 3]], boxes[:, [0, 3]]],
                       axis=1)  # [N,4,2]
    ones = np.ones((n, 4, 1), np.float32)
    pts = np.concatenate([corners, ones], -1) @ M.T  # [N,4,2]
    x0 = pts[..., 0].min(1)
    y0 = pts[..., 1].min(1)
    x1 = pts[..., 0].max(1)
    y1 = pts[..., 1].max(1)
    if clip:
        x0, x1 = np.clip(x0, 0, out_w), np.clip(x1, 0, out_w)
        y0, y1 = np.clip(y0, 0, out_h), np.clip(y1, 0, out_h)
    new = np.stack([x0, y0, x1, y1], -1).astype(np.float32)
    keep = ((x1 - x0) >= min_size) & ((y1 - y0) >= min_size)
    sample["boxes"] = new[keep]
    sample["labels"] = sample["labels"][keep]
    return sample


def aug_hflip(sample, rng=None):
    h, w = sample["image"].shape[:2]
    sample["image"] = sample["image"][:, ::-1].copy()
    M = np.asarray([[-1, 0, w], [0, 1, 0]], np.float32)
    return _apply_affine_to_geoms(sample, M, w, h, clip=False)


def aug_vflip(sample, rng=None):
    h, w = sample["image"].shape[:2]
    sample["image"] = sample["image"][::-1].copy()
    M = np.asarray([[1, 0, 0], [0, -1, h]], np.float32)
    return _apply_affine_to_geoms(sample, M, w, h, clip=False)


def aug_rot90(sample, rng):
    k = int(rng.integers(1, 4))
    h, w = sample["image"].shape[:2]
    sample["image"] = np.ascontiguousarray(np.rot90(sample["image"], k))
    mats = {
        1: np.asarray([[0, 1, 0], [-1, 0, w]], np.float32),  # 90 ccw: (x,y)->(y, w-x)
        2: np.asarray([[-1, 0, w], [0, -1, h]], np.float32),
        3: np.asarray([[0, -1, h], [1, 0, 0]], np.float32),
    }
    ow, oh = (h, w) if k % 2 == 1 else (w, h)
    return _apply_affine_to_geoms(sample, mats[k], ow, oh, clip=False)


def aug_rotate(sample, rng, max_degrees: float):
    h, w = sample["image"].shape[:2]
    deg = rng.uniform(-max_degrees, max_degrees)
    M = rotation_matrix((w / 2, h / 2), deg, 1.0).astype(np.float32)
    sample["image"] = warp_affine(sample["image"], M, (w, h))
    return _apply_affine_to_geoms(sample, M, w, h, clip=True)


def letterbox(
    image: np.ndarray, target_hw: Tuple[int, int], pad_value: int = 114, stride_align=None
) -> Tuple[np.ndarray, float, Tuple[int, int]]:
    """Aspect-preserving resize + pad. Returns (image, scale, (pad_top,
    pad_left))."""
    th, tw = target_hw
    h, w = image.shape[:2]
    scale = min(th / h, tw / w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    resized = resize_linear(image, (nw, nh))
    if stride_align:
        th = math.ceil(nh / stride_align) * stride_align
        tw = math.ceil(nw / stride_align) * stride_align
    top = (th - nh) // 2
    left = (tw - nw) // 2
    out = np.full((th, tw, 3), pad_value, np.uint8)
    out[top : top + nh, left : left + nw] = resized
    return out, scale, (top, left)


def apply_letterbox_to_geoms(sample, scale: float, pad: Tuple[int, int]):
    M = np.asarray([[scale, 0, pad[1]], [0, scale, pad[0]]], np.float32)
    h, w = sample["image"].shape[:2]
    return _apply_affine_to_geoms(sample, M, w, h, clip=False)


def plain_resize(sample, target_hw: Tuple[int, int]):
    th, tw = target_hw
    h, w = sample["image"].shape[:2]
    sample["image"] = resize_linear(sample["image"], (tw, th))
    M = np.asarray([[tw / w, 0, 0], [0, th / h, 0]], np.float32)
    return _apply_affine_to_geoms(sample, M, tw, th, clip=False)


# ---------------------------------------------------------------- pipeline


def photometric_pipeline(sample: Dict, rng: np.random.Generator, augs) -> Dict:
    """Probability-gated photometric chain: one draw per gate, in order."""
    img = sample["image"]
    if rng.uniform() < augs.get("brightness", 0):
        img = aug_brightness_contrast(img, rng)
    if rng.uniform() < augs.get("gamma", 0):
        img = aug_gamma(img, rng)
    if rng.uniform() < augs.get("blur", 0):
        img = aug_blur(img, rng)
    if rng.uniform() < augs.get("noise", 0):
        img = aug_gauss_noise(img, rng)
    if rng.uniform() < augs.get("to_gray", 0):
        img = aug_to_gray(img)
    if rng.uniform() < augs.get("coarse_dropout", 0):
        img = aug_coarse_dropout(img, rng)
    sample["image"] = img
    return sample


def geometric_pipeline(sample: Dict, rng: np.random.Generator, augs) -> Dict:
    if rng.uniform() < augs.get("left_right_flip", 0):
        sample = aug_hflip(sample)
    if rng.uniform() < augs.get("up_down_flip", 0):
        sample = aug_vflip(sample)
    if rng.uniform() < augs.get("rotate_90", 0):
        sample = aug_rot90(sample, rng)
    if rng.uniform() < augs.get("rotation_p", 0):
        sample = aug_rotate(sample, rng, augs.get("rotation_degree", 10))
    return sample
