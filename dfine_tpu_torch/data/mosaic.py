"""Mosaic augmentation and random affine (port of
``dfine_tpu/data/mosaic.py``, without cv2).

Four images are placed on a 2x canvas around a jittered centre, then one
random affine (rotate / scale / shear / translate) maps the canvas to the
output size with ``augment.warp_affine``. Boxes and polygons ride the same
matrices; degenerate results are filtered by size and aspect ratio. The
draws from ``rng`` come in the JAX package's order.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np

from .augment import _apply_affine_to_geoms, rotation_matrix, warp_affine


def random_affine(
    sample: Dict,
    rng: np.random.Generator,
    out_hw,
    degrees: float = 0.0,
    translate: float = 0.2,
    scale_range=(0.5, 1.5),
    shear: float = 2.0,
) -> Dict:
    oh, ow = out_hw
    h, w = sample["image"].shape[:2]

    c = np.eye(3, dtype=np.float32)
    c[0, 2] = -w / 2
    c[1, 2] = -h / 2

    r = np.eye(3, dtype=np.float32)
    a = rng.uniform(-degrees, degrees)
    s = rng.uniform(*scale_range)
    r[:2] = rotation_matrix((0, 0), a, s)

    sh = np.eye(3, dtype=np.float32)
    sh[0, 1] = math.tan(rng.uniform(-shear, shear) * math.pi / 180)
    sh[1, 0] = math.tan(rng.uniform(-shear, shear) * math.pi / 180)

    t = np.eye(3, dtype=np.float32)
    t[0, 2] = rng.uniform(0.5 - translate, 0.5 + translate) * ow
    t[1, 2] = rng.uniform(0.5 - translate, 0.5 + translate) * oh

    M = (t @ sh @ r @ c)[:2]
    sample["image"] = warp_affine(sample["image"], M, (ow, oh))

    sample = _apply_affine_to_geoms(sample, M, ow, oh, clip=True)
    # aspect-ratio guard on the surviving boxes (size already filtered)
    if len(sample["boxes"]):
        b = sample["boxes"]
        w2, h2 = b[:, 2] - b[:, 0], b[:, 3] - b[:, 1]
        ar = np.maximum(w2 / (h2 + 1e-16), h2 / (w2 + 1e-16))
        keep = ar < 100
        sample["boxes"] = b[keep]
        sample["labels"] = sample["labels"][keep]
        if sample.get("polygons") is not None:
            sample["polygons"] = [p for p, k in zip(sample["polygons"], keep) if k]
    return sample


def build_mosaic(
    samples: List[Dict],
    rng: np.random.Generator,
    out_hw,
    mosaic_augs: Dict,
) -> Dict:
    """Compose 4 samples into one (then ``random_affine`` to ``out_hw``)."""
    oh, ow = out_hw
    ch, cw = oh * 2, ow * 2
    canvas = np.full((ch, cw, 3), 114, np.uint8)
    cx = int(rng.uniform(ow * 0.5, ow * 1.5))
    cy = int(rng.uniform(oh * 0.5, oh * 1.5))

    all_boxes, all_labels, all_polys = [], [], []
    has_polys = samples[0].get("polygons") is not None

    for i, s in enumerate(samples):
        img = s["image"]
        h, w = img.shape[:2]
        if i == 0:  # top-left
            x1a, y1a, x2a, y2a = max(cx - w, 0), max(cy - h, 0), cx, cy
            x1b, y1b = w - (x2a - x1a), h - (y2a - y1a)
            x2b, y2b = w, h
        elif i == 1:  # top-right
            x1a, y1a, x2a, y2a = cx, max(cy - h, 0), min(cx + w, cw), cy
            x1b, y1b = 0, h - (y2a - y1a)
            x2b, y2b = x2a - x1a, h
        elif i == 2:  # bottom-left
            x1a, y1a, x2a, y2a = max(cx - w, 0), cy, cx, min(cy + h, ch)
            x1b, y1b = w - (x2a - x1a), 0
            x2b, y2b = w, y2a - y1a
        else:  # bottom-right
            x1a, y1a, x2a, y2a = cx, cy, min(cx + w, cw), min(cy + h, ch)
            x1b, y1b = 0, 0
            x2b, y2b = x2a - x1a, y2a - y1a
        canvas[y1a:y2a, x1a:x2a] = img[y1b:y2b, x1b:x2b]
        dx, dy = x1a - x1b, y1a - y1b

        if len(s["boxes"]):
            b = s["boxes"].copy()
            b[:, [0, 2]] += dx
            b[:, [1, 3]] += dy
            all_boxes.append(b)
            all_labels.append(s["labels"])
            if has_polys:
                all_polys.extend([p + np.asarray([dx, dy], np.float32) for p in s["polygons"]])

    merged = {
        "image": canvas,
        "boxes": np.concatenate(all_boxes, 0) if all_boxes else np.zeros((0, 4), np.float32),
        "labels": np.concatenate(all_labels, 0) if all_labels else np.zeros((0,), np.int32),
    }
    if has_polys:
        merged["polygons"] = all_polys
    merged["boxes"][:, [0, 2]] = merged["boxes"][:, [0, 2]].clip(0, cw)
    merged["boxes"][:, [1, 3]] = merged["boxes"][:, [1, 3]].clip(0, ch)

    return random_affine(
        merged,
        rng,
        out_hw,
        degrees=mosaic_augs.get("degrees", 0.0),
        translate=mosaic_augs.get("translate", 0.2),
        scale_range=tuple(mosaic_augs.get("mosaic_scale", (0.5, 1.5))),
        shear=mosaic_augs.get("shear", 2.0),
    )
