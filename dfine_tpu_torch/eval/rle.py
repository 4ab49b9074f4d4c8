"""Run-length mask codec in numpy (a copy of ``dfine_tpu/eval/rle.py``).

COCO's convention: a column-major scan, counts alternating and starting
with a run of zeros, so that eval stays in bounded RAM at dataset scale.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


def mask_to_rle(mask: np.ndarray) -> Dict:
    """mask: [H, W] (bool/uint8) -> {'size': [H, W], 'counts': uint32[...]}"""
    h, w = mask.shape
    flat = np.asarray(mask, np.uint8).reshape(h, w).T.reshape(-1)  # column-major
    # positions where value changes
    diff = np.nonzero(flat[1:] != flat[:-1])[0] + 1
    runs = np.diff(np.concatenate([[0], diff, [flat.size]])).astype(np.uint32)
    if flat.size and flat[0] == 1:  # counts must start with a zero-run
        runs = np.concatenate([[np.uint32(0)], runs])
    return {"size": [int(h), int(w)], "counts": runs}


def rle_to_mask(rle: Dict) -> np.ndarray:
    h, w = rle["size"]
    counts = np.asarray(rle["counts"], np.int64)
    assert int(counts.sum()) == h * w, "RLE does not cover the mask"
    # vectorized expansion: run i has value i%2 (counts start with a 0-run)
    vals = (np.arange(len(counts), dtype=np.int64) & 1).astype(np.uint8)
    flat = np.repeat(vals, counts)
    return flat.reshape(w, h).T


def masks_to_rle(masks: np.ndarray) -> List[Dict]:
    return [mask_to_rle(m) for m in masks]


def rle_to_masks(rles: List[Dict]) -> np.ndarray:
    if not rles:
        return np.zeros((0, 0, 0), np.uint8)
    return np.stack([rle_to_mask(r) for r in rles], 0)


def rle_area(rle: Dict) -> int:
    counts = np.asarray(rle["counts"], np.int64)
    return int(counts[1::2].sum())


def _prep_runs(rles: List[Dict]):
    """Per mask: (starts, ends, prefix) of its 1-runs in the column-major
    flat space; prefix[k] = ones in the first k runs (prefix[-1] = area)."""
    out = []
    for r in rles:
        c = np.asarray(r["counts"], np.int64)
        ends = np.cumsum(c)
        s1, e1 = (ends - c)[1::2], ends[1::2]
        out.append((s1, e1, np.concatenate([[0], np.cumsum(e1 - s1)])))
    return out


def _ones_below(s1, e1, prefix, x):
    """Number of 1-pixels at flat positions < x (x is an int array)."""
    k = np.searchsorted(e1, x, side="left")
    k_c = np.minimum(k, len(s1) - 1)
    partial = np.where(k < len(s1), np.clip(x - s1[k_c], 0, e1[k_c] - s1[k_c]), 0)
    return prefix[k] + partial


def rle_iou_matrix(
    pred_rles: List[Dict],
    gt_rles: List[Dict],
    iscrowd: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Pairwise mask IoU computed directly on the run-length encoding — the
    numpy analog of pycocotools' C ``iou``: intersection of two RLEs is the
    sum over one mask's 1-runs of the other's coverage in that span
    (searchsorted over run boundaries), O(runs) per pair instead of O(H*W)
    dense decode + matmul.  Crowd columns use intersection / pred-area."""
    n_p, n_g = len(pred_rles), len(gt_rles)
    out = np.zeros((n_p, n_g), np.float32)
    if n_p == 0 or n_g == 0:
        return out
    pa, ga = _prep_runs(pred_rles), _prep_runs(gt_rles)
    crowd = (
        np.asarray(iscrowd, bool)
        if iscrowd is not None
        else np.zeros(n_g, bool)
    )
    for j, (sg, eg, pg) in enumerate(ga):
        if len(sg) == 0:
            continue
        area_g = pg[-1]
        g_lo, g_hi = sg[0], eg[-1]
        for i, (sp, ep, pp) in enumerate(pa):
            if len(sp) == 0 or ep[-1] <= g_lo or sp[0] >= g_hi:
                continue
            inter = int(
                (_ones_below(sg, eg, pg, ep) - _ones_below(sg, eg, pg, sp)).sum()
            )
            if inter == 0:
                continue
            area_p = pp[-1]
            union = area_p if crowd[j] else area_p + area_g - inter
            if union > 0:
                out[i, j] = inter / union
    return out
