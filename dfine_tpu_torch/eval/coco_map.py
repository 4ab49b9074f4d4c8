"""COCO-style mean average precision in numpy: the full COCOeval protocol
(a copy of ``dfine_tpu/eval/coco_map.py``, without cv2).

* greedy score-ordered matching per (image, class) at each IoU threshold,
  vectorized over thresholds;
* IoU thresholds 0.50:0.05:0.95, 101-point interpolated precision;
* area ranges all / small(<32²) / medium(32²..96²) / large(>96²);
* maxDets tiers (1, 10, 100): matching runs once at the largest tier, the
  accumulate step slices per tier;
* crowd / ignore handling: crowd GTs are ignore regions (IoU is
  intersection / prediction area, they absorb any number of predictions),
  and absorbed or out-of-area predictions count as neither TP nor FP;
* per-class AP / AR tables.

Supports boxes (xyxy absolute) and instance masks (dense [N,H,W] or RLE
dicts from ``eval/rle.py``). Masks of another size than the GT's are
resized by ``resize_nearest``, OpenCV's ``INTER_NEAREST`` rule.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from .rle import rle_area, rle_iou_matrix, rle_to_masks

IOU_THRESHOLDS = np.round(np.arange(0.5, 1.0, 0.05), 2)
RECALL_POINTS = np.linspace(0.0, 1.0, 101)

# COCO area ranges (in pixels²): all, small, medium, large
AREA_RANGES: Tuple[Tuple[str, float, float], ...] = (
    ("all", 0.0, 1e10),
    ("small", 0.0, 32.0**2),
    ("medium", 32.0**2, 96.0**2),
    ("large", 96.0**2, 1e10),
)
MAX_DETS: Tuple[int, ...] = (1, 10, 100)


def resize_nearest(masks: np.ndarray, size_hw: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(m, (w, h), interpolation=INTER_NEAREST)`` of each of
    masks [N, H, W]: destination pixel d reads source ``floor(d * scale)``
    with scale = 1 / (dst / src) in float64, clamped to the last pixel."""
    h, w = masks.shape[1:]
    oh, ow = size_hw
    ys = np.minimum(np.floor(np.arange(oh) * (1.0 / (oh / h))).astype(np.int64), h - 1)
    xs = np.minimum(np.floor(np.arange(ow) * (1.0 / (ow / w))).astype(np.int64), w - 1)
    return masks[:, ys[:, None], xs[None, :]]


def box_iou_matrix(
    a: np.ndarray, b: np.ndarray, iscrowd: Optional[np.ndarray] = None
) -> np.ndarray:
    """IoU of boxes a [Np,4] vs b [Ng,4] (xyxy).  Columns whose ``iscrowd``
    flag is set use intersection / area(a) (COCO ignore-region semantics)."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), np.float32)
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[:, None] + area_b[None] - inter
    if iscrowd is not None and np.any(iscrowd):
        union = np.where(np.asarray(iscrowd, bool)[None, :], area_a[:, None], union)
    return np.where(union > 0, inter / union, 0.0).astype(np.float32)


def mask_iou_matrix(pm, gm, iscrowd: Optional[np.ndarray] = None) -> np.ndarray:
    """IoU of masks (dense [N,H,W] arrays or lists of RLE dicts).  Crowd
    columns use intersection / area(pred).  Same-size RLE inputs never touch
    dense pixels: the run-length-native path (rle.rle_iou_matrix) is O(runs)
    per pair."""
    if (
        isinstance(pm, list)
        and isinstance(gm, list)
        and (not pm or not gm or pm[0]["size"] == gm[0]["size"])
    ):
        return rle_iou_matrix(pm, gm, iscrowd=iscrowd)
    if isinstance(pm, list):
        pm = rle_to_masks(pm) if pm else np.zeros((0, 1, 1), np.uint8)
    if isinstance(gm, list):
        gm = rle_to_masks(gm) if gm else np.zeros((0, 1, 1), np.uint8)
    if len(pm) == 0 or len(gm) == 0:
        return np.zeros((len(pm), len(gm)), np.float32)
    if pm.shape[1:] != gm.shape[1:]:
        # cross-resolution: nearest-resize the predictions to the GT size
        pm = resize_nearest(pm.astype(np.uint8), gm.shape[1:])
    p = pm.astype(np.float32).reshape(len(pm), -1)
    g = gm.astype(np.float32).reshape(len(gm), -1)
    inter = p @ g.T
    union = p.sum(1, keepdims=True) + g.sum(1, keepdims=True).T - inter
    if iscrowd is not None and np.any(iscrowd):
        union = np.where(
            np.asarray(iscrowd, bool)[None, :], p.sum(1, keepdims=True), union
        )
    return np.where(union > 0, inter / union, 0.0).astype(np.float32)


def _match_image(
    iou: np.ndarray,  # [Np, Ng] preds score-sorted, gts ignore-sorted
    thresholds: np.ndarray,
    gt_ignore: np.ndarray,  # [Ng] bool (crowd or out-of-area)
    gt_crowd: np.ndarray,  # [Ng] bool (reusable ignore regions)
) -> Tuple[np.ndarray, np.ndarray]:
    """COCO greedy matching, vectorized over thresholds.

    Each prediction (in score order) takes, per threshold t:
      1. the untaken NON-ignored GT with the highest IoU >= t, else
      2. the highest-IoU ignored GT >= t (crowd GTs are never "taken";
         non-crowd ignored GTs are taken once) — the match then marks the
         prediction ignored rather than TP.
    Ties go to the earlier GT (GTs arrive ignore-sorted, preserving original
    order within each group — pycocotools' strict-improvement scan).

    Returns (matched [T,Np] bool, match_ignored [T,Np] bool).
    """
    np_, ng = iou.shape
    t = np.minimum(np.asarray(thresholds, np.float64), 1.0 - 1e-10)[:, None]  # [T,1]
    t_count = len(thresholds)
    matched = np.zeros((t_count, np_), bool)
    match_ig = np.zeros((t_count, np_), bool)
    if ng == 0 or np_ == 0:
        return matched, match_ig

    # detections whose best IoU is below the lowest threshold can never
    # match, never take a GT, and never perturb later detections -> skip
    # them in the sequential scan entirely (typically most of the 300
    # unthresholded preds per image are such noise)
    live = np.nonzero(iou.max(1) >= float(t.min()))[0]

    taken = np.zeros((t_count, ng), bool)
    gi = gt_ignore[None, :]  # [1,Ng]
    for p in live:
        row = iou[p][None, :]  # [1,Ng]
        # candidate non-ignored: untaken, iou >= t
        cand = (~taken) & (~gi) & (row >= t)
        val = np.where(cand, row, -1.0)
        best = val.argmax(1)  # first max == earliest gt
        ok = val[np.arange(t_count), best] >= 0
        # candidate ignored: crowd reusable, non-crowd-ignored taken once
        cand_i = gi & (~taken | gt_crowd[None, :]) & (row >= t)
        val_i = np.where(cand_i, row, -1.0)
        best_i = val_i.argmax(1)
        ok_i = (~ok) & (val_i[np.arange(t_count), best_i] >= 0)

        m = np.where(ok, best, np.where(ok_i, best_i, -1))
        hit = m >= 0
        take = hit & ~gt_crowd[np.maximum(m, 0)]
        taken[np.arange(t_count)[take], m[take]] = True
        matched[:, p] = hit
        match_ig[:, p] = hit & gi[0, np.maximum(m, 0)]
    return matched, match_ig


def _box_area(b: np.ndarray) -> np.ndarray:
    if len(b) == 0:
        return np.zeros((0,), np.float64)
    return ((b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])).astype(np.float64)


def _mask_area(m) -> np.ndarray:
    if isinstance(m, list):
        return np.asarray([rle_area(r) for r in m], np.float64)
    if len(m) == 0:
        return np.zeros((0,), np.float64)
    return np.asarray(m, bool).reshape(len(m), -1).sum(1).astype(np.float64)


def _precision_recall(
    scores: np.ndarray, tps: np.ndarray, fps: np.ndarray, npig: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Accumulate one (class, area, maxDet) cell.  scores [N] (concat over
    images), tps/fps [T, N] bool.  Returns (ap [T], ar [T])."""
    t_count = tps.shape[0]
    order = np.argsort(-scores, kind="mergesort")
    tp_c = np.cumsum(tps[:, order], axis=1, dtype=np.float64)
    fp_c = np.cumsum(fps[:, order], axis=1, dtype=np.float64)
    nd = tp_c.shape[1]
    ap = np.zeros(t_count)
    ar = np.zeros(t_count)
    for ti in range(t_count):
        tpc, fpc = tp_c[ti], fp_c[ti]
        rc = tpc / npig
        pr = tpc / np.maximum(tpc + fpc, np.finfo(np.float64).eps)
        ar[ti] = rc[-1] if nd else 0.0
        if nd:
            # precision envelope (monotone non-increasing from the right)
            pr = np.maximum.accumulate(pr[::-1])[::-1]
            inds = np.searchsorted(rc, RECALL_POINTS, side="left")
            q = np.where(inds < nd, pr[np.minimum(inds, nd - 1)], 0.0)
            ap[ti] = q.mean()
    return ap, ar


def compute_map(
    preds: Sequence[Dict],
    gts: Sequence[Dict],
    iou_type: str = "bbox",  # bbox | segm
    max_dets: Sequence[int] = MAX_DETS,
    area_ranges: Sequence[Tuple[str, float, float]] = AREA_RANGES,
    thresholds: Optional[np.ndarray] = None,
    max_det: Optional[int] = None,  # back-compat: overrides max(max_dets)
) -> Dict[str, float]:
    """Full COCOeval over per-image dicts.

    preds[i]: {'labels' [N], 'scores' [N], 'boxes' [N,4] xyxy abs |
               'masks' dense [N,H,W] or RLE list}
    gts[i]:   {'labels' [M], 'boxes'/'masks', optional 'iscrowd' [M] bool}

    Returns the torchmetrics-style key set: map, map_50, map_75,
    map_small/medium/large, mar_1/10/100 (per max_dets tier),
    mar_small/medium/large, map_per_class {cls: ap}, mar_100_per_class.
    Area/size metrics are NaN-free: cells with no GT are excluded; if a
    whole metric has no populated cell it reports -1.0 (COCOeval
    convention).
    """
    thresholds = IOU_THRESHOLDS if thresholds is None else np.asarray(thresholds)
    max_dets = sorted(int(m) for m in ([max_det] if max_det else max_dets))
    top_det = max_dets[-1]
    classes = set()
    for g in gts:
        classes.update(int(x) for x in np.asarray(g["labels"]).reshape(-1))
    for p in preds:
        classes.update(int(x) for x in np.asarray(p["labels"]).reshape(-1))
    classes = sorted(classes)
    n_area = len(area_ranges)
    t_count = len(thresholds)

    # eval state per (class, area): lists over images
    state = {
        (c, a): {"scores": [], "tps": [], "fps": [], "npig": 0}
        for c in classes
        for a in range(n_area)
    }

    for pred, gt in zip(preds, gts):
        p_labels = np.asarray(pred["labels"]).astype(int).reshape(-1)
        p_scores = np.asarray(pred["scores"]).astype(np.float32).reshape(-1)
        g_labels = np.asarray(gt["labels"]).astype(int).reshape(-1)
        g_crowd = np.asarray(
            gt.get("iscrowd", np.zeros(len(g_labels), bool)), bool
        ).reshape(-1)
        if iou_type == "bbox":
            p_geo = np.asarray(pred["boxes"], np.float32).reshape(-1, 4)
            g_geo = np.asarray(gt["boxes"], np.float32).reshape(-1, 4)
            p_area_all, g_area_all = _box_area(p_geo), _box_area(g_geo)
        else:
            # None == no masks for this image (e.g. zero kept predictions)
            p_geo = pred.get("masks")
            g_geo = gt.get("masks")
            p_geo = [] if p_geo is None else p_geo
            g_geo = [] if g_geo is None else g_geo
            p_area_all, g_area_all = _mask_area(p_geo), _mask_area(g_geo)

        for c in classes:
            g_sel = np.nonzero(g_labels == c)[0]
            p_sel = np.nonzero(p_labels == c)[0]
            if len(g_sel) == 0 and len(p_sel) == 0:
                continue
            # score-sort dts, truncate to the largest tier (COCOeval matches
            # once at maxDets[-1]; smaller tiers slice at accumulate)
            order = np.argsort(-p_scores[p_sel], kind="mergesort")[:top_det]
            p_sel = p_sel[order]
            scores = p_scores[p_sel].astype(np.float64)
            d_area = p_area_all[p_sel]
            g_area = g_area_all[g_sel]
            crowd = g_crowd[g_sel]

            match_cache: Dict[bytes, tuple] = {}
            for a, (_, a_lo, a_hi) in enumerate(area_ranges):
                gt_ig = crowd | (g_area < a_lo) | (g_area > a_hi)
                cell = state[(c, a)]
                npig = int((~gt_ig).sum())
                cell["npig"] += npig
                if len(p_sel) == 0:
                    continue
                # ignore-sort gts (stable: original order within groups)
                gtind = np.argsort(gt_ig, kind="mergesort")
                if a == 0:
                    # IoU is area-independent: compute once, reuse per range
                    if iou_type == "bbox":
                        iou_full = box_iou_matrix(
                            p_geo[p_sel], g_geo[g_sel], iscrowd=crowd
                        )
                    else:
                        pm = (
                            [p_geo[i] for i in p_sel]
                            if isinstance(p_geo, list)
                            else p_geo[p_sel]
                        )
                        gm = (
                            [g_geo[i] for i in g_sel]
                            if isinstance(g_geo, list)
                            else g_geo[g_sel]
                        )
                        iou_full = mask_iou_matrix(pm, gm, iscrowd=crowd)
                # matching depends on the geometry only through gt_ig;
                # ranges that ignore the same GT subset share the result
                key = gt_ig.tobytes()
                if key not in match_cache:
                    match_cache[key] = _match_image(
                        iou_full[:, gtind], thresholds, gt_ig[gtind], crowd[gtind]
                    )
                matched, match_ig = match_cache[key]
                # unmatched dts outside the area range are ignored, not FPs
                out_of_rng = (d_area < a_lo) | (d_area > a_hi)
                dt_ig = match_ig | (~matched & out_of_rng[None, :])
                cell["scores"].append(scores)
                cell["tps"].append(matched & ~dt_ig)
                cell["fps"].append(~matched & ~dt_ig)

    # ---- accumulate: AP/AR per (class, area, maxDet tier)
    nan = np.nan
    ap_cell = np.full((len(classes), n_area, t_count), nan)
    ar_cell = np.full((len(classes), n_area, len(max_dets), t_count), nan)
    for ci, c in enumerate(classes):
        for a in range(n_area):
            cell = state[(c, a)]
            if cell["npig"] == 0:
                continue
            if cell["scores"]:
                for mi, md in enumerate(max_dets):
                    scores = np.concatenate([s[:md] for s in cell["scores"]])
                    tps = np.concatenate([t_[:, :md] for t_ in cell["tps"]], axis=1)
                    fps = np.concatenate([f[:, :md] for f in cell["fps"]], axis=1)
                    ap, ar = _precision_recall(scores, tps, fps, cell["npig"])
                    if md == top_det:
                        ap_cell[ci, a] = ap
                    ar_cell[ci, a, mi] = ar
            else:
                ap_cell[ci, a] = 0.0
                ar_cell[ci, a] = 0.0

    def _mean(x) -> float:
        x = x[~np.isnan(x)]
        return float(x.mean()) if x.size else -1.0

    t50 = int(np.argmin(np.abs(thresholds - 0.5)))
    t75 = int(np.argmin(np.abs(thresholds - 0.75)))
    a_idx = {name: i for i, (name, _, _) in enumerate(area_ranges)}
    mi_last = len(max_dets) - 1

    out: Dict[str, float] = {
        "map": _mean(ap_cell[:, a_idx["all"]]),
        "map_50": _mean(ap_cell[:, a_idx["all"], t50]),
        "map_75": _mean(ap_cell[:, a_idx["all"], t75]),
    }
    for name in ("small", "medium", "large"):
        if name in a_idx:
            out[f"map_{name}"] = _mean(ap_cell[:, a_idx[name]])
            out[f"mar_{name}"] = _mean(ar_cell[:, a_idx[name], mi_last])
    for mi, md in enumerate(max_dets):
        out[f"mar_{md}"] = _mean(ar_cell[:, a_idx["all"], mi])
    out["map_per_class"] = {
        c: _mean(ap_cell[ci, a_idx["all"]]) for ci, c in enumerate(classes)
    }
    out["mar_per_class"] = {
        c: _mean(ar_cell[ci, a_idx["all"], mi_last]) for ci, c in enumerate(classes)
    }
    # empty-eval back-compat: round-2 callers treat 0.0 as "nothing to score"
    if not classes:
        out.update({"map": 0.0, "map_50": 0.0, "map_75": 0.0})
    return out
