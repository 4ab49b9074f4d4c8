"""The port's eval modules (``rle``, ``coco_map``, ``Validator``; numpy, no
cv2) against the JAX package's on the same seeded ground truth and
predictions: every metric equal within EXACT, the nearest resize bit-equal
to cv2's."""

import math
import sys

import cv2
import numpy as np
import pytest

EXACT = 1e-12
NAMES = {0: "red", 1: "green", 2: "blue"}


def _box_mask(h, w, box, ellipse):
    x0, y0, x1, y1 = box
    yy, xx = np.mgrid[0:h, 0:w]
    if not ellipse:
        return ((xx >= x0) & (xx < x1) & (yy >= y0) & (yy < y1)).astype(np.uint8)
    cx, cy, rx, ry = (x0 + x1) / 2, (y0 + y1) / 2, max((x1 - x0) / 2, 1), max((y1 - y0) / 2, 1)
    return ((((xx + 0.5 - cx) / rx) ** 2 + ((yy + 0.5 - cy) / ry) ** 2) <= 1).astype(np.uint8)


def scene(rng, h=48, w=64, n_gt=(0, 7), fp=(0, 4), crowd=False):
    """One image's GT (boxes, labels, masks, maybe crowd flags) and
    predictions: each GT jittered and kept with p 0.8 (its label flipped
    with p 0.15), plus false positives; scores uniform, all_* = the kept."""
    def boxes(n):
        wh = rng.uniform(4, min(h, w) * 0.6, (n, 2))
        xy = rng.uniform(0, 1, (n, 2)) * ([w, h] - wh)
        return np.concatenate([xy, xy + wh], 1).astype(np.float32)

    g = int(rng.integers(*n_gt))
    gb = boxes(g)
    gl = rng.integers(0, 3, g)
    gm = np.stack([_box_mask(h, w, b, rng.uniform() < 0.5) for b in gb]) if g else \
        np.zeros((0, h, w), np.uint8)
    keep = rng.uniform(size=g) < 0.8
    pb = gb[keep] + rng.normal(0, 2.0, (int(keep.sum()), 4)).astype(np.float32)
    pl = np.where(rng.uniform(size=int(keep.sum())) < 0.15, (gl[keep] + 1) % 3, gl[keep])
    n_fp = int(rng.integers(*fp))
    pb = np.concatenate([pb, boxes(n_fp)], 0)
    pb[:, 2:] = np.maximum(pb[:, 2:], pb[:, :2] + 1)
    pl = np.concatenate([pl, rng.integers(0, 3, n_fp)]).astype(np.int64)
    pm = np.stack([_box_mask(h, w, b, rng.uniform() < 0.5) for b in pb]) if len(pb) else \
        np.zeros((0, h, w), np.uint8)
    scores = rng.uniform(0.05, 1.0, len(pb)).astype(np.float32)
    gt = {"labels": gl.astype(np.int64), "boxes": gb, "masks": gm}
    if crowd:
        gt["iscrowd"] = rng.uniform(size=g) < 0.2
    pred = {"labels": pl, "boxes": pb, "scores": scores, "masks": pm,
            "all_labels": pl, "all_boxes": pb, "all_scores": scores}
    return gt, pred


def assert_same(ours, ref, path="metrics"):
    """Equal trees: the same keys, ints and bools equal, floats within EXACT
    (NaN only against NaN)."""
    if isinstance(ref, dict):
        assert set(ours) == set(ref), (path, sorted(set(ours) ^ set(ref)))
        for k in ref:
            assert_same(ours[k], ref[k], f"{path}.{k}")
    elif isinstance(ref, (list, tuple, np.ndarray)):
        o, r = np.asarray(ours), np.asarray(ref)
        assert o.shape == r.shape, path
        if r.dtype.kind == "f":
            np.testing.assert_allclose(o, r, rtol=0, atol=EXACT, err_msg=path)
        else:
            np.testing.assert_array_equal(o, r, err_msg=path)
    elif isinstance(ref, float) and math.isnan(ref):
        assert math.isnan(ours), path
    elif isinstance(ref, (float, np.floating)):
        assert abs(ours - ref) <= EXACT, (path, ours, ref)
    else:
        assert ours == ref, (path, ours, ref)


@pytest.mark.parametrize("seed", range(3))
def test_rle_matches_jax(seed):
    from dfine_tpu.eval import rle as jrle

    from dfine_tpu_torch.eval import rle as prle

    rng = np.random.default_rng(seed)
    masks = (rng.uniform(size=(6, 23, 31)) < rng.uniform(0.05, 0.95, (6, 1, 1))).astype(np.uint8)
    masks[0] = 0
    masks[1] = 1
    ours, ref = prle.masks_to_rle(masks), jrle.masks_to_rle(masks)
    assert [r["size"] for r in ours] == [r["size"] for r in ref]
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a["counts"], b["counts"])
    np.testing.assert_array_equal(prle.rle_to_masks(ours), masks)
    assert [prle.rle_area(r) for r in ours] == [int(m.sum()) for m in masks]
    crowd = np.asarray([False, True, False, False, True, False])
    for iscrowd in (None, crowd):
        iou = prle.rle_iou_matrix(ours[:4], ours, iscrowd=iscrowd)
        assert iou.dtype == jrle.rle_iou_matrix(ref[:4], ref, iscrowd=iscrowd).dtype
        np.testing.assert_array_equal(iou, jrle.rle_iou_matrix(ref[:4], ref, iscrowd=iscrowd))


@pytest.mark.parametrize("src,dst", [((23, 31), (48, 64)), ((48, 64), (23, 31)),
                                     ((7, 5), (720, 1280)), ((160, 160), (720, 1280)),
                                     ((90, 160), (1080, 1920)), ((33, 17), (33, 17))])
def test_resize_nearest_is_cv2_inter_nearest(src, dst):
    from dfine_tpu_torch.eval.coco_map import resize_nearest

    m = np.random.default_rng(0).integers(0, 2, (3,) + src, dtype=np.uint8)
    ref = np.stack([cv2.resize(x, dst[::-1], interpolation=cv2.INTER_NEAREST) for x in m])
    np.testing.assert_array_equal(resize_nearest(m, dst), ref)


@pytest.mark.parametrize("iou_type,crowd,geometry", [
    ("bbox", False, "boxes"), ("bbox", True, "boxes"), ("segm", False, "dense"),
    ("segm", True, "rle"), ("segm", False, "cross_resolution")])
def test_compute_map_matches_jax(iou_type, crowd, geometry):
    """COCOeval over 12 seeded images: boxes (with crowd GTs), dense masks,
    RLEs, and prediction masks at another size than the GT's (the nearest
    resize: cv2 on the JAX side)."""
    from dfine_tpu.eval import coco_map as jmap
    from dfine_tpu.eval.rle import masks_to_rle

    from dfine_tpu_torch.eval import coco_map as pmap

    rng = np.random.default_rng({"boxes": 1, "dense": 2, "rle": 3}.get(geometry, 4))
    gts, preds = zip(*[scene(rng, crowd=crowd) for _ in range(12)])
    gts, preds = [dict(g) for g in gts], [dict(p) for p in preds]
    if geometry == "rle":
        for d in gts + preds:
            d["masks"] = masks_to_rle(d["masks"])
    elif geometry == "cross_resolution":
        for p in preds:
            p["masks"] = p["masks"][:, ::2, ::2]
    ours = pmap.compute_map(preds, gts, iou_type=iou_type)
    ref = jmap.compute_map(preds, gts, iou_type=iou_type)
    assert_same(ours, ref)
    assert ref["map"] > 0


@pytest.mark.parametrize("masks", [False, True])
def test_validator_matches_jax(masks):
    """``compute_metrics(extended=True)``, the threshold sweep and the
    confusion matrix on 16 seeded images, boxes only and with masks as RLEs
    (as the trainer gives them)."""
    from dfine_tpu.eval.rle import masks_to_rle
    from dfine_tpu.eval.validator import Validator as JValidator

    from dfine_tpu_torch.eval.validator import Validator

    rng = np.random.default_rng(10 + masks)
    gts, preds = [], []
    for _ in range(16):
        g, p = scene(rng)
        g, p = dict(g), dict(p)
        if masks:
            g["masks_rle"] = masks_to_rle(g.pop("masks"))
            p["masks_rle"] = masks_to_rle(p.pop("masks"))
        else:
            g.pop("masks"), p.pop("masks")
        gts.append(g)
        preds.append(p)
    kw = dict(conf_thresh=0.3, iou_thresh=0.5, mask_batch_size=7)
    ours, ref = Validator(gts, preds, NAMES, **kw), JValidator(gts, preds, NAMES, **kw)
    m_ours, m_ref = ours.compute_metrics(extended=True), ref.compute_metrics(extended=True)
    assert_same(m_ours, m_ref)
    assert ("mAP_50_mask" in m_ref) == masks and m_ref["TPs"] > 0
    np.testing.assert_array_equal(ours.conf_matrix, ref.conf_matrix)
    assert_same(ours.threshold_sweep(), ref.threshold_sweep())


def test_save_plots_without_matplotlib_writes_csv(tmp_path, monkeypatch):
    """Where matplotlib imports, the PNGs and the CSVs; where it does not,
    the same curves and the confusion matrix as CSV, and the writer is
    reported."""
    import csv

    from dfine_tpu_torch.eval.validator import Validator

    rng = np.random.default_rng(5)
    gts, preds = zip(*[scene(rng) for _ in range(6)])
    v = Validator(list(gts), list(preds), NAMES)
    v.compute_metrics()
    assert v.save_plots(tmp_path / "with") == "matplotlib"
    assert {p.suffix for p in (tmp_path / "with").iterdir()} == {".png", ".csv"}
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # import matplotlib now raises
    assert v.save_plots(tmp_path / "without") == "csv"
    files = sorted(p.name for p in (tmp_path / "without").iterdir())
    assert files == ["confusion_matrix.csv", "threshold_sweep.csv"]
    with open(tmp_path / "without" / "confusion_matrix.csv", newline="") as f:
        rows = list(csv.reader(f))
    assert rows[0][1:] == [NAMES[c] for c in sorted(v.class_to_idx)] + ["background"]
    np.testing.assert_array_equal(np.asarray([r[1:] for r in rows[1:]], np.int64), v.conf_matrix)
    with open(tmp_path / "without" / "threshold_sweep.csv", newline="") as f:
        sweep = list(csv.reader(f))
    ref = v.threshold_sweep()
    np.testing.assert_array_equal(np.asarray(sweep[1:], np.float64)[:, 3], ref["f1"])
