"""Audit the labels with the model's errors (port of
``dfine_tpu/apps/check_errors.py``, ``make check_errors``):

    python -m dfine_tpu_torch.apps.check_errors [config.yaml] [key.path=value ...]

Serves ``best.ckpt`` with class-wise NMS over the train and val splits,
matches predictions to ground truth greedily by IoU (highest first, one to
one, the classes equal) and writes each false positive's and each missed
box's crop (20 px around it) to ``<train.root>/output/check_errors/<split>/
{FP,FN}/<class>/``. On the card; ``device="cpu"``: the plain path.
"""

from __future__ import annotations

import sys
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from ..config import cli_config
from ..data.image_io import read_bgr, write_image
from ..data.loader import Loader
from ..device import resolve_device
from ..eval.coco_map import box_iou_matrix
from ..infer import TorchModel
from .common import experiment_dir, label_names, serving_kwargs


def save_case(img, box, out_dir: Path, name: str, pad: int = 20) -> None:
    h, w = img.shape[:2]
    x1, y1, x2, y2 = [int(v) for v in box]
    crop = img[max(0, y1 - pad) : min(h, y2 + pad), max(0, x1 - pad) : min(w, x2 + pad)]
    if crop.size:
        out_dir.mkdir(parents=True, exist_ok=True)
        write_image(out_dir / name, crop)


def check_results(model, ds, label_to_name: Dict[int, str], iou_thresh: float, out_root: Path,
                  split: str) -> Dict[str, int]:
    n_fp = n_fn = 0
    for i in range(len(ds)):
        img_path, _ = ds._paths(i)
        img = read_bgr(img_path)
        if img is None:
            continue
        (res,) = model(img)
        raw = ds.load_raw(i)
        gt_boxes, gt_labels = raw["boxes"], raw["labels"]
        iou = box_iou_matrix(np.asarray(res["boxes"], np.float32).reshape(-1, 4),
                             gt_boxes.reshape(-1, 4))
        matched_p, matched_g = set(), set()
        if iou.size:
            pi, gi = np.nonzero(iou >= iou_thresh)
            order = np.argsort(-iou[pi, gi])
            for p_idx, g_idx in zip(pi[order], gi[order]):
                if p_idx in matched_p or g_idx in matched_g:
                    continue
                if res["labels"][p_idx] == gt_labels[g_idx]:  # class-aware match
                    matched_p.add(int(p_idx))
                    matched_g.add(int(g_idx))
        for p_idx in set(range(len(res["labels"]))) - matched_p:
            cls = label_to_name.get(int(res["labels"][p_idx]), "?")
            save_case(img, res["boxes"][p_idx], out_root / split / "FP" / cls,
                      f"{img_path.stem}_{p_idx}.jpg")
            n_fp += 1
        for g_idx in set(range(len(gt_labels))) - matched_g:
            cls = label_to_name.get(int(gt_labels[g_idx]), "?")
            save_case(img, gt_boxes[g_idx], out_root / split / "FN" / cls,
                      f"{img_path.stem}_{g_idx}.jpg")
            n_fn += 1
    print(f"{split}: {n_fp} FP crops, {n_fn} FN crops -> {out_root / split}")
    return {"fp": n_fp, "fn": n_fn}


def main(argv: Optional[List[str]] = None, device=None) -> Dict[str, Dict[str, int]]:
    dev = resolve_device(device)
    cfg = cli_config(argv if argv is not None else sys.argv[1:])
    t = cfg.train
    model = TorchModel(cfg.model_name, str(experiment_dir(cfg) / "best.ckpt"), use_nms=True,
                       **serving_kwargs(cfg, dev))
    loader = Loader(Path(t.data_path), t, task=cfg.task)
    out_root = Path(t.root) / "output" / "check_errors"
    return {split: check_results(model, loader.dataset(split, mode="bench"), label_names(cfg),
                                 t.iou_thresh, out_root, split)
            for split in ("train", "val")}


if __name__ == "__main__":
    main()
