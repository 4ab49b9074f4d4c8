"""Validator: the detection / segmentation metrics engine in numpy (a copy
of ``dfine_tpu/eval/validator.py``; plots without a hard matplotlib need).

* greedy class-agnostic IoU matching per image (pairs sorted by IoU desc,
  one-to-one), misclassifications counted as FN(gt) + FP(pred) with IoU 0;
* per-class TP/FP/FN/IoU -> precision / recall / F1 / IoU aggregates and
  extended per-class metrics;
* a confusion matrix with a background row and column;
* the mask-IoU variant computed on the RLEs (``rle.rle_iou_matrix``);
* mAP_50 / mAP_50_95 (box and segm) by ``coco_map.compute_map``;
* a threshold sweep 0.2..0.95 with P/R/F1 curves and the best F1, saved by
  ``save_plots``: always as CSV, and as PNG where matplotlib imports.
"""

from __future__ import annotations

import csv
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from .coco_map import box_iou_matrix, compute_map, mask_iou_matrix
from .rle import rle_to_masks


def filter_preds(preds: List[Dict], conf_thresh: float) -> List[Dict]:
    """Re-threshold predictions from their kept all_* arrays
    (reference src/dl/utils.py filter_preds)."""
    out = []
    for p in preds:
        keep = np.asarray(p["all_scores"]) >= conf_thresh
        q = {
            "labels": np.asarray(p["all_labels"])[keep],
            "boxes": np.asarray(p["all_boxes"])[keep],
            "scores": np.asarray(p["all_scores"])[keep],
        }
        out.append(q)
    return out


def _get_masks(sample: Dict):
    """Dense [N,H,W] array or RLE list — downstream IoU (coco_map.
    mask_iou_matrix) consumes RLEs directly via the run-length-native path,
    so RLE-encoded eval never decodes to dense pixels."""
    if sample.get("masks") is not None and len(sample["masks"]):
        return np.asarray(sample["masks"])
    if sample.get("masks_rle"):
        return sample["masks_rle"]
    return None


class Validator:
    def __init__(
        self,
        gt: List[Dict],
        preds: List[Dict],
        label_to_name: Dict[int, str],
        conf_thresh: float = 0.5,
        iou_thresh: float = 0.5,
        mask_batch_size: int = 1000,
    ):
        self.gt = gt
        self.preds = preds
        self.label_to_name = dict(label_to_name)
        self.conf_thresh = conf_thresh
        self.iou_thresh = iou_thresh
        self.mask_batch_size = mask_batch_size
        self.thresholds = np.arange(0.2, 1.0, 0.05)
        self.conf_matrix = None
        self.class_to_idx = None
        self.metrics_per_class = None
        self.use_masks = any(
            _get_masks(p) is not None for p in preds
        ) and any(_get_masks(g) is not None for g in gt)

    # ------------------------------------------------------------- public

    def compute_metrics(self, extended: bool = False, ignore_masks: bool = False) -> Dict:
        metrics = self._main_metrics(self.preds, ignore_masks=ignore_masks)

        map_preds = [
            {
                "labels": p.get("all_labels", p["labels"]),
                "boxes": p.get("all_boxes", p["boxes"]),
                "scores": p.get("all_scores", p["scores"]),
                "masks": _get_masks(p),
            }
            for p in self.preds
        ]
        gts = [
            {"labels": g["labels"], "boxes": g["boxes"], "masks": _get_masks(g)}
            for g in self.gt
        ]
        box_map = compute_map(map_preds, gts, iou_type="bbox")
        metrics["mAP_50"] = box_map["map_50"]
        metrics["mAP_50_95"] = box_map["map"]
        if extended:
            # full COCOeval surface (torchmetrics key style, reference
            # validator.py:50-64): size-range APs, AR tiers, per-class AP
            for k in ("map_75", "map_small", "map_medium", "map_large",
                      "mar_1", "mar_10", "mar_100",
                      "mar_small", "mar_medium", "mar_large"):
                metrics.setdefault("extended_metrics", {})[k] = box_map[k]
            for c, ap in box_map["map_per_class"].items():
                name = self.label_to_name.get(c, str(c))
                metrics["extended_metrics"][f"map_{name}"] = ap
        if self.use_masks and not ignore_masks:
            # NOTE: all_* masks are not kept (RAM); segm mAP uses the
            # thresholded set, mirroring the reference's bench behavior.
            seg_preds = [
                {"labels": p["labels"], "scores": p["scores"], "masks": _get_masks(p)}
                for p in self.preds
            ]
            seg_map = compute_map(seg_preds, gts, iou_type="segm")
            metrics["mAP_50_mask"] = seg_map["map_50"]
            metrics["mAP_50_95_mask"] = seg_map["map"]
        if not extended:
            metrics.pop("extended_metrics", None)
        return metrics

    # ------------------------------------------------------- core matching

    def _main_metrics(self, preds: List[Dict], ignore_masks: bool = False) -> Dict:
        use_masks = self.use_masks and not ignore_masks
        self.metrics_per_class, self.conf_matrix, self.class_to_idx = self._match_all(
            preds, use_masks
        )
        tps = fps = fns = 0
        ious: List[float] = []
        extended: Dict[str, float] = {}
        for cls, v in self.metrics_per_class.items():
            tps += v["TPs"]
            fps += v["FPs"]
            fns += v["FNs"]
            ious.extend(v["IoUs"])
            name = self.label_to_name.get(cls, str(cls))
            p = v["TPs"] / (v["TPs"] + v["FPs"]) if v["TPs"] + v["FPs"] > 0 else 0
            r = v["TPs"] / (v["TPs"] + v["FNs"]) if v["TPs"] + v["FNs"] > 0 else 0
            extended[f"precision_{name}"] = p
            extended[f"recall_{name}"] = r
            extended[f"iou_{name}"] = float(np.mean(v["IoUs"])) if v["IoUs"] else 0.0
            extended[f"f1_{name}"] = 2 * p * r / (p + r) if p + r > 0 else 0
        precision = tps / (tps + fps) if tps + fps > 0 else 0
        recall = tps / (tps + fns) if tps + fns > 0 else 0
        f1 = 2 * precision * recall / (precision + recall) if precision + recall > 0 else 0
        return {
            "f1": f1,
            "precision": precision,
            "recall": recall,
            "iou": float(np.mean(ious)) if ious else 0,
            "TPs": tps,
            "FPs": fps,
            "FNs": fns,
            "extended_metrics": extended,
        }

    def _match_all(self, preds: List[Dict], use_masks: bool):
        metrics = defaultdict(lambda: {"TPs": 0, "FPs": 0, "FNs": 0, "IoUs": []})
        all_classes = set()
        for p in preds:
            all_classes.update(np.asarray(p["labels"]).astype(int).tolist())
        for g in self.gt:
            all_classes.update(np.asarray(g["labels"]).astype(int).tolist())
        all_classes = sorted(all_classes)
        class_to_idx = {c: i for i, c in enumerate(all_classes)}
        n = len(all_classes)
        conf = np.zeros((n + 1, n + 1), np.int64)

        for pred, gt in zip(preds, self.gt):
            p_labels = np.asarray(pred["labels"]).astype(int)
            g_labels = np.asarray(gt["labels"]).astype(int)
            n_p, n_g = len(p_labels), len(g_labels)
            if n_p == 0 and n_g == 0:
                continue
            if use_masks:
                pm, gm = _get_masks(pred), _get_masks(gt)
                iou = mask_iou_matrix(
                    pm if pm is not None else np.zeros((0, 1, 1), np.uint8),
                    gm if gm is not None else np.zeros((0, 1, 1), np.uint8),
                )
            else:
                iou = box_iou_matrix(
                    np.asarray(pred["boxes"], np.float32).reshape(-1, 4),
                    np.asarray(gt["boxes"], np.float32).reshape(-1, 4),
                )
            matched_p, matched_g = set(), set()
            if iou.size:
                pi, gi = np.nonzero(iou >= self.iou_thresh)
                vals = iou[pi, gi]
                order = np.argsort(-vals, kind="stable")
                for p_idx, g_idx, v in zip(pi[order], gi[order], vals[order]):
                    if p_idx in matched_p or g_idx in matched_g:
                        continue
                    matched_p.add(int(p_idx))
                    matched_g.add(int(g_idx))
                    pl, gl = int(p_labels[p_idx]), int(g_labels[g_idx])
                    conf[class_to_idx[gl], class_to_idx[pl]] += 1
                    if pl == gl:
                        metrics[gl]["TPs"] += 1
                        metrics[gl]["IoUs"].append(float(v))
                    else:
                        metrics[gl]["FNs"] += 1
                        metrics[pl]["FPs"] += 1
                        metrics[gl]["IoUs"].append(0.0)
                        metrics[pl]["IoUs"].append(0.0)
            for p_idx in set(range(n_p)) - matched_p:
                pl = int(p_labels[p_idx])
                conf[n, class_to_idx[pl]] += 1
                metrics[pl]["FPs"] += 1
                metrics[pl]["IoUs"].append(0.0)
            for g_idx in set(range(n_g)) - matched_g:
                gl = int(g_labels[g_idx])
                conf[class_to_idx[gl], n] += 1
                metrics[gl]["FNs"] += 1
                metrics[gl]["IoUs"].append(0.0)
        return metrics, conf, class_to_idx

    # ----------------------------------------------------- threshold sweep

    def threshold_sweep(self) -> Dict[str, np.ndarray]:
        """P/R/F1 over conf thresholds 0.2..0.95 on box metrics
        (reference :555-638)."""
        ps, rs, f1s = [], [], []
        for t in self.thresholds:
            m = Validator(
                self.gt,
                filter_preds(self.preds, t),
                self.label_to_name,
                conf_thresh=t,
                iou_thresh=self.iou_thresh,
            )._main_metrics(filter_preds(self.preds, t), ignore_masks=True)
            ps.append(m["precision"])
            rs.append(m["recall"])
            f1s.append(m["f1"])
        best = int(np.argmax(f1s))
        return {
            "thresholds": self.thresholds,
            "precision": np.asarray(ps),
            "recall": np.asarray(rs),
            "f1": np.asarray(f1s),
            "best_threshold": float(self.thresholds[best]),
            "best_f1": float(f1s[best]),
        }

    # -------------------------------------------------------------- plots

    def save_plots(self, out_dir: Path, logger=None) -> str:
        """The threshold sweep's curves and the confusion matrix, as
        ``threshold_sweep.csv`` and ``confusion_matrix.csv`` and, where
        matplotlib imports (lazily, here only), as the three PNGs of the JAX
        package. Returns the writer used: "matplotlib" or "csv"."""
        out_dir = Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        sweep = self.threshold_sweep()
        if self.conf_matrix is None:
            self._main_metrics(self.preds, ignore_masks=True)
        names = [
            self.label_to_name.get(c, str(c))
            for c in sorted(self.class_to_idx, key=self.class_to_idx.get)
        ] + ["background"]
        with open(out_dir / "threshold_sweep.csv", "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["threshold", "precision", "recall", "f1"])
            for row in zip(*(sweep[k] for k in ("thresholds", "precision", "recall", "f1"))):
                w.writerow([repr(float(v)) for v in row])
        with open(out_dir / "confusion_matrix.csv", "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["ground truth \\ predicted"] + names)
            for name, row in zip(names, self.conf_matrix):
                w.writerow([name] + [int(v) for v in row])
        try:
            import matplotlib
        except ImportError:
            if logger is not None:
                logger.info(f"matplotlib is not installed: plots written as CSV only ({out_dir})")
            return "csv"
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(7, 5))
        ax.plot(sweep["thresholds"], sweep["precision"], label="precision")
        ax.plot(sweep["thresholds"], sweep["recall"], label="recall")
        ax.set_xlabel("confidence threshold")
        ax.legend()
        ax.grid(alpha=0.3)
        fig.savefig(out_dir / "precision_recall_vs_threshold.png", dpi=120)
        plt.close(fig)

        fig, ax = plt.subplots(figsize=(7, 5))
        ax.plot(sweep["thresholds"], sweep["f1"], label="F1")
        ax.axvline(sweep["best_threshold"], ls="--", c="gray",
                   label=f"best {sweep['best_threshold']:.2f} (F1 {sweep['best_f1']:.3f})")
        ax.set_xlabel("confidence threshold")
        ax.legend()
        ax.grid(alpha=0.3)
        fig.savefig(out_dir / "f1_vs_threshold.png", dpi=120)
        plt.close(fig)

        fig, ax = plt.subplots(figsize=(1 + len(names), 1 + len(names)))
        ax.imshow(self.conf_matrix, cmap="Blues")
        for i in range(len(names)):
            for j in range(len(names)):
                ax.text(j, i, str(self.conf_matrix[i, j]), ha="center", va="center")
        ax.set_xticks(range(len(names)), names, rotation=45, ha="right")
        ax.set_yticks(range(len(names)), names)
        ax.set_xlabel("predicted")
        ax.set_ylabel("ground truth")
        fig.tight_layout()
        fig.savefig(out_dir / "confusion_matrix.png", dpi=120)
        plt.close(fig)
        return "matplotlib"
