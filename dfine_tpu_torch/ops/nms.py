"""Class-wise NMS (port of ``dfine_tpu/ops/nms.py``; D-FINE is NMS-free by
default and serving applies it only on request).

The IoU matrix is built on the device in score order and crosses to the
host once, as a bool matrix of the pairs above the threshold; the greedy
scan over it (at most the kept detections, a few hundred) is a loop over
numpy rows, not one device launch per box as the JAX ``fori_loop`` would be.
"""

from __future__ import annotations

import numpy as np
import torch

from .boxes import box_iou_pairwise


def nms(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float = 0.5) -> torch.Tensor:
    """boxes [N, 4] xyxy, scores [N] -> keep mask [N] bool (on the boxes'
    device). Boxes are taken in score order (ties by index); a box is
    suppressed when its IoU with a kept, higher-scored box is above
    ``iou_threshold``."""
    n = boxes.shape[0]
    order = torch.argsort(-scores, stable=True)
    b = boxes[order]
    over = (box_iou_pairwise(b, b)[0] > iou_threshold).cpu().numpy()
    keep_sorted = np.ones(n, bool)
    for i in range(n):
        if keep_sorted[i]:
            keep_sorted[i + 1 :] &= ~over[i, i + 1 :]
    keep = torch.zeros(n, dtype=torch.bool, device=boxes.device)
    keep[order] = torch.from_numpy(keep_sorted).to(boxes.device)
    return keep


def batched_class_nms(boxes: torch.Tensor, scores: torch.Tensor, labels: torch.Tensor,
                      iou_threshold: float = 0.5) -> torch.Tensor:
    """Class-wise NMS by the coordinate offset ``labels * (max + 1)``: boxes
    of different classes never overlap after it."""
    offset = labels.to(boxes.dtype)[:, None] * (boxes.max() + 1.0)
    return nms(boxes + offset, scores, iou_threshold)
