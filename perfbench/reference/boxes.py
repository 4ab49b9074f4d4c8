"""Box geometry ops (the reference's frozen copy of ``dfine_tpu_torch/ops/boxes.py``)."""

from __future__ import annotations

import torch


def box_cxcywh_to_xyxy(x: torch.Tensor) -> torch.Tensor:
    """cxcywh -> xyxy with w/h clamped at 0."""
    cx, cy, w, h = x.unbind(-1)
    w = w.clamp_min(0.0)
    h = h.clamp_min(0.0)
    return torch.stack([cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w, cy + 0.5 * h], -1)


def box_xyxy_to_cxcywh(x: torch.Tensor) -> torch.Tensor:
    x0, y0, x1, y1 = x.unbind(-1)
    return torch.stack([(x0 + x1) / 2, (y0 + y1) / 2, x1 - x0, y1 - y0], -1)


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    """Area of xyxy boxes, last dim 4."""
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def box_iou_pairwise(boxes1: torch.Tensor, boxes2: torch.Tensor):
    """Pairwise IoU of two xyxy sets -> ([..., N, M] iou, union)."""
    area1 = box_area(boxes1)
    area2 = box_area(boxes2)
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt).clamp_min(0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area1[..., :, None] + area2[..., None, :] - inter
    return inter / union.clamp_min(1e-16), union


def box_iou_aligned(boxes1: torch.Tensor, boxes2: torch.Tensor):
    """Elementwise IoU of aligned xyxy boxes (same leading shape) -> (iou, union)."""
    lt = torch.maximum(boxes1[..., :2], boxes2[..., :2])
    rb = torch.minimum(boxes1[..., 2:], boxes2[..., 2:])
    wh = (rb - lt).clamp_min(0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(boxes1) + box_area(boxes2) - inter
    return inter / union.clamp_min(1e-16), union


def generalized_box_iou_pairwise(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Pairwise GIoU [..., N, M] of two xyxy sets."""
    iou, union = box_iou_pairwise(boxes1, boxes2)
    lt = torch.minimum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.maximum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt).clamp_min(0.0)
    area = wh[..., 0] * wh[..., 1]
    return iou - (area - union) / area.clamp_min(1e-16)


def generalized_box_iou_aligned(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Elementwise GIoU of aligned xyxy boxes."""
    iou, union = box_iou_aligned(boxes1, boxes2)
    lt = torch.minimum(boxes1[..., :2], boxes2[..., :2])
    rb = torch.maximum(boxes1[..., 2:], boxes2[..., 2:])
    wh = (rb - lt).clamp_min(0.0)
    area = wh[..., 0] * wh[..., 1]
    return iou - (area - union) / area.clamp_min(1e-16)


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """logit with clipping."""
    x = x.clamp(0.0, 1.0)
    return torch.log(x.clamp_min(eps) / (1.0 - x).clamp_min(eps))
