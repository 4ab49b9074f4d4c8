"""Fine-grained Distribution Refinement math (the reference's frozen copy of ``dfine_tpu_torch/ops/fdr.py``): the bin values, the decode of the eval path, and
the bin targets of the FGL loss (``translate_gt``, ``bbox2distance``)."""

from __future__ import annotations

from typing import List, Tuple

import torch

from .boxes import box_xyxy_to_cxcywh


def weighting_function(reg_max: int, up: float, reg_scale: float) -> List[float]:
    """Non-uniform bin values W(n), ``reg_max + 1`` python floats:
    [-2U, -(s^(k-1)-1), ..., -(s-1), 0, s-1, ..., s^(k-1)-1, 2U] with
    U = |up|*|reg_scale|, k = reg_max//2, s = (U+1)^(2/(reg_max-2))."""
    up = abs(float(up))
    reg_scale = abs(float(reg_scale))
    ub1 = up * reg_scale
    ub2 = up * reg_scale * 2
    step = (ub1 + 1) ** (2 / (reg_max - 2))
    left = [-(step**i) + 1 for i in range(reg_max // 2 - 1, 0, -1)]
    right = [step**i - 1 for i in range(1, reg_max // 2)]
    return [-ub2] + left + [0.0] + right + [ub2]


def distance2bbox(points: torch.Tensor, distance: torch.Tensor, reg_scale: float) -> torch.Tensor:
    """Decode l/t/r/b edge distances (W(n) units) around cxcywh reference
    boxes; returns cxcywh."""
    reg_scale = abs(float(reg_scale))
    sx = points[..., 2] / reg_scale
    sy = points[..., 3] / reg_scale
    x1 = points[..., 0] - (0.5 * reg_scale + distance[..., 0]) * sx
    y1 = points[..., 1] - (0.5 * reg_scale + distance[..., 1]) * sy
    x2 = points[..., 0] + (0.5 * reg_scale + distance[..., 2]) * sx
    y2 = points[..., 1] + (0.5 * reg_scale + distance[..., 3]) * sy
    return box_xyxy_to_cxcywh(torch.stack([x1, y1, x2, y2], -1))


def integral(corners: torch.Tensor, project: torch.Tensor, reg_max: int) -> torch.Tensor:
    """Softmax expectation over bins, in fp32. corners [..., 4*(reg_max+1)]
    logits, project [reg_max+1] -> [..., 4]."""
    shape = corners.shape
    x = corners.reshape(shape[:-1] + (4, reg_max + 1)).float().softmax(-1)
    return (x * project.float()).sum(-1)


def translate_gt(gt: torch.Tensor, reg_max: int, reg_scale: float,
                 up: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Continuous edge offsets -> fractional bin indices. gt of any shape,
    flattened. Returns (indices f32, weight_right, weight_left), each [numel]:
    below the first bin value the left bin 0 takes all the weight, at or
    above the last the index is reg_max - 0.1 and the right bin takes it."""
    gt = gt.reshape(-1)
    fv = torch.tensor(weighting_function(reg_max, up, reg_scale), dtype=torch.float32,
                      device=gt.device)
    closest_left = (fv[None, :] <= gt[:, None]).sum(1).float() - 1.0  # last value <= gt
    valid = (closest_left >= 0) & (closest_left < reg_max)
    idx_safe = closest_left.clamp(0, reg_max - 1).long()
    left_diffs = (gt - fv[idx_safe]).abs()
    right_diffs = (fv[idx_safe + 1] - gt).abs()
    wr_valid = left_diffs / (left_diffs + right_diffs).clamp_min(1e-16)
    below = closest_left < 0
    above = closest_left >= reg_max
    zero = torch.zeros_like(wr_valid)
    weight_right = torch.where(above, 1.0, torch.where(valid, wr_valid, zero))
    weight_left = torch.where(below, 1.0, torch.where(valid, 1.0 - wr_valid, zero))
    indices = torch.where(above, reg_max - 0.1, torch.where(below, 0.0, closest_left))
    return indices, weight_right, weight_left


def bbox2distance(points: torch.Tensor, bbox: torch.Tensor, reg_max: int, reg_scale: float,
                  up: float, eps: float = 0.1):
    """GT box -> per-edge fractional bin targets. points [N, 4] cxcywh
    reference boxes, bbox [N, 4] xyxy GT. Returns (target bins, weight_right,
    weight_left), each [N*4], detached."""
    reg_scale = abs(float(reg_scale))
    sx = points[..., 2] / reg_scale + 1e-16
    sy = points[..., 3] / reg_scale + 1e-16
    left = (points[..., 0] - bbox[..., 0]) / sx - 0.5 * reg_scale
    top = (points[..., 1] - bbox[..., 1]) / sy - 0.5 * reg_scale
    right = (bbox[..., 2] - points[..., 0]) / sx - 0.5 * reg_scale
    bottom = (bbox[..., 3] - points[..., 1]) / sy - 0.5 * reg_scale
    idx, wr, wl = translate_gt(torch.stack([left, top, right, bottom], -1), reg_max, reg_scale,
                               up)
    idx = idx.clamp(0, reg_max - eps)
    return idx.reshape(-1).detach(), wr.detach(), wl.detach()
