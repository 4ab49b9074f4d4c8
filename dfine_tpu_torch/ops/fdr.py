"""Fine-grained Distribution Refinement math, eval part (port of
``dfine_tpu/ops/fdr.py:21-67``). The training-only functions wait for the
train-step slice."""

from __future__ import annotations

from typing import List

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
