"""Box geometry ops (port of ``dfine_tpu/ops/boxes.py``)."""

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


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """logit with clipping."""
    x = x.clamp(0.0, 1.0)
    return torch.log(x.clamp_min(eps) / (1.0 - x).clamp_min(eps))
