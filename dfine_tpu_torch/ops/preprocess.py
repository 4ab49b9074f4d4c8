"""On-device preprocessing: uint8 frames -> network input (port of
``dfine_tpu/ops/preprocess.py:21-35``). Letterbox waits for a later slice."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def resize_bilinear(img: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """[B, C, H, W] float -> [B, C, h, w]; half-pixel centres and no
    anti-aliasing on downscale (= cv2.INTER_LINEAR = jax.image.resize
    ``linear`` with ``antialias=False``)."""
    return F.interpolate(img, size=tuple(out_hw), mode="bilinear", align_corners=False,
                         antialias=False)


def preprocess_plain(raw: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """raw [B, H, W, 3] uint8 RGB (the JAX layout) -> [B, 3, h, w] f32 in
    [0, 1] (NCHW, the model's layout; the model casts to its own dtype)."""
    x = raw.permute(0, 3, 1, 2).float() / 255.0
    return resize_bilinear(x, out_hw)
