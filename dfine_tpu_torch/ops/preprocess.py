"""On-device preprocessing: uint8 frames -> network input (port of
``dfine_tpu/ops/preprocess.py``): plain resize, the centred letterbox, and
rect mode's stride-32 canvas with the image anchored top-left
(``dfine_tpu/infer/base.py:164-172``). The uint8 frame goes to the card and
is resized there in floats."""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

PAD_VALUE = 114.0 / 255.0


def resize_bilinear(img: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """[B, C, H, W] float -> [B, C, h, w]; half-pixel centres and no
    anti-aliasing on downscale (= cv2.INTER_LINEAR = jax.image.resize
    ``linear`` with ``antialias=False``)."""
    return F.interpolate(img, size=tuple(out_hw), mode="bilinear", align_corners=False,
                         antialias=False)


def preprocess_plain(raw: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """raw [B, H, W, 3] uint8 RGB (the JAX layout) -> [B, 3, h, w] f32 in
    [0, 1] (NCHW, the model's layout, with channels-last strides: the
    frame's NHWC order; the model casts to its own dtype)."""
    x = raw.permute(0, 3, 1, 2).float() / 255.0
    return resize_bilinear(x, out_hw)


def letterbox_geometry(h: int, w: int, out_hw: Tuple[int, int]):
    """(nh, nw): the aspect-preserving size of an (h, w) image inside
    ``out_hw``, rounded as the JAX package rounds it."""
    th, tw = out_hw
    scale = min(th / h, tw / w)
    return int(round(h * scale)), int(round(w * scale))


def rect_bucket(h: int, w: int, out_hw: Tuple[int, int]) -> Tuple[int, int]:
    """The stride-32 canvas (rect mode's bucket) of an (h, w) image
    (``dfine_tpu/infer/base.py:35-41``)."""
    nh, nw = letterbox_geometry(h, w, out_hw)
    return math.ceil(nh / 32) * 32, math.ceil(nw / 32) * 32


def _pad_into(x: torch.Tensor, canvas_hw: Tuple[int, int], top: int, left: int) -> torch.Tensor:
    """x on a canvas of 114/255, laid out channels-last as ``preprocess_plain``
    leaves its output (the frame's own NHWC order), so that the model runs
    the same kernels in every mode."""
    b, c = x.shape[:2]
    out = torch.full((b, *canvas_hw, c), PAD_VALUE, dtype=x.dtype, device=x.device)
    out = out.permute(0, 3, 1, 2)
    out[:, :, top : top + x.shape[2], left : left + x.shape[3]] = x
    return out


def preprocess_letterbox(raw: torch.Tensor, out_hw: Tuple[int, int]):
    """raw [B, H, W, 3] uint8 RGB -> ([B, 3, th, tw] f32, (pad_top,
    pad_left)): resize to the aspect-preserving size, then pad centred with
    114/255 (``dfine_tpu/ops/preprocess.py:38-56``)."""
    nh, nw = letterbox_geometry(raw.shape[1], raw.shape[2], out_hw)
    top, left = (out_hw[0] - nh) // 2, (out_hw[1] - nw) // 2
    x = resize_bilinear(raw.permute(0, 3, 1, 2).float() / 255.0, (nh, nw))
    return _pad_into(x, out_hw, top, left), (top, left)


def preprocess_rect(raw: torch.Tensor, out_hw: Tuple[int, int]):
    """raw [B, H, W, 3] uint8 RGB -> ([B, 3, ph, pw] f32, (0, 0)): the
    aspect-preserving resize anchored top-left on its stride-32 canvas,
    padded with 114/255."""
    h, w = raw.shape[1], raw.shape[2]
    x = resize_bilinear(raw.permute(0, 3, 1, 2).float() / 255.0, letterbox_geometry(h, w, out_hw))
    return _pad_into(x, rect_bucket(h, w, out_hw), 0, 0), (0, 0)
