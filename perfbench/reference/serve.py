"""The reference's answer for served frames: the plain resize to the
model's input, the fp32 forward, each frame's threshold, and the views
``judge.serve_numbers`` reads (every query's scores and its box in the
frame's pixels, and the sure inside and outside of any query's mask at the
frame's size)."""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from . import precision
from .postprocess import boxes_to_original, cleanup_masks, masks_to_original

MASK_MARGIN = 0.05


def model_input(frames_bgr: torch.Tensor, input_hw: Sequence[int]) -> torch.Tensor:
    """[N, H, W, 3] uint8 BGR -> [N, 3, h, w] float in [0, 1], RGB,
    bilinear with half-pixel centres and no anti-aliasing."""
    x = frames_bgr.flip(-1).permute(0, 3, 1, 2).float() / 255.0
    return F.interpolate(x, size=tuple(input_hw), mode="bilinear", align_corners=False,
                         antialias=False)


@torch.no_grad()
def outputs(model, frames_bgr: torch.Tensor, input_hw, mode: str = "fp32", block: int = 4,
            keep_masks: bool = True):
    """The model's raw outputs of every frame, in blocks of ``block``
    frames, on the host: a list of {"scores" [Q, C], "boxes" [Q, 4] cxcywh,
    and with ``keep_masks`` "masks" [Q, Hm, Wm] probabilities (on the
    device) where the model has the mask head}."""
    res = []
    for i in range(0, len(frames_bgr), block):
        with precision.mode(mode, frames_bgr.device.type):
            out = model(model_input(frames_bgr[i:i + block], input_hw))
        for j in range(out["pred_logits"].shape[0]):
            r = {"scores": torch.sigmoid(out["pred_logits"][j].float()).cpu().numpy(),
                 "boxes": out["pred_boxes"][j].float().cpu().numpy()}
            if keep_masks and "pred_masks" in out:
                r["masks"] = out["pred_masks"][j].float()
            res.append(r)
    return res


def views(raw: List[Dict], input_hw, frame_hw, thresholds: Sequence[float]) -> List[Dict]:
    """``judge.serve_numbers``' view of each frame's raw outputs, with that
    frame's threshold."""
    out = []
    for r, thr in zip(raw, thresholds):
        boxes = boxes_to_original(r["boxes"], tuple(input_hw), tuple(frame_hw))
        v = {"scores": r["scores"], "boxes": boxes}
        if "masks" in r:
            v["mask"] = _mask_fn(r["masks"], boxes, input_hw, frame_hw, thr)
        out.append(v)
    return out


def _mask_fn(probs, boxes, input_hw, frame_hw, thr):
    def mask(qs):
        """(sure inside, sure outside) [len(qs), H, W] bool at the frame's
        size: the probability at least MASK_MARGIN above the threshold
        inside the query's box, and at least MASK_MARGIN below it or outside
        the box; the band between is rounding's."""
        qs = torch.as_tensor(np.asarray(qs), device=probs.device, dtype=torch.long)
        m = masks_to_original(probs[qs], tuple(input_hw), tuple(frame_hw))
        box = torch.from_numpy(boxes[qs.cpu().numpy()]).to(probs.device)
        inside = cleanup_masks(torch.ones_like(m, dtype=torch.uint8), box).bool()
        pos = inside & (m >= thr + MASK_MARGIN)
        neg = ~inside | (m <= thr - MASK_MARGIN)
        return pos.cpu().numpy(), neg.cpu().numpy()
    return mask


def thresholds(raw: List[Dict], k: int) -> List[float]:
    """Each frame's threshold that keeps its k best scores: halfway between
    its k-th and (k+1)-th highest."""
    out = []
    for r in raw:
        s = np.sort(r["scores"].ravel())
        out.append(float((s[-k] + s[-k - 1]) / 2))
    return out
