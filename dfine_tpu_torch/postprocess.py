"""Prediction postprocessing (port of ``dfine_tpu/postprocess.py:25-232``,
plain-resize mode): NMS-free top-k decode on the device, then boxes to the
original frame and masks resized on the device (no cv2). Letterbox and rect
un-mapping wait for a later slice."""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def topk_decode(logits: torch.Tensor, boxes: torch.Tensor, num_top_queries: int = 300,
                masks: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """Sigmoid (fp32) -> flat top-k over Q*C -> gather. Returns scores [B,K],
    labels [B,K], boxes [B,K,4] (normalized cxcywh), qidx [B,K] and, given
    masks [B,Q,Hm,Wm], masks [B,K,Hm,Wm] of the top queries."""
    b, q, c = logits.shape
    flat = torch.sigmoid(logits.float()).reshape(b, q * c)
    scores, idx = flat.topk(min(num_top_queries, q * c), dim=1)
    qidx = idx // c
    out = {
        "scores": scores,
        "labels": (idx % c).to(torch.int32),
        "boxes": torch.gather(boxes, 1, qidx[..., None].expand(-1, -1, boxes.shape[-1])),
        "qidx": qidx.to(torch.int32),
    }
    if masks is not None:
        hm, wm = masks.shape[-2:]
        out["masks"] = torch.gather(masks, 1, qidx[..., None, None].expand(-1, -1, hm, wm))
    return out


def boxes_to_original(boxes_norm: np.ndarray, proc_hw: Tuple[int, int],
                      orig_hw: Tuple[int, int]) -> np.ndarray:
    """[K, 4] normalized cxcywh in the processed frame -> absolute xyxy in
    the original frame (plain resize), clipped to it."""
    ph, pw = proc_hw
    oh, ow = orig_hw
    cx, cy = boxes_norm[..., 0] * pw, boxes_norm[..., 1] * ph
    bw, bh = boxes_norm[..., 2] * pw, boxes_norm[..., 3] * ph
    xyxy = np.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2], -1)
    xyxy[..., [0, 2]] = (xyxy[..., [0, 2]] * (ow / pw)).clip(0, ow)
    xyxy[..., [1, 3]] = (xyxy[..., [1, 3]] * (oh / ph)).clip(0, oh)
    return xyxy


def masks_to_original(mask_probs: torch.Tensor, proc_hw: Tuple[int, int],
                      orig_hw: Tuple[int, int]) -> torch.Tensor:
    """[K, Hm, Wm] probabilities -> [K, oh, ow] in [0, 1]: upsample to the
    processed size, then resize to the original (bilinear, half-pixel, no
    anti-aliasing: cv2.INTER_LINEAR's rule)."""
    x = mask_probs.float()[:, None]
    x = F.interpolate(x, size=tuple(proc_hw), mode="bilinear", align_corners=False)
    x = F.interpolate(x, size=tuple(orig_hw), mode="bilinear", align_corners=False)
    return x[:, 0].clamp(0.0, 1.0)


def cleanup_masks(masks: torch.Tensor, boxes_xyxy: torch.Tensor) -> torch.Tensor:
    """Zero mask pixels outside each instance's own box."""
    _, h, w = masks.shape
    ys = torch.arange(h, device=masks.device)[None, :, None]
    xs = torch.arange(w, device=masks.device)[None, None, :]
    x1, y1, x2, y2 = (boxes_xyxy[:, i, None, None] for i in range(4))
    inside = (xs >= x1) & (xs < x2) & (ys >= y1) & (ys < y2)
    return masks * inside.to(masks.dtype)


def postprocess_predictions(
    decoded: Dict[str, torch.Tensor],
    proc_hw: Tuple[int, int],
    orig_sizes: Sequence[Tuple[int, int]],
    conf_thresh: float = 0.5,
    per_class_conf: Optional[Dict[int, float]] = None,
) -> List[Dict[str, np.ndarray]]:
    """Per-image dicts of the serving contract: labels/boxes/scores of the
    kept detections (+ uint8 masks in the original frame), plus all_* arrays.
    ``decoded`` is ``topk_decode``'s output; its masks may cover only the
    top-K queries, and a kept detection past them gets an empty mask."""
    scores = decoded["scores"].float().cpu().numpy()
    labels = decoded["labels"].cpu().numpy()
    boxes = decoded["boxes"].float().cpu().numpy()
    masks = decoded.get("masks")
    results = []
    for b in range(scores.shape[0]):
        oh, ow = orig_sizes[b]
        bb_all = boxes_to_original(boxes[b], proc_hw, (oh, ow))
        if per_class_conf:
            thr = np.asarray([per_class_conf.get(int(l), conf_thresh) for l in labels[b]])
        else:
            thr = conf_thresh
        keep = scores[b] >= thr
        out = {
            "labels": labels[b][keep],
            "boxes": bb_all[keep],
            "scores": scores[b][keep],
            "all_labels": labels[b],
            "all_boxes": bb_all,
            "all_scores": scores[b],
        }
        if masks is not None:
            km = masks.shape[1]
            keep_t = torch.from_numpy(keep[:km]).to(masks.device)
            mk = masks_to_original(masks[b][keep_t], proc_hw, (oh, ow))
            binary = (mk >= conf_thresh).to(torch.uint8)
            n_kept = int(keep.sum())
            if binary.shape[0] < n_kept:
                pad = binary.new_zeros((n_kept - binary.shape[0], oh, ow))
                binary = torch.cat([binary, pad], 0)
            box_t = torch.from_numpy(out["boxes"]).to(masks.device)
            out["masks"] = cleanup_masks(binary, box_t).cpu().numpy()
        results.append(out)
    return results
