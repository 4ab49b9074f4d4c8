"""Prediction postprocessing (port of ``dfine_tpu/postprocess.py``): the
NMS-free top-k decode on the device, then boxes to the original frame
(plain resize, or un-letterboxed with the pads preprocessing applied) and
masks resized on the device (no cv2)."""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .utils.profiling import count, span


def topk_decode(logits: torch.Tensor, boxes: torch.Tensor, num_top_queries: int = 300,
                use_focal_loss: bool = True,
                masks: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """Returns scores [B,K], labels [B,K], boxes [B,K,4] (normalized cxcywh),
    qidx [B,K] and, given masks [B,Q,Hm,Wm], masks [B,K,Hm,Wm] of the top
    queries. Focal: sigmoid (fp32), flat top-k over Q*C. Softmax: each
    query's best class but the last (background), top-k over Q."""
    b, q, c = logits.shape
    if use_focal_loss:
        flat = torch.sigmoid(logits.float()).reshape(b, q * c)
        scores, idx = flat.topk(min(num_top_queries, q * c), dim=1)
        qidx = idx // c
        labels = idx % c
    else:
        probs = logits.float().softmax(-1)[..., :-1]
        per_q, labels_q = probs.max(-1)
        scores, qidx = per_q.topk(min(num_top_queries, q), dim=1)
        labels = torch.gather(labels_q, 1, qidx)
    out = {
        "scores": scores,
        "labels": labels.to(torch.int32),
        "boxes": torch.gather(boxes, 1, qidx[..., None].expand(-1, -1, boxes.shape[-1])),
        "qidx": qidx.to(torch.int32),
    }
    if masks is not None:
        hm, wm = masks.shape[-2:]
        out["masks"] = torch.gather(masks, 1, qidx[..., None, None].expand(-1, -1, hm, wm))
    return out


def norm_cxcywh_to_abs_xyxy(boxes: np.ndarray, h: int, w: int) -> np.ndarray:
    cx, cy, bw, bh = boxes[..., 0] * w, boxes[..., 1] * h, boxes[..., 2] * w, boxes[..., 3] * h
    return np.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2], -1)


def _centred_pad(proc_hw, orig_hw) -> Tuple[int, int]:
    """The classic letterbox's (pad_top, pad_left), rounded as the
    reference rounds it."""
    ph, pw = proc_hw
    oh, ow = orig_hw
    gain = min(ph / oh, pw / ow)
    return round((ph - oh * gain) / 2 - 0.1), round((pw - ow * gain) / 2 - 0.1)


def unletterbox_boxes(boxes_xyxy: np.ndarray, proc_hw: Tuple[int, int], orig_hw: Tuple[int, int],
                      pad_tl: Optional[Tuple[int, int]] = None) -> np.ndarray:
    """Invert the letterbox mapping. ``pad_tl`` is the (pad_top, pad_left)
    preprocessing applied; None assumes the centred pad. Rect mode anchors
    the image top-left and passes (0, 0)."""
    ph, pw = proc_hw
    oh, ow = orig_hw
    gain = min(ph / oh, pw / ow)
    padh, padw = _centred_pad(proc_hw, orig_hw) if pad_tl is None else pad_tl
    b = boxes_xyxy.copy()
    b[..., [0, 2]] -= padw
    b[..., [1, 3]] -= padh
    b /= gain
    b[..., [0, 2]] = b[..., [0, 2]].clip(0, ow)
    b[..., [1, 3]] = b[..., [1, 3]].clip(0, oh)
    return b


def boxes_to_original(boxes_norm: np.ndarray, proc_hw: Tuple[int, int],
                      orig_hw: Tuple[int, int], keep_ratio: bool = False,
                      pad_tl: Optional[Tuple[int, int]] = None) -> np.ndarray:
    """[K, 4] normalized cxcywh in the processed frame -> absolute xyxy in
    the original frame, clipped to it."""
    ph, pw = proc_hw
    oh, ow = orig_hw
    xyxy = norm_cxcywh_to_abs_xyxy(boxes_norm, ph, pw)
    if keep_ratio:
        return unletterbox_boxes(xyxy, proc_hw, orig_hw, pad_tl)
    xyxy[..., [0, 2]] = (xyxy[..., [0, 2]] * (ow / pw)).clip(0, ow)
    xyxy[..., [1, 3]] = (xyxy[..., [1, 3]] * (oh / ph)).clip(0, oh)
    return xyxy


def masks_to_original(mask_probs: torch.Tensor, proc_hw: Tuple[int, int],
                      orig_hw: Tuple[int, int], keep_ratio: bool = False,
                      pad_tl: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """[K, Hm, Wm] probabilities -> [K, oh, ow] in [0, 1]: upsample to the
    processed size, crop the letterbox pad away (``pad_tl`` as in
    ``unletterbox_boxes``), resize to the original (bilinear, half-pixel, no
    anti-aliasing: cv2.INTER_LINEAR's rule)."""
    ph, pw = proc_hw
    oh, ow = orig_hw
    if mask_probs.shape[0] == 0:
        return mask_probs.new_zeros((0, oh, ow), dtype=torch.float32)
    y1, x1, y2, x2 = 0, 0, ph, pw
    if keep_ratio:
        gain = min(ph / oh, pw / ow)
        nh, nw = int(round(oh * gain)), int(round(ow * gain))
        padh, padw = _centred_pad(proc_hw, orig_hw) if pad_tl is None else pad_tl
        padh, padw = max(int(padh), 0), max(int(padw), 0)
        y1, y2 = padh, min(padh + nh, ph)
        x1, x2 = padw, min(padw + nw, pw)
    x = mask_probs.float()[:, None]
    x = F.interpolate(x, size=(ph, pw), mode="bilinear", align_corners=False)
    x = F.interpolate(x[:, :, y1:y2, x1:x2], size=(oh, ow), mode="bilinear", align_corners=False)
    return x[:, 0].clamp(0.0, 1.0)


def cleanup_masks(masks: torch.Tensor, boxes_xyxy: torch.Tensor) -> torch.Tensor:
    """Zero mask pixels outside each instance's own box."""
    _, h, w = masks.shape
    ys = torch.arange(h, device=masks.device)[None, :, None]
    xs = torch.arange(w, device=masks.device)[None, None, :]
    x1, y1, x2, y2 = (boxes_xyxy[:, i, None, None] for i in range(4))
    inside = (xs >= x1) & (xs < x2) & (ys >= y1) & (ys < y2)
    return masks * inside.to(masks.dtype)


def _mask_h2d(a: np.ndarray, device) -> torch.Tensor:
    """A host-made array copied to the masks' device, counted as ``serve.mask_h2d``."""
    count("serve.mask_h2d")
    return torch.from_numpy(a).to(device)


def postprocess_predictions(
    decoded: Dict[str, torch.Tensor],
    proc_hw: Tuple[int, int],
    orig_sizes: Sequence[Tuple[int, int]],
    conf_thresh: float = 0.5,
    keep_ratio: bool = False,
    per_class_conf: Optional[Dict[int, float]] = None,
    pads: Optional[Sequence[Optional[Tuple[int, int]]]] = None,
) -> List[Dict[str, np.ndarray]]:
    """Per-image dicts of the serving contract: labels/boxes/scores of the
    kept detections (+ uint8 masks in the original frame), plus all_* arrays.
    ``decoded`` is ``topk_decode``'s output; its masks may cover only the
    top-K queries, and a kept detection past them gets an empty mask.
    ``keep_ratio``: the frame was letterboxed (or rect-canvassed), with
    ``pads[b]`` the (pad_top, pad_left) applied to image b (None: centred)."""
    with span("serve.d2h"):  # the host waits here for the card's work
        scores = decoded["scores"].float().cpu().numpy()
        labels = decoded["labels"].cpu().numpy()
        boxes = decoded["boxes"].float().cpu().numpy()
    count("serve.d2h_copies", 3)
    masks = decoded.get("masks")  # probabilities
    results = []
    for b in range(scores.shape[0]):
        oh, ow = orig_sizes[b]
        pad_tl = pads[b] if pads is not None else None
        bb_all = boxes_to_original(boxes[b], proc_hw, (oh, ow), keep_ratio, pad_tl)
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
            with span("serve.masks"):
                km = masks.shape[1]
                keep_t = _mask_h2d(keep[:km], masks.device)
                mk = masks_to_original(masks[b][keep_t], proc_hw, (oh, ow), keep_ratio, pad_tl)
                binary = (mk >= conf_thresh).to(torch.uint8)
                n_kept = int(keep.sum())
                if binary.shape[0] < n_kept:
                    pad = binary.new_zeros((n_kept - binary.shape[0], oh, ow))
                    binary = torch.cat([binary, pad], 0)
                box_t = _mask_h2d(out["boxes"], masks.device)
                kept = cleanup_masks(binary, box_t)
            with span("serve.d2h"):
                out["masks"] = kept.cpu().numpy()
            count("serve.d2h_copies")
            count("serve.mask_bytes", out["masks"].nbytes)
        results.append(out)
    return results
