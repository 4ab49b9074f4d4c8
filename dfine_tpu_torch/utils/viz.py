"""Box and mask overlays in numpy for eval previews, debug dumps and the
apps' outputs (port of ``dfine_tpu/utils/viz.py``, without cv2):
rectangles, polylines and masks are drawn; previews are written as PNG by
``data.image_io.write_png``. The JAX package's text labels (cv2's Hershey
font) are left out."""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

import numpy as np

from ..data.image_io import write_png
from ..data.labels import _draw_line
from ..eval.rle import rle_to_masks

# the JAX package's palette, given there in cv2's BGR order
_PALETTE = [
    (231, 76, 60), (46, 204, 113), (52, 152, 219), (155, 89, 182),
    (241, 196, 15), (230, 126, 34), (26, 188, 156), (149, 165, 166),
    (192, 57, 43), (39, 174, 96), (41, 128, 185), (142, 68, 173),
]


def color_for(cls: int):
    """The BGR colour of class ``cls``, the JAX package's."""
    return _PALETTE[int(cls) % len(_PALETTE)]


def draw_rectangle(img: np.ndarray, xyxy, color, thickness: int = 2) -> None:
    """An outline ``thickness`` pixels wide inside the box, in place."""
    h, w = img.shape[:2]
    x0, y0, x1, y1 = (int(v) for v in xyxy)
    x0, x1 = max(min(x0, x1), 0), min(max(x0, x1), w - 1)
    y0, y1 = max(min(y0, y1), 0), min(max(y0, y1), h - 1)
    if x0 > x1 or y0 > y1:
        return
    t = max(1, thickness)
    img[y0:min(y0 + t, y1 + 1), x0:x1 + 1] = color
    img[max(y1 - t + 1, y0):y1 + 1, x0:x1 + 1] = color
    img[y0:y1 + 1, x0:min(x0 + t, x1 + 1)] = color
    img[y0:y1 + 1, max(x1 - t + 1, x0):x1 + 1] = color


def draw_polyline(img: np.ndarray, pts: np.ndarray, color, closed: bool = True) -> None:
    """8-connected one-pixel lines through the integer ``pts``, in place."""
    pts = np.asarray(pts, np.int64).reshape(-1, 2)
    mask = np.zeros(img.shape[:2], bool)
    ends = range(len(pts)) if closed else range(1, len(pts))
    for i in ends:
        _draw_line(mask, *(int(v) for v in pts[i - 1]), *(int(v) for v in pts[i]))
    img[mask] = color


def draw_detections(
    image_bgr: np.ndarray,
    boxes_xyxy: np.ndarray,
    labels: np.ndarray,
    scores: Optional[np.ndarray] = None,
    masks: Optional[np.ndarray] = None,
    label_to_name: Optional[Dict[int, str]] = None,
    thickness: int = 2,
) -> np.ndarray:
    """The JAX signature: masks blended half and half with their class
    colour, then boxes, on a copy of the BGR image. ``scores`` and
    ``label_to_name`` give the JAX package's text, which is not drawn."""
    img = image_bgr.copy()
    if masks is not None:
        for i, m in enumerate(masks):
            mm = np.asarray(m).astype(bool)
            img[mm] = (0.5 * np.asarray(color_for(labels[i])) + 0.5 * img[mm]).astype(np.uint8)
    for i, b in enumerate(np.asarray(boxes_xyxy).reshape(-1, 4)):
        draw_rectangle(img, b, color_for(labels[i]), thickness)
    return img


def _masks_of(d: Dict) -> Optional[np.ndarray]:
    if d.get("masks") is not None:
        return d["masks"]
    if d.get("masks_rle"):
        return rle_to_masks(d["masks_rle"])
    return None


def save_eval_previews(
    out_dir: Path,
    name: str,
    image_rgb: np.ndarray,
    pred: Dict,
    gt: Dict,
    label_to_name: Optional[Dict[int, str]] = None,
) -> Path:
    """Side-by-side GT (left) and prediction (right) preview as
    ``<out_dir>/<name>.png``; masks come dense or as RLEs. ``label_to_name``
    is kept for the JAX signature (no text is drawn)."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    bgr = image_rgb[..., ::-1]
    left = draw_detections(bgr, gt["boxes"], gt["labels"], masks=_masks_of(gt))
    right = draw_detections(bgr, pred["boxes"], pred["labels"], pred.get("scores"),
                            _masks_of(pred), label_to_name)
    path = out_dir / f"{name}.png"
    write_png(path, np.concatenate([left, right], axis=1)[..., ::-1])
    return path
