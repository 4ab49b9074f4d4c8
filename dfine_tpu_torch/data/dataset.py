"""Dataset: disk -> fixed-shape padded training arrays (port of
``dfine_tpu/data/dataset.py``, without cv2).

Every sample leaves as ``image [H, W, 3]`` uint8 RGB (the model normalizes
integer input itself) plus a padded target block: ``labels [G]``, ``boxes
[G, 4]`` normalized cxcywh, ``valid [G]`` and, for segmentation, ``masks
[G, H/4, W/4]`` uint8 at the mask head's stride with ``mask_valid``. G =
``max_gt``.

Augmentations: the photometric and geometric chains (``augment.py``),
mosaic with close-mosaic epochs (``mosaic.py``), letterbox or plain resize,
ignore-background epochs. Each sample draws from its own generator, seeded
from sha256 of ``seed-epoch-index``, so a sample is the same whichever
thread makes it and the same as the JAX package's.
"""

from __future__ import annotations

import hashlib
import threading
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from .augment import (
    apply_letterbox_to_geoms,
    geometric_pipeline,
    letterbox,
    photometric_pipeline,
    plain_resize,
)
from .image_io import read_image, write_png
from .labels import parse_yolo_label_file, polygons_to_masks
from .mosaic import build_mosaic

Sample = Dict[str, np.ndarray]
MASK_STRIDE = 4  # the mask head's output stride


@dataclass
class DatasetConfig:
    img_size: Tuple[int, int] = (640, 640)
    task: str = "detect"  # detect | segment
    keep_ratio: bool = False
    max_gt: int = 100
    use_one_class: bool = False
    seed: int = 42
    augs: Dict = field(default_factory=dict)
    mosaic_augs: Dict = field(default_factory=dict)
    ignore_background_epochs: int = 0
    epochs: int = 100
    debug_img_path: str = ""  # when set, dump augmented samples with their geometry
    # RAM budget (MB) for decoded images and geometry, 0 = off; caching stops
    # at the budget, so a large dataset gets a partial cache
    cache_images_mb: int = 0


class DetectionDataset:
    def __init__(
        self,
        root: Path,
        image_names: List[str],
        cfg: DatasetConfig,
        mode: str = "train",  # train | val | test | bench
    ):
        self.root = Path(root)
        self.names = list(image_names)
        self.cfg = cfg
        self.mode = mode
        self.epoch = 0
        self.segment = cfg.task == "segment"
        self._train = mode == "train"
        # decoded-sample RAM cache, shared with the loader's threads. Augment
        # ops never write load_raw arrays in place, so the arrays are shared
        # and only the dict (and the polygon list) is copied per call.
        self._cache: Dict[int, Sample] = {}
        self._cache_bytes = 0
        self._cache_lock = threading.Lock()

    def __len__(self) -> int:
        return len(self.names)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    # ------------------------------------------------------------- raw IO

    def _paths(self, idx: int) -> Tuple[Path, Path]:
        name = self.names[idx]
        img_path = self.root / "images" / name
        lbl_path = self.root / "labels" / (Path(name).stem + ".txt")
        return img_path, lbl_path

    def load_raw(self, idx: int) -> Sample:
        """Image (RGB uint8) + absolute-pixel geometry."""
        cap = self.cfg.cache_images_mb << 20
        if cap:
            with self._cache_lock:
                hit = self._cache.get(idx)
            if hit is not None:
                out = dict(hit)
                if "polygons" in out:
                    out["polygons"] = list(out["polygons"])
                return out
        img_path, lbl_path = self._paths(idx)
        img = read_image(img_path)
        h, w = img.shape[:2]
        labels, boxes_n, polys = parse_yolo_label_file(lbl_path, segment=self.segment)
        if self.cfg.use_one_class:
            labels = np.zeros_like(labels)
        # normalized cxcywh -> absolute xyxy
        cx, cy, bw, bh = boxes_n[:, 0] * w, boxes_n[:, 1] * h, boxes_n[:, 2] * w, boxes_n[:, 3] * h
        boxes = np.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2], -1).astype(
            np.float32
        ).reshape(-1, 4)
        s: Sample = {"image": img, "boxes": boxes, "labels": labels}
        if self.segment:
            s["polygons"] = [p * np.asarray([w, h], np.float32) for p in (polys or [])]
        if cap:
            nbytes = img.nbytes + boxes.nbytes + labels.nbytes + sum(
                p.nbytes for p in s.get("polygons", [])
            )
            with self._cache_lock:
                if idx not in self._cache and self._cache_bytes + nbytes <= cap:
                    snap = dict(s)
                    if "polygons" in snap:
                        snap["polygons"] = list(snap["polygons"])
                    self._cache[idx] = snap
                    self._cache_bytes += nbytes
        return s

    # ----------------------------------------------------------- pipeline

    def _rng(self, idx: int) -> np.random.Generator:
        key = f"{self.cfg.seed}-{self.epoch}-{idx}".encode()
        return np.random.default_rng(int.from_bytes(hashlib.sha256(key).digest()[:8], "little"))

    def _mosaic_active(self, rng) -> bool:
        ma = self.cfg.mosaic_augs
        prob = ma.get("mosaic_prob", 0.0)
        if not self._train or prob <= 0:
            return False
        if self.epoch >= self.cfg.epochs - ma.get("no_mosaic_epochs", 0):
            return False  # close-mosaic in the final epochs
        return rng.uniform() < prob

    def __getitem__(self, idx: int, img_size: Optional[Tuple[int, int]] = None) -> Sample:
        # img_size overrides cfg.img_size for this sample only: the multiscale
        # collate passes the batch's size per call
        size = tuple(img_size) if img_size is not None else self.cfg.img_size
        rng = self._rng(idx)
        if self._train and self.epoch < self.cfg.ignore_background_epochs:
            for _ in range(32):
                s = self.load_raw(idx)
                if len(s["labels"]):
                    break
                idx = int(rng.integers(0, len(self)))
            else:
                s = self.load_raw(idx)
        else:
            s = None

        if self._train and self._mosaic_active(rng):
            ids = [idx] + [int(rng.integers(0, len(self))) for _ in range(3)]
            parts = [self.load_raw(i) for i in ids]
            s = build_mosaic(parts, rng, size, self.cfg.mosaic_augs)
            s = photometric_pipeline(s, rng, self.cfg.augs)
        else:
            if s is None:
                s = self.load_raw(idx)
            if self._train:
                s = geometric_pipeline(s, rng, self.cfg.augs)
                s = photometric_pipeline(s, rng, self.cfg.augs)
            if self.cfg.keep_ratio:
                img, scale, pad = letterbox(s["image"], size)
                s["image"] = img
                s = apply_letterbox_to_geoms(s, scale, pad)
            else:
                s = plain_resize(s, size)
        if self.cfg.debug_img_path and self._train:
            self._dump_debug(s, idx)
        return self.finalize(s)

    def _dump_debug(self, s: Sample, idx: int, limit: int = 50) -> None:
        """Save the augmented sample with its boxes (green) and polygons
        (red) drawn, as PNG; the JAX package's class-id text is left out."""
        from ..utils.viz import draw_polyline, draw_rectangle

        out = Path(self.cfg.debug_img_path)
        out.mkdir(parents=True, exist_ok=True)
        if len(list(out.glob("*.png"))) >= limit:
            return
        img = s["image"].copy()
        for b in np.asarray(s["boxes"]).astype(int):
            draw_rectangle(img, b, (0, 255, 0), 2)
        for poly in s.get("polygons") or []:
            draw_polyline(img, np.asarray(poly, np.int32), (255, 0, 0))
        write_png(out / f"ep{self.epoch}_{idx}.png", img)

    def finalize(self, s: Sample) -> Sample:
        """Absolute geometry -> normalized padded arrays."""
        h, w = s["image"].shape[:2]
        g = self.cfg.max_gt
        n = min(len(s["labels"]), g)

        labels = np.zeros((g,), np.int32)
        boxes = np.full((g, 4), 0.5, np.float32)
        valid = np.zeros((g,), bool)
        if n:
            b = s["boxes"][:n]
            cx = (b[:, 0] + b[:, 2]) / 2 / w
            cy = (b[:, 1] + b[:, 3]) / 2 / h
            bw = (b[:, 2] - b[:, 0]) / w
            bh = (b[:, 3] - b[:, 1]) / h
            boxes[:n] = np.stack([cx, cy, bw, bh], -1)
            labels[:n] = s["labels"][:n]
            valid[:n] = True

        out: Sample = {
            "image": np.ascontiguousarray(s["image"]),
            "labels": labels,
            "boxes": np.clip(boxes, 0.0, 1.0),
            "valid": valid,
        }
        if self.segment:
            mh, mw = h // MASK_STRIDE, w // MASK_STRIDE
            masks = np.zeros((g, mh, mw), np.uint8)
            if n and s.get("polygons"):
                m = polygons_to_masks(s["polygons"][:n], h, w, scale=1.0 / MASK_STRIDE)
                masks[: len(m), : m.shape[1], : m.shape[2]] = m
            out["masks"] = masks
            out["mask_valid"] = valid.copy()
        return out

    # --------------------------------------------------------------- eval

    def load_for_eval(self, idx: int) -> Tuple[Sample, Dict]:
        """Eval-time sample: deterministic resize only, plus the original
        image's metadata for un-mapping boxes and masks."""
        s = self.load_raw(idx)
        orig_h, orig_w = s["image"].shape[:2]
        gt = {
            "labels": s["labels"].copy(),
            "boxes_abs": s["boxes"].copy(),  # xyxy in original pixels
            "polygons": [p.copy() for p in s.get("polygons", [])] if self.segment else None,
            "orig_size": (orig_h, orig_w),
            "name": None,
        }
        if self.cfg.keep_ratio:
            img, scale, pad = letterbox(s["image"], self.cfg.img_size)
            s["image"] = img
            s = apply_letterbox_to_geoms(s, scale, pad)
            gt["scale"], gt["pad"] = scale, pad
        else:
            s = plain_resize(s, self.cfg.img_size)
            gt["scale"], gt["pad"] = None, (0, 0)
        return self.finalize(s), gt
