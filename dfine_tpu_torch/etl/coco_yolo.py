"""COCO <-> YOLO annotation converters (port of
``dfine_tpu/etl/coco_yolo.py``):

    python -m dfine_tpu_torch.etl.coco_yolo coco2yolo <coco.json> <out_labels> [--segment]
    python -m dfine_tpu_torch.etl.coco_yolo yolo2coco [config.yaml] [key.path=value ...]

``yolo2coco`` reads each image's size from its header (``image_io.
image_size``), not by decoding it.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from ..config import cli_config
from ..data.image_io import image_size
from ..data.labels import parse_yolo_label_file

IMG_EXT = {".jpg", ".jpeg", ".png", ".bmp", ".webp"}


def coco_to_yolo(coco_json: Path, out_labels: Path, segment: bool = False) -> Dict[int, str]:
    """COCO instances json -> YOLO txt per image; returns {class_id: name}
    with ids remapped to a contiguous 0..C-1 range."""
    coco = json.loads(Path(coco_json).read_text())
    out_labels = Path(out_labels)
    out_labels.mkdir(parents=True, exist_ok=True)
    cats = sorted(coco["categories"], key=lambda c: c["id"])
    id_map = {c["id"]: i for i, c in enumerate(cats)}
    names = {i: c["name"] for i, c in enumerate(cats)}
    images = {im["id"]: im for im in coco["images"]}
    lines: Dict[int, list] = {im_id: [] for im_id in images}
    for ann in coco["annotations"]:
        im = images[ann["image_id"]]
        w, h = im["width"], im["height"]
        cls = id_map[ann["category_id"]]
        if segment and ann.get("segmentation") and isinstance(ann["segmentation"], list):
            poly = np.asarray(ann["segmentation"][0], np.float32).reshape(-1, 2)
            poly[:, 0] /= w
            poly[:, 1] /= h
            pts = " ".join(f"{v:.6f}" for v in poly.reshape(-1))
            lines[ann["image_id"]].append(f"{cls} {pts}")
        else:
            x, y, bw, bh = ann["bbox"]
            lines[ann["image_id"]].append(
                f"{cls} {(x + bw / 2) / w:.6f} {(y + bh / 2) / h:.6f} {bw / w:.6f} {bh / h:.6f}"
            )
    for im_id, im in images.items():
        if lines[im_id]:
            (out_labels / (Path(im["file_name"]).stem + ".txt")).write_text(
                "\n".join(lines[im_id]) + "\n"
            )
    return names


def yolo_to_coco(
    data_path: Path,
    out_json: Path,
    label_to_name: Dict[int, str],
    segment: bool = False,
) -> None:
    """YOLO layout (images/ + labels/) -> COCO instances json."""
    data_path = Path(data_path)
    images, annotations = [], []
    ann_id = 1
    for img_id, p in enumerate(sorted((data_path / "images").iterdir()), start=1):
        if p.suffix.lower() not in IMG_EXT:
            continue
        hw = image_size(p)
        if hw is None:
            continue
        h, w = hw
        images.append({"id": img_id, "file_name": p.name, "width": w, "height": h})
        lp = data_path / "labels" / (p.stem + ".txt")
        labels, boxes, polys = parse_yolo_label_file(lp, segment=segment)
        for i, cls in enumerate(labels):
            cx, cy, bw, bh = boxes[i]
            ann = {
                "id": ann_id,
                "image_id": img_id,
                "category_id": int(cls),
                "bbox": [float((cx - bw / 2) * w), float((cy - bh / 2) * h),
                         float(bw * w), float(bh * h)],
                "area": float(bw * w * bh * h),
                "iscrowd": 0,
            }
            if segment and polys:
                poly = polys[i] * np.asarray([w, h], np.float32)
                ann["segmentation"] = [poly.reshape(-1).tolist()]
            annotations.append(ann)
            ann_id += 1
    coco = {
        "images": images,
        "annotations": annotations,
        "categories": [{"id": int(k), "name": v} for k, v in label_to_name.items()],
    }
    Path(out_json).write_text(json.dumps(coco))
    print(f"wrote {out_json}: {len(images)} images, {len(annotations)} annotations")


def main(argv: Optional[List[str]] = None) -> None:
    argv = argv if argv is not None else sys.argv[1:]
    if argv and argv[0] == "coco2yolo":
        names = coco_to_yolo(Path(argv[1]), Path(argv[2]), segment="--segment" in argv)
        print(names)
    elif argv and argv[0] == "yolo2coco":
        cfg = cli_config(argv[1:])
        yolo_to_coco(
            Path(cfg.train.data_path),
            Path(cfg.train.data_path) / "coco.json",
            {int(k): v for k, v in cfg.train.label_to_name.items()},
            segment=cfg.task == "segment",
        )
    else:
        print("usage: python -m dfine_tpu_torch.etl.coco_yolo coco2yolo <coco.json> "
              "<out_labels> [--segment]\n"
              "       python -m dfine_tpu_torch.etl.coco_yolo yolo2coco [cfg.yaml] [k=v ...]")


if __name__ == "__main__":
    main()
