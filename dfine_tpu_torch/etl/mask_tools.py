"""Mask and label dataset fixers (port of ``dfine_tpu/etl/mask_tools.py``):

    python -m dfine_tpu_torch.etl.mask_tools <command> args...

Commands: ``png_mask_to_yolo <masks_dir> <out_labels> [class_id]``,
``split_from_yolo <yolo_root> <data_path>``, ``clean_csv <data_path>``,
``create_test_csv <data_path> <test_dir>``, ``remove_dups <images_dir>
[--dry-run]``, ``remove_class <labels_dir> <class_id>``. The cv2 calls of
the JAX tools have their counterparts here, each equal to cv2's result:
``image_io.read_gray``, ``infer.contours`` (``findContours``,
``contourArea``, ``arcLength``, ``approxPolyDP``) and
``data.augment.resize_area`` (``INTER_AREA``).
"""

from __future__ import annotations

import csv
import sys
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from ..data.augment import resize_area
from ..data.image_io import read_gray
from ..infer.contours import approx_poly_closed, arc_length, contour_area, find_external_contours

IMG_EXT = {".jpg", ".jpeg", ".png", ".bmp", ".webp"}


def png_mask_to_yolo(
    mask_path: Path, class_id: int = 0, epsilon_frac: float = 0.005, min_area: float = 10.0
) -> List[str]:
    """Binary PNG mask -> YOLO polygon rows (Douglas-Peucker simplified)."""
    m = read_gray(mask_path)
    if m is None:
        return []
    h, w = m.shape
    rows = []
    for c in find_external_contours(m > 127):
        if contour_area(c) < min_area or len(c) < 3:
            continue
        eps = epsilon_frac * arc_length(c)
        approx = approx_poly_closed(c, eps).reshape(-1, 2).astype(np.float32)
        if len(approx) < 3:
            continue
        approx[:, 0] /= w
        approx[:, 1] /= h
        rows.append(f"{class_id} " + " ".join(f"{v:.6f}" for v in approx.reshape(-1)))
    return rows


def convert_png_masks(masks_dir: Path, out_labels: Path, class_id: int = 0) -> None:
    out_labels = Path(out_labels)
    out_labels.mkdir(parents=True, exist_ok=True)
    n = 0
    for p in sorted(Path(masks_dir).glob("*.png")):
        rows = png_mask_to_yolo(p, class_id)
        if rows:
            (out_labels / f"{p.stem}.txt").write_text("\n".join(rows) + "\n")
            n += 1
    print(f"converted {n} masks")


def split_from_yolo(yolo_root: Path, data_path: Path) -> None:
    """Adopt an Ultralytics-style train/val dir split into the CSV layout."""
    data_path = Path(data_path)
    for split in ("train", "val", "test"):
        d = Path(yolo_root) / "images" / split
        if not d.exists():
            continue
        names = [p.name for p in sorted(d.iterdir()) if p.suffix.lower() in IMG_EXT]
        with open(data_path / f"{split}.csv", "w", newline="") as f:
            csv.writer(f).writerows([[n] for n in names])
        print(f"{split}: {len(names)}")


def clean_csv(data_path: Path) -> None:
    """Drop CSV rows whose image no longer exists."""
    data_path = Path(data_path)
    for split in ("train", "val", "test"):
        p = data_path / f"{split}.csv"
        if not p.exists():
            continue
        with open(p, newline="") as f:
            rows = [r for r in csv.reader(f) if r and (data_path / "images" / r[0]).exists()]
        with open(p, "w", newline="") as f:
            csv.writer(f).writerows(rows)
        print(f"{split}: kept {len(rows)}")


def create_test_csv(data_path: Path, test_dir: Path) -> None:
    """All images of a folder -> test.csv."""
    names = [p.name for p in sorted(Path(test_dir).iterdir()) if p.suffix.lower() in IMG_EXT]
    with open(Path(data_path) / "test.csv", "w", newline="") as f:
        csv.writer(f).writerows([[n] for n in names])
    print(f"test: {len(names)}")


def remove_dups(images_dir: Path, hash_size: int = 8, dry_run: bool = False) -> List[Path]:
    """Perceptual-hash dedup: an average hash over the grayscale image
    shrunk to ``hash_size`` x ``hash_size`` by area."""
    seen: Dict[bytes, Path] = {}
    dups = []
    for p in sorted(Path(images_dir).iterdir()):
        if p.suffix.lower() not in IMG_EXT:
            continue
        img = read_gray(p)
        if img is None:
            continue
        small = resize_area(img, (hash_size, hash_size))
        h = (small > small.mean()).tobytes()
        if h in seen:
            dups.append(p)
            if not dry_run:
                p.unlink()
        else:
            seen[h] = p
    print(f"{'found' if dry_run else 'removed'} {len(dups)} duplicates")
    return dups


def remove_class(labels_dir: Path, class_id: int, remap: bool = True) -> None:
    """Strip a class from every label file, optionally remapping ids down."""
    n = 0
    for p in Path(labels_dir).glob("*.txt"):
        rows = []
        for line in p.read_text().splitlines():
            parts = line.split()
            if not parts:
                continue
            c = int(float(parts[0]))
            if c == class_id:
                continue
            if remap and c > class_id:
                c -= 1
            rows.append(" ".join([str(c)] + parts[1:]))
        if rows:
            p.write_text("\n".join(rows) + "\n")
        else:
            p.unlink()
        n += 1
    print(f"processed {n} label files")


def main(argv: Optional[List[str]] = None) -> None:
    argv = argv if argv is not None else sys.argv[1:]
    cmds = {
        "png_mask_to_yolo": lambda a: convert_png_masks(Path(a[0]), Path(a[1]),
                                                        int(a[2]) if len(a) > 2 else 0),
        "split_from_yolo": lambda a: split_from_yolo(Path(a[0]), Path(a[1])),
        "clean_csv": lambda a: clean_csv(Path(a[0])),
        "create_test_csv": lambda a: create_test_csv(Path(a[0]), Path(a[1])),
        "remove_dups": lambda a: remove_dups(Path(a[0]), dry_run="--dry-run" in a),
        "remove_class": lambda a: remove_class(Path(a[0]), int(a[1])),
    }
    if not argv or argv[0] not in cmds:
        print("usage: python -m dfine_tpu_torch.etl.mask_tools <" + "|".join(cmds) + "> args...")
        return
    cmds[argv[0]](argv[1:])


if __name__ == "__main__":
    main()
