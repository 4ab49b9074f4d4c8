"""Normalize a raw image dump into the dataset layout (port of
``dfine_tpu/etl/preprocess.py``, ``make preprocess``):

    python -m dfine_tpu_torch.etl.preprocess [config.yaml] [key.path=value ...]

Every image under ``<train.data_path>/images`` is written as ``.jpg`` (its
EXIF orientation applied, RGB, quality 95) by PIL, imported in the worker
that converts it, over a pool of ``train.num_workers`` processes; the
originals that are not ``.jpg`` are then removed and so are empty label
files. Unlike the JAX tool, an original whose conversion failed is kept
(the JAX tool deletes it too, and the image is lost).
"""

from __future__ import annotations

import multiprocessing
import sys
from pathlib import Path
from typing import List, Optional, Tuple

from ..config import cli_config

IMG_EXT = {".jpg", ".jpeg", ".png", ".bmp", ".webp", ".tif", ".tiff", ".heic", ".heif"}


def convert_one(args: Tuple[Path, Path]) -> Optional[str]:
    """``src`` -> ``dst_dir/<stem>.jpg``; None, or the error as text."""
    src, dst_dir = args
    try:
        from PIL import Image, ImageOps

        with Image.open(src) as img:
            img = ImageOps.exif_transpose(img).convert("RGB")
        img.save(dst_dir / (src.stem + ".jpg"), quality=95)
        return None
    except Exception as e:  # any unreadable file: reported, its original kept
        return f"{src}: {e}"


def preprocess(images_dir: Path, labels_dir: Optional[Path] = None,
               workers: int = 8) -> List[str]:
    images_dir = Path(images_dir)
    srcs = [p for p in images_dir.iterdir() if p.suffix.lower() in IMG_EXT]
    with multiprocessing.get_context("spawn").Pool(workers) as pool:
        results = pool.map(convert_one, [(p, images_dir) for p in srcs])
    errors = [e for e in results if e]
    # remove the originals that were converted to .jpg (a failed one stays)
    for p, err in zip(srcs, results):
        if err is None and p.suffix.lower() != ".jpg":
            p.unlink(missing_ok=True)
    if labels_dir and Path(labels_dir).exists():
        for lp in Path(labels_dir).glob("*.txt"):
            if lp.stat().st_size <= 1:
                lp.unlink()
    for e in errors:
        print("ERROR", e)
    print(f"converted {len(srcs) - len(errors)} images, {len(errors)} errors")
    return errors


def main(argv: Optional[List[str]] = None) -> List[str]:
    cfg = cli_config(argv if argv is not None else sys.argv[1:])
    root = Path(cfg.train.data_path)
    return preprocess(root / "images", root / "labels", workers=cfg.train.num_workers)


if __name__ == "__main__":
    main()
