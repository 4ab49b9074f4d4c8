"""Create the train/val/test CSV splits of a dataset (port of
``dfine_tpu/etl/split.py``, ``make split``):

    python -m dfine_tpu_torch.etl.split [config.yaml] [key.path=value ...]

The images under ``<train.data_path>/images`` shuffled with ``train.seed``
(numpy's ``default_rng``, as in JAX: the same seed gives the same split),
cut by ``split.train_split`` and ``split.val_split``; the rest is the test
split, written only where it is not empty.
"""

from __future__ import annotations

import csv
import sys
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from ..config import cli_config

IMG_EXT = {".jpg", ".jpeg", ".png", ".bmp", ".webp"}


def split_dataset(
    data_path: Path,
    train_split: float = 0.85,
    val_split: float = 0.15,
    shuffle: bool = True,
    ignore_negatives: bool = False,
    seed: int = 42,
) -> Dict[str, List[str]]:
    data_path = Path(data_path)
    images = sorted(
        p.name for p in (data_path / "images").iterdir() if p.suffix.lower() in IMG_EXT
    )
    if ignore_negatives:
        images = [
            n for n in images
            if (data_path / "labels" / (Path(n).stem + ".txt")).exists()
            and (data_path / "labels" / (Path(n).stem + ".txt")).stat().st_size > 1
        ]
    if shuffle:
        np.random.default_rng(seed).shuffle(images)
    n = len(images)
    n_train = int(n * train_split)
    n_val = int(n * val_split)
    splits = {
        "train": images[:n_train],
        "val": images[n_train : n_train + n_val],
        "test": images[n_train + n_val :],
    }
    for name, rows in splits.items():
        if not rows and name == "test":
            continue
        with open(data_path / f"{name}.csv", "w", newline="") as f:
            csv.writer(f).writerows([[r] for r in rows])
        print(f"{name}: {len(rows)}")
    return splits


def main(argv: Optional[List[str]] = None) -> Dict[str, List[str]]:
    cfg = cli_config(argv if argv is not None else sys.argv[1:])
    return split_dataset(
        Path(cfg.train.data_path),
        cfg.split.train_split,
        cfg.split.val_split,
        cfg.split.shuffle,
        cfg.split.ignore_negatives,
        cfg.train.seed,
    )


if __name__ == "__main__":
    main()
