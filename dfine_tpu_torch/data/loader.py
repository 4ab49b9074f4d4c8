"""Loader: CSV splits -> batched, prefetched batches (port of
``dfine_tpu/data/loader.py``).

``train.csv / val.csv / test.csv`` (headerless, column 0 = image filename)
under the dataset root with ``images/`` and ``labels/``; label statistics
and background counting; a per-epoch reshuffle; multiscale collate (the
batch's size jittered by one of -64, -32, 0, 32, 64 px).

A thread pool makes the samples (numpy releases the GIL in the per-sample
work; no torch CPU op runs there, since each would take all of torch's
intra-op threads in every worker at once) and a producer thread stacks each
batch. With ``pin_memory`` the
producer also copies the batch into pinned host tensors, so that
``to_device`` is an asynchronous uint8 copy to the card; there the NHWC
images are made NCHW-contiguous, the layout the train step's BatchNorm
kernels take.
"""

from __future__ import annotations

import concurrent.futures as cf
import csv
import threading
from pathlib import Path
from queue import Empty, Full, Queue
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from .dataset import DatasetConfig, DetectionDataset

MULTISCALE_OFFSETS = (-64, -32, 0, 32, 64)  # px a multiscale batch's size moves by


def read_split_csv(path: Path) -> List[str]:
    names = []
    with open(path) as f:
        for row in csv.reader(f):
            if row:
                names.append(row[0].strip())
    return names


def _stack(batch: List[Dict], pin: bool = False) -> Dict:
    out: Dict = {}
    t = {}
    for k in batch[0]:
        stacked = np.stack([b[k] for b in batch], 0)
        if pin:
            stacked = torch.from_numpy(stacked).pin_memory()
        if k == "image":
            out["images"] = stacked
        else:
            t[k] = stacked
    out["targets"] = t
    return out


def to_device(batch: Dict, device: torch.device) -> Dict:
    """A loader batch on ``device``: images [B, 3, H, W] uint8,
    NCHW-contiguous (one uint8 copy of the NHWC batch on the device), labels
    int64, the other targets in their own dtypes. Pinned tensors copy
    without blocking the host."""
    def put(a):
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))
        return t.to(device, non_blocking=t.is_pinned())

    targets = {k: put(v) for k, v in batch["targets"].items()}
    targets["labels"] = targets["labels"].long()
    return {"images": put(batch["images"]).permute(0, 3, 1, 2).contiguous(), "targets": targets}


class BatchIterator:
    """Iterates fixed-size batches with background prefetch."""

    def __init__(
        self,
        dataset: DetectionDataset,
        batch_size: int,
        shuffle: bool,
        num_workers: int = 8,
        drop_last: bool = True,
        seed: int = 42,
        multiscale_prob: float = 0.0,
        prefetch: int = 4,
        pin_memory: bool = False,
    ):
        self.ds = dataset
        self.bs = batch_size
        self.shuffle = shuffle
        self.workers = max(1, num_workers)
        self.drop_last = drop_last
        self.seed = seed
        self.multiscale_prob = multiscale_prob
        self.prefetch = prefetch
        self.pin_memory = pin_memory
        self.epoch = 0
        # True while the producer is making this epoch's batches
        self.producing = False

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        self.ds.set_epoch(epoch)

    def __len__(self) -> int:
        n = len(self.ds)
        return n // self.bs if self.drop_last else (n + self.bs - 1) // self.bs

    def _order(self) -> np.ndarray:
        idx = np.arange(len(self.ds))
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(idx)
        return idx

    def batch_sizes(self):
        """The (h, w) of each batch this epoch, as ``__iter__`` draws them."""
        rng = np.random.default_rng(self.seed * 7919 + self.epoch)
        base_hw = tuple(self.ds.cfg.img_size)
        for _ in range(len(self)):
            if self.ds.mode == "train" and rng.uniform() < self.multiscale_prob:
                d = int(rng.choice(MULTISCALE_OFFSETS))
                yield (base_hw[0] + d, base_hw[1] + d)
            else:
                yield base_hw

    def __iter__(self) -> Iterator[Dict]:
        order = self._order()
        sizes = list(self.batch_sizes())

        q: Queue = Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put_checked(item) -> bool:
            # a bounded put that re-checks stop, so an early-exiting consumer
            # never leaves the producer blocked on a full queue
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except Full:
                    continue
            return False

        def producer():
            try:
                with cf.ThreadPoolExecutor(self.workers) as pool:
                    for i, hw in enumerate(sizes):
                        if stop.is_set():
                            break
                        ids = order[i * self.bs : (i + 1) * self.bs]
                        samples = list(pool.map(lambda j: self.ds.__getitem__(j, img_size=hw), ids))
                        batch = _stack(samples, self.pin_memory)
                        if i == len(sizes) - 1:
                            self.producing = False
                        if not put_checked(batch):
                            return
                put_checked(None)
            except BaseException as e:  # handed to the consumer, which raises it
                put_checked(e)
            finally:
                self.producing = False

        self.producing = True
        th = threading.Thread(target=producer, daemon=True)
        th.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            while not q.empty():  # drain so a producer mid-put sees stop
                try:
                    q.get_nowait()
                except Empty:
                    break
            th.join(timeout=5.0)


class Loader:
    """Split discovery + dataloaders + dataset statistics."""

    def __init__(self, data_path: Path, cfg_train: Dict, task: str = "detect"):
        self.root = Path(data_path)
        self.cfg_train = cfg_train
        label_to_name = cfg_train.get("label_to_name", {0: "object"})
        self.class_names = (
            ["target"] if cfg_train.get("use_one_class") else list(label_to_name.values())
        )
        self.task = task
        self.splits: Dict[str, List[str]] = {}
        for split in ("train", "val", "test"):
            p = self.root / f"{split}.csv"
            self.splits[split] = read_split_csv(p) if p.exists() else []
        if not self.splits["train"] or not self.splits["val"]:
            raise FileNotFoundError(f"train.csv and val.csv must exist in {self.root}")

        self.ds_cfg = DatasetConfig(
            img_size=tuple(cfg_train.get("img_size", (640, 640))),
            task=task,
            keep_ratio=cfg_train.get("keep_ratio", False),
            max_gt=cfg_train.get("max_gt", 100),
            use_one_class=cfg_train.get("use_one_class", False),
            seed=cfg_train.get("seed", 42),
            augs=dict(cfg_train.get("augs", {})),
            mosaic_augs=dict(cfg_train.get("mosaic_augs", {})),
            ignore_background_epochs=cfg_train.get("ignore_background_epochs", 0),
            epochs=cfg_train.get("epochs", 100),
            debug_img_path=str(cfg_train.get("debug_img_path", ""))
            if cfg_train.get("debug_img_processing")
            else "",
            cache_images_mb=int(cfg_train.get("cache_images_mb", 0)),
        )

    def dataset(self, split: str, mode: Optional[str] = None) -> DetectionDataset:
        import copy

        cfg = copy.deepcopy(self.ds_cfg)
        return DetectionDataset(self.root, self.splits[split], cfg, mode=mode or split)

    def build_dataloaders(self, batch_size: int, num_workers: int = 8, pin_memory: bool = False):
        def make(split, train):
            return BatchIterator(
                self.dataset(split), batch_size, shuffle=train, num_workers=num_workers,
                drop_last=train, seed=self.ds_cfg.seed,
                multiscale_prob=self.ds_cfg.augs.get("multiscale_prob", 0.0) if train else 0.0,
                pin_memory=pin_memory)

        return (make("train", True), make("val", False),
                make("test", False) if self.splits["test"] else None)

    # ----------------------------------------------------------- statistics

    def label_stats(self) -> Dict[str, int]:
        """Per-class instance counts over all splits."""
        from .labels import parse_yolo_label_file

        counts = {c: 0 for c in self.class_names}
        for names in self.splits.values():
            for n in names:
                p = self.root / "labels" / (Path(n).stem + ".txt")
                labels, _, _ = parse_yolo_label_file(p, segment=self.task == "segment")
                for c in labels:
                    key = "target" if self.cfg_train.get("use_one_class") else (
                        self.class_names[int(c)] if int(c) < len(self.class_names) else str(c)
                    )
                    counts[key] = counts.get(key, 0) + 1
        return counts

    def background_count(self) -> int:
        """Images in the splits without a non-empty label file."""
        n = 0
        for names in self.splits.values():
            for name in names:
                p = self.root / "labels" / (Path(name).stem + ".txt")
                if not p.exists() or p.stat().st_size <= 1:
                    n += 1
        return n
