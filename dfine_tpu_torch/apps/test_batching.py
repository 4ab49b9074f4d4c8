"""Throughput and latency an image over batch sizes (port of
``dfine_tpu/apps/test_batching.py``, ``make test_batching``):

    python -m dfine_tpu_torch.apps.test_batching [config.yaml] [key.path=value ...]

The config's model size with ``build_model``'s seeded weights in bf16 at
``train.img_size``, the top-300 decode without masks (so without the mask
head: the JAX program drops it as dead code), on uniform random inputs:
for each batch size, n_images // batch calls after one that makes the
program, timed to the end of the last. On the card each batch size runs as
a CUDA graph (``infer.aot_model.GraphProgram``, the counterpart of the JAX
``jax.jit``: one compiled program, not Python launches); on the CPU
(``device="cpu"``, tests) eagerly. Writes ``batching.csv`` under
``train.path_to_save`` and prints the optimum.
"""

from __future__ import annotations

import csv
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import cli_config
from ..device import resolve_device
from ..infer.aot_model import GraphProgram, pool_bytes
from ..models.dfine import build_model
from ..postprocess import topk_decode
from .common import num_outputs

N_IMAGES = 512
BATCH_SIZES = (1, 2, 4, 8, 16, 32)
CSV_FIELDS = ("batch_size", "throughput_img_s", "latency_per_img_ms")


def sweep(model_name: str, n_outputs: int, img_size: Tuple[int, int], n_images: int,
          batch_sizes: Sequence[int], device) -> List[Dict]:
    """One row a batch size: ``CSV_FIELDS``, plus on the card the bytes the
    batch's graph took in its memory pool (``graph_pool_bytes``)."""
    dev = resolve_device(device)
    model = build_model(model_name, n_outputs, False, dtype=torch.bfloat16, device=dev)
    h, w = img_size

    def infer(images):
        out = model(images)
        return topk_decode(out["pred_logits"], out["pred_boxes"], 300)

    rows = []
    for bs in batch_sizes:
        batch = torch.from_numpy(np.random.default_rng(bs).uniform(size=(bs, h, w, 3))
                                 .astype(np.float32)).to(dev).permute(0, 3, 1, 2)
        row = {}
        with torch.inference_mode():
            if dev.type == "cuda":
                pool = torch.cuda.graph_pool_handle()
                f = GraphProgram(infer, tuple(batch.shape), dev, pool)
                row["graph_pool_bytes"] = pool_bytes(pool)
            else:
                f = infer
            f(batch)  # the program made and run once
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            iters = max(1, n_images // bs)
            t0 = time.perf_counter()
            for _ in range(iters):
                out = f(batch)
            out["scores"].cpu()  # waits for the last call
            dt = time.perf_counter() - t0
        del f
        row = {"batch_size": bs, "throughput_img_s": round(iters * bs / dt, 1),
               "latency_per_img_ms": round(1000 * dt / (iters * bs), 2), **row}
        rows.append(row)
        print(row)
    return rows


def main(argv: Optional[List[str]] = None, device=None) -> List[Dict]:
    dev = resolve_device(device)
    cfg = cli_config(argv if argv is not None else sys.argv[1:])
    t = cfg.train
    rows = sweep(cfg.model_name, num_outputs(cfg), tuple(t.img_size), N_IMAGES, BATCH_SIZES, dev)
    out_csv = Path(t.get("path_to_save", ".")) / "batching.csv"
    out_csv.parent.mkdir(parents=True, exist_ok=True)
    with open(out_csv, "w", newline="") as fcsv:
        wtr = csv.DictWriter(fcsv, fieldnames=list(CSV_FIELDS), extrasaction="ignore")
        wtr.writeheader()
        wtr.writerows(rows)
    best = max(rows, key=lambda r: r["throughput_img_s"])
    print(f"optimum: bs={best['batch_size']} ({best['throughput_img_s']} img/s)")
    return rows


if __name__ == "__main__":
    main()
