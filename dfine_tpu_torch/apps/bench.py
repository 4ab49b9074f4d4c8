"""Every serving backend over the val split, side by side (port of
``dfine_tpu/apps/bench.py``, ``make bench``):

    python -m dfine_tpu_torch.apps.bench [config.yaml] [key.path=value ...]

Per backend: the mean latency a val image (the backend's ``__call__``:
preprocess, program, postprocess; host clock; the first image left out,
when the programs are made) and F1, precision, recall and IoU from
``Validator`` at the config's thresholds, then a markdown table; the first
10 images drawn under ``train.bench_img_path/<backend>``. The backends, in
place of the JAX package's three:

- ``torch-eager``: ``TorchModel``;
- ``torch-cuda-graph``: ``AOTModel`` (a CUDA graph of the program);
- ``torch-export``: ``ExportedModel`` on the ``.pt2`` that ``apps.export``
  wrote under ``<experiment>/export``, else exported in process.

A backend that fails is reported and the others run, as in JAX, but the
command then exits non-zero. On the card; ``device="cpu"``: the plain path.
"""

from __future__ import annotations

import sys
import time
import traceback
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from ..config import cli_config
from ..data.image_io import read_bgr, write_image
from ..data.loader import Loader
from ..device import resolve_device
from ..eval.validator import Validator
from ..infer import AOTModel, ExportedModel, TorchModel
from ..utils.viz import draw_detections
from .common import experiment_dir, label_names, serving_kwargs


def test_model(model, ds, label_to_name: Dict[int, str], iou_thresh: float,
               viz_dir: Optional[Path] = None) -> Dict:
    preds, gts, times = [], [], []
    for i in range(len(ds)):
        img_path, _ = ds._paths(i)
        img = read_bgr(img_path)
        t0 = time.perf_counter()
        (res,) = model(img)
        times.append(time.perf_counter() - t0)
        res["all_boxes"], res["all_scores"], res["all_labels"] = (
            res["boxes"], res["scores"], res["labels"],
        )
        preds.append(res)
        raw = ds.load_raw(i)
        gts.append({"labels": raw["labels"],
                    "boxes": raw["boxes"]})
        if viz_dir is not None and i < 10:
            viz_dir.mkdir(parents=True, exist_ok=True)
            write_image(viz_dir / img_path.name,
                        draw_detections(img, res["boxes"], res["labels"],
                                        res["scores"], res.get("masks"), label_to_name))
    v = Validator(gts, preds, label_to_name, iou_thresh=iou_thresh)
    m = v.compute_metrics()
    lat = float(np.mean(times[1:]) * 1000) if len(times) > 1 else float(times[0] * 1000)
    return {"f1": m["f1"], "precision": m["precision"], "recall": m["recall"],
            "iou": m["iou"], "latency_ms": round(lat, 2)}


def main(argv: Optional[List[str]] = None, device=None) -> List[Dict]:
    dev = resolve_device(device)
    cfg = cli_config(argv if argv is not None else sys.argv[1:])
    t = cfg.train
    exp_dir = experiment_dir(cfg)
    weights = str(exp_dir / "best.ckpt")
    label_to_name = label_names(cfg)
    ds = Loader(Path(t.data_path), t, task=cfg.task).dataset("val", mode="bench")
    kw = serving_kwargs(cfg, dev)
    pt2 = exp_dir / "export" / f"dfine_{cfg.model_name}.pt2"
    backends = {
        "torch-eager": lambda: TorchModel(cfg.model_name, weights, **kw),
        "torch-cuda-graph": lambda: AOTModel(cfg.model_name, weights, **kw),
        "torch-export": lambda: ExportedModel(cfg.model_name, weights,
                                              artifact_path=str(pt2) if pt2.exists() else None,
                                              **kw),
    }
    rows: List[Dict] = []
    failed = []
    for name, ctor in backends.items():
        try:
            r = test_model(ctor(), ds, label_to_name, t.iou_thresh,
                           viz_dir=Path(t.bench_img_path) / name)
        except Exception as e:  # a backend that fails: report it, run the others
            traceback.print_exc()
            print(f"{name}: FAILED ({type(e).__name__}: {e})")
            failed.append(name)
            continue
        rows.append({"backend": name, **r})
        print(f"{name}: {r}")
    if rows:
        hdr = list(rows[0].keys())
        print("\n| " + " | ".join(hdr) + " |")
        print("|" + "---|" * len(hdr))
        for r in rows:
            print("| " + " | ".join(str(r[h]) for h in hdr) + " |")
    if failed:
        sys.exit(f"bench: backends failed: {', '.join(failed)}")
    return rows


if __name__ == "__main__":
    main()
