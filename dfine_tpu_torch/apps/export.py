"""Export the best checkpoint as serving artifacts (port of
``dfine_tpu/apps/export.py``, ``make export``):

    python -m dfine_tpu_torch.apps.export [config.yaml] [key.path=value ...]

Writes ``<experiment>/export/`` from ``best.ckpt`` (its EMA weights) by
``dfine_tpu_torch.export.export_model``. ``export.formats`` takes the JAX
names: ``stablehlo`` (the JAX ``jax.export`` artifact) is written as its
counterpart here, ``exported`` (a ``torch.export`` ``.pt2``), and the log
says so; ``aot`` and ``npz`` keep their names. ``export.half``,
``export.max_batch_size`` and ``export.dynamic_input`` as in JAX. Runs on
the card; ``device="cpu"`` (tests) runs the plain path.
"""

from __future__ import annotations

import sys
from typing import Dict, List, Optional

from ..config import cli_config
from ..device import resolve_device
from ..export import export_model
from .common import experiment_dir, num_outputs

# JAX format name -> the port's
FORMATS = {"aot": "aot", "stablehlo": "exported", "exported": "exported", "npz": "npz"}


def main(argv: Optional[List[str]] = None, device=None) -> Dict:
    dev = resolve_device(device)
    cfg = cli_config(argv if argv is not None else sys.argv[1:])
    t = cfg.train
    exp_dir = experiment_dir(cfg)
    asked = list(cfg.export.get("formats", ("aot", "stablehlo", "npz")))
    unknown = [f for f in asked if f not in FORMATS]
    if unknown:
        raise ValueError(f"export.formats {unknown}: the port writes {sorted(FORMATS)}")
    for f in asked:
        if FORMATS[f] != f:
            print(f"format {f}: written as {FORMATS[f]} (a torch.export .pt2 program)")
    artifacts = export_model(
        cfg.model_name, str(exp_dir / "best.ckpt"), num_outputs(cfg), exp_dir / "export",
        input_size=tuple(t.img_size), half=bool(cfg.export.half),
        max_batch_size=int(cfg.export.max_batch_size), enable_mask_head=cfg.task == "segment",
        formats=tuple(dict.fromkeys(FORMATS[f] for f in asked)),
        dynamic_batch=bool(cfg.export.get("dynamic_input", False)), device=dev)
    for fmt, path in artifacts.items():
        print(f"exported {fmt}: {path}")
    return artifacts


if __name__ == "__main__":
    main()
