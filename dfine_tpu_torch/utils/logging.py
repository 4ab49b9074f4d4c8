"""Logging and metrics sinks (port of ``dfine_tpu/utils/logging.py``).

Console plus a per-experiment ``train_log.txt``, the ``metrics.csv`` /
``extended_metrics.csv`` tables, and a wandb gate that stays off unless
wandb imports and is enabled.
"""

from __future__ import annotations

import csv
import logging
import sys
from pathlib import Path
from typing import Dict, Optional


def get_logger(log_file: Optional[Path] = None, name: str = "dfine_tpu_torch") -> logging.Logger:
    """The package's logger: console, and ``log_file`` where given. A later
    call with another ``log_file`` moves the file handler there."""
    logger = logging.getLogger(name)
    fmt = logging.Formatter("%(asctime)s | %(levelname)s | %(message)s", "%H:%M:%S")
    if not logger.handlers:
        logger.setLevel(logging.INFO)
        sh = logging.StreamHandler(sys.stdout)
        sh.setFormatter(fmt)
        logger.addHandler(sh)
        logger.propagate = False
    if log_file is not None:
        log_file = Path(log_file).resolve()
        for h in [h for h in logger.handlers if isinstance(h, logging.FileHandler)]:
            if Path(h.baseFilename) == log_file:
                return logger
            logger.removeHandler(h)
            h.close()
        log_file.parent.mkdir(parents=True, exist_ok=True)
        fh = logging.FileHandler(log_file)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


class MetricsCSV:
    """Append-mode CSV with a stable header (the first row's keys)."""

    def __init__(self, path: Path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._header = None

    def log(self, row: Dict) -> None:
        row = {k: (float(v) if hasattr(v, "item") else v) for k, v in row.items()}
        new = not self.path.exists()
        if self._header is None:
            if new:
                self._header = list(row.keys())
            else:  # appending to a run's file (resume): keep its header
                with open(self.path, newline="") as f:
                    self._header = next(csv.reader(f), list(row.keys()))
        with open(self.path, "a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=self._header, extrasaction="ignore")
            if new:
                w.writeheader()
            w.writerow(row)


class WandbGate:
    """No-op unless wandb is importable and enabled."""

    def __init__(self, enabled: bool, project: str, exp: str, config: dict):
        self.run = None
        if not enabled:
            return
        try:
            import wandb

            self.run = wandb.init(project=project, name=exp, config=config)
        except Exception:
            self.run = None

    def log(self, data: Dict, step: Optional[int] = None) -> None:
        if self.run is not None:
            self.run.log(data, step=step)

    def watch(self, model, grad_norm: Optional[float] = None,
              step: Optional[int] = None, sample: int = 8192) -> None:
        """Per-epoch parameter histograms, one per top-level module (walked
        by ``named_parameters``), and the scalar grad norm."""
        if self.run is None:
            return
        try:
            import numpy as np
            import wandb

            groups: Dict[str, list] = {}
            for name, p in model.named_parameters():
                groups.setdefault(name.split(".")[0], []).append(
                    p.detach().float().reshape(-1).cpu().numpy())
            data: Dict = {}
            for name, arrs in groups.items():
                flat = np.concatenate(arrs)
                if flat.size > sample:
                    flat = flat[:: max(1, flat.size // sample)]
                data[f"params/{name}"] = wandb.Histogram(flat)
            if grad_norm is not None:
                data["grad_norm"] = float(grad_norm)
            self.run.log(data, step=step)
        except Exception:
            pass

    def finish(self) -> None:
        if self.run is not None:
            self.run.finish()
