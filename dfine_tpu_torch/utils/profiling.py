"""Profiling and observability (port of ``dfine_tpu/utils/profiling.py``).

* ``trace(dir)``: torch.profiler over the enclosed region (CPU and, where
  there is one, CUDA activity), written as a Chrome trace;
* ``device_memory_stats``: the card's allocator statistics in MiB
  (``torch.cuda.memory_stats``), empty without CUDA;
* ``Timer``: a median / percentile wall-clock helper;
* ``estimate_eta``.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: str | Path):
    """Profile the enclosed region: ``with trace(dir): step(...)`` writes
    ``dir/trace.json``."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(str(log_dir / "trace.json"))


def device_memory_stats() -> List[Dict]:
    """Per-card memory use in MiB: in use, peak, reserved and the card's
    total (empty without CUDA)."""
    out = []
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        s = torch.cuda.memory_stats(i)
        out.append({
            "device": torch.cuda.get_device_name(i),
            "bytes_in_use_mb": round(s.get("allocated_bytes.all.current", 0) / 2**20, 1),
            "peak_bytes_mb": round(s.get("allocated_bytes.all.peak", 0) / 2**20, 1),
            "reserved_mb": round(s.get("reserved_bytes.all.current", 0) / 2**20, 1),
            "bytes_limit_mb": round(torch.cuda.get_device_properties(i).total_memory / 2**20, 1),
        })
    return out


class Timer:
    """Wall-clock percentile timer: ``t = Timer(); with t: ...; t.summary()``."""

    def __init__(self):
        self.samples: List[float] = []
        self._t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.samples.append(time.perf_counter() - self._t0)

    def summary(self, skip_first: bool = True) -> Dict[str, float]:
        s = np.asarray(self.samples[1:] if skip_first and len(self.samples) > 1 else self.samples)
        return {
            "n": int(len(s)),
            "mean_ms": float(s.mean() * 1e3),
            "p50_ms": float(np.percentile(s, 50) * 1e3),
            "p95_ms": float(np.percentile(s, 95) * 1e3),
        }


def estimate_eta(done: int, total: int, elapsed_s: float) -> float:
    """Remaining seconds estimate."""
    if done == 0:
        return float("inf")
    return elapsed_s / done * (total - done)
