"""The profiled window of a ``--trace 1`` run, reduced: the device's busy
time (the union of its activities), the window's length, the activities,
each kernel's device time, the device operations that took most time, and
the idle gaps by what the host was doing then (the innermost host op open
at the gap's start). The arithmetic of ``chip_smoke.py::profile_window``,
on the trace's own intervals."""

from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict
from typing import Any, Callable, Dict, List

import torch

WINDOW = "perfbench.window"
TOP = 10


def _is_device(e) -> bool:
    return (e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False))


def profiled(fn: Callable[[], Any], n: int) -> Dict[str, Any]:
    """``n`` calls of ``fn`` under torch.profiler, then its reduction."""
    from torch.profiler import ProfilerActivity, profile, record_function

    card = torch.cuda.is_available()
    sync = torch.cuda.synchronize if card else (lambda: None)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if card else [])
    sync()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        with record_function(WINDOW):
            for _ in range(n):
                fn()
            sync()
        wall = time.perf_counter() - t0
    return reduce(prof.events(), wall, n)


def reduce(events, wall_s: float, calls: int) -> Dict[str, Any]:
    win = [e for e in events if e.name == WINDOW and not _is_device(e)]
    lo, hi = (win[0].time_range.start, win[0].time_range.end) if win else (None, None)
    dev = sorted((e for e in events if _is_device(e)), key=lambda e: e.time_range.start)
    by_name: Dict[str, float] = defaultdict(float)
    merged: List[List[float]] = []
    for e in dev:
        s, t = e.time_range.start, e.time_range.end
        by_name[e.name] += (t - s) * 1e-6
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    busy = sum(t - s for s, t in merged) * 1e-6
    lo = merged[0][0] if lo is None and merged else lo
    hi = merged[-1][1] if hi is None and merged else hi
    gaps, prev = [], lo
    for s, t in merged:
        if prev is not None and s > prev:
            gaps.append((prev, s))
        prev = max(prev, t) if prev is not None else t
    if merged and hi is not None and hi > prev:
        gaps.append((prev, hi))
    host = sorted((e for e in events if not _is_device(e) and e.name != WINDOW),
                  key=lambda e: e.time_range.start)
    starts = [e.time_range.start for e in host]
    idle: Dict[str, float] = defaultdict(float)
    for s, t in sorted(gaps, key=lambda g: g[0] - g[1])[:2000]:
        idle[_host_at(host, starts, s)] += (t - s) * 1e-6
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {"busy_s": busy, "window_s": wall_s, "calls": calls, "activities": len(dev),
            "kernel_s": dict(by_name), "device_ops": [[k, v] for k, v in top_ops],
            "idle_gaps": [[k, v] for k, v in sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]]}


def _host_at(host, starts, t) -> str:
    """The innermost host op open at time ``t``: the shortest one that
    started before it and ends after it."""
    best = None
    for e in reversed(host[:bisect.bisect_right(starts, t)][-400:]):
        if e.time_range.end >= t and (best is None or e.time_range.elapsed_us()
                                      < best.time_range.elapsed_us()):
            best = e
    return best.name if best is not None else "host, outside any op"


@contextlib.contextmanager
def span(spans: Dict[str, List[float]], name: str):
    """A harness span around a call into the program, closed by a
    synchronize: its seconds appended to ``spans[name]``."""
    t0 = time.perf_counter()
    yield
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    spans.setdefault(name, []).append(time.perf_counter() - t0)
