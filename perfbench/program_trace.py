"""The program's own spans and counters (``dfine_tpu_torch.utils.profiling``)
in a traced run, and the per-layer numbers read from them.

- ``window(call, seconds)``: the program-span window. ``call(n)`` (a frame
  served, a step issued) in a loop for ``seconds`` with the program's
  tracing on, no profiler and no synchronize of the harness's between the
  calls (one at the end); the tracer's ``drain()`` gives its spans and
  counters. A program without the tracer gives None: the window is
  skipped.
- ``profiled(fn, n)``: ``trace.profiled``'s window with the program's
  tracing on, so that each span is a ``record_function`` range on the
  profiler's clock. Its record holds every key of ``trace.reduce``,
  computed by that function, and two more on the same events:
  ``idle_by_span``, {span: [device-idle seconds while it is the innermost
  open program span, of which those while it is the innermost open host
  event at all, no op or runtime call open]}, and ``span_device_s``, {span:
  the union of device activities inside the span's device-side ranges
  (the profiler's ``gpu_user_annotation`` of its name)}.
- ``METRICS``: {metric name: ``read(record)``}, each None where the record
  has nothing to read (no ``program_spans`` key, or not the span).

The kinds of ``kinds/`` do not call it yet. ``python3 -m
perfbench.program_trace --workload <cell> --seed <n> --seconds <s>`` runs a
cell's set-up, its timed window (tracing off), the program-span window and
the profiled window with tracing on, the comparison with the reference,
and prints one JSON line: the numbers of ``METRICS``, the cost of tracing
(the span window's p50 frame time or img/s beside the timed window's), the
sum of each tree's parts beside its root, and the breakdowns.
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import heapq
import json
import sys
import time
from collections import defaultdict
from typing import Any, Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

from . import trace


def tracer():
    """The program's tracer module, or None for a program without one."""
    try:
        from dfine_tpu_torch.utils import profiling
    except ImportError:
        return None
    return profiling if hasattr(profiling, "drain") and hasattr(profiling, "tracing") else None


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def window(call: Callable[[int], Any], seconds: float) -> Optional[Dict[str, Any]]:
    """``call(n)`` for n = 0, 1, ... for ``seconds`` with the program's
    tracing on, then one synchronize: {"spans": [[name, start_ns, end_ns,
    parent, root], ...], "counters", "calls", "window_s", "call_s" (each
    call's host seconds)}. None without the tracer."""
    prof = tracer()
    if prof is None:
        return None
    prof.drain()
    took, n = [], 0
    with prof.tracing(True):
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            t = time.perf_counter()
            call(n)
            took.append(time.perf_counter() - t)
            n += 1
        _sync()
        wall = time.perf_counter() - t0
    out = prof.drain()
    return {"spans": [list(s) for s in out["spans"]], "counters": out["counters"], "calls": n,
            "window_s": wall, "call_s": took}


def profiled(fn: Callable[[], Any], n: int) -> Dict[str, Any]:
    """``n`` calls of ``fn`` under torch.profiler with the program's tracing
    on (off where the program has no tracer), reduced by ``trace.reduce``
    plus ``idle_by_span`` and ``span_device_s``."""
    from torch.profiler import ProfilerActivity, profile, record_function

    prof_mod = tracer()
    card = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if card else [])
    if prof_mod is not None:
        prof_mod.drain()
    _sync()
    with (prof_mod.tracing(True) if prof_mod is not None else contextlib.nullcontext()):
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            with record_function(trace.WINDOW):
                for _ in range(n):
                    fn()
                _sync()
            wall = time.perf_counter() - t0
    names = set()
    if prof_mod is not None:
        names = {s.name for s in prof_mod.drain()["spans"]}
    events = list(prof.events())
    # the device-side ranges of the program's spans are not host ops
    rec = trace.reduce([e for e in events if not _device_range(e, names)], wall, n)
    rec["idle_by_span"] = idle_by_span(events, names)
    rec["span_device_s"] = span_device_s(events, names)
    return rec


def _device_range(e, names) -> bool:
    return e.name in names and e.device_type == torch.autograd.DeviceType.CUDA


def _on_cpu(e) -> bool:
    return e.device_type == torch.autograd.DeviceType.CPU


def _host(e) -> bool:
    return _on_cpu(e) and e.name != trace.WINDOW


def _merged(intervals: Iterable) -> List[List[float]]:
    out: List[List[float]] = []
    for s, t in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return out


def idle_gaps(events) -> List[tuple]:
    """Every device-idle gap (start, end) in µs of the profiled window, as
    ``trace.reduce`` finds them: between the unions of device activities,
    from the window's host-side start to the first and from the last to
    its end."""
    win = [e for e in events if e.name == trace.WINDOW and _on_cpu(e)]
    merged = _merged((e.time_range.start, e.time_range.end) for e in events
                     if trace._is_device(e))
    if not merged:
        return []
    lo, hi = ((win[0].time_range.start, win[0].time_range.end) if win
              else (merged[0][0], merged[-1][1]))
    gaps, prev = [], lo
    for s, t in merged:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, t)
    if hi > prev:
        gaps.append((prev, hi))
    return gaps


def _innermost(host, times) -> List[Any]:
    """For each time of ``times`` (ascending), the shortest event of
    ``host`` open at it (started at or before, ending at or after), or
    None."""
    host = sorted(host, key=lambda e: e.time_range.start)
    heap: List[tuple] = []
    out, i = [], 0
    for t in times:
        while i < len(host) and host[i].time_range.start <= t:
            e = host[i]
            heapq.heappush(heap, (e.time_range.end - e.time_range.start, i, e))
            i += 1
        while heap and heap[0][2].time_range.end < t:
            heapq.heappop(heap)
        out.append(heap[0][2] if heap else None)
    return out


def idle_by_span(events, names) -> Dict[str, List[float]]:
    """{span: [idle s under it, idle s with nothing open inside it]}: each
    device-idle gap put down to the innermost program span open on the
    host at its start, and, where that span is the innermost host event of
    all, also to the second number."""
    gaps = sorted(idle_gaps(events))
    if not gaps or not names:
        return {}
    starts = [s for s, _ in gaps]
    host = [e for e in events if _host(e)]
    spans = _innermost([e for e in host if e.name in names], starts)
    inner = _innermost(host, starts)
    out: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0.0])
    for (s, t), sp, e in zip(gaps, spans, inner):
        if sp is None:
            continue
        out[sp.name][0] += (t - s) * 1e-6
        if e is sp:
            out[sp.name][1] += (t - s) * 1e-6
    return dict(out)


def span_device_s(events, names) -> Dict[str, float]:
    """{span: seconds of the union of device activities inside the span's
    device-side ranges}."""
    ranges = defaultdict(list)
    for e in events:
        if _device_range(e, names):
            ranges[e.name].append((e.time_range.start, e.time_range.end))
    if not ranges:
        return {}
    merged = _merged((e.time_range.start, e.time_range.end) for e in events
                     if trace._is_device(e))
    starts = [s for s, _ in merged]
    out = {}
    for name, rs in ranges.items():
        total = 0.0
        for lo, hi in _merged(rs):
            j = max(bisect.bisect_right(starts, lo) - 1, 0)
            while j < len(merged) and merged[j][0] < hi:
                total += max(0.0, min(hi, merged[j][1]) - max(lo, merged[j][0]))
                j += 1
        out[name] = total * 1e-6
    return out


# the numbers read from a record


def per_root_ms(rec, names, minus=()) -> Optional[List[float]]:
    """Each tree's (root id's) summed ms of the spans named ``names`` less
    those named ``minus``, over the trees holding one of ``names``; None
    where the record has no program spans or none of these."""
    win = rec.get("program_spans")
    if not win:
        return None
    tot: Dict[Any, float] = defaultdict(float)
    seen = set()
    for name, s, t, _, root in win["spans"]:
        if name in names:
            tot[root] += (t - s) * 1e-6
            seen.add(root)
        elif name in minus:
            tot[root] -= (t - s) * 1e-6
    return [tot[r] for r in seen] or None


def median_ms(rec, names, minus=()) -> Optional[float]:
    v = per_root_ms(rec, names, minus)
    return float(np.median(v)) if v else None


def _d2h_per_frame(rec):
    frames = per_root_ms(rec, ("serve.frame",))
    if not frames:
        return None
    return rec["program_spans"]["counters"].get("serve.d2h_copies", 0) / len(frames)


def _match_device_ms(rec):
    prof = rec.get("profile") or {}
    val = prof.get("span_device_s", {}).get("train.match")
    if val is None or not prof.get("calls"):
        return None
    return val / prof["calls"] * 1e3


def _python_idle_ms(rec):
    prof = rec.get("profile") or {}
    idle = {k: v for k, v in prof.get("idle_by_span", {}).items() if k.startswith("train.")}
    if not idle or not prof.get("calls"):
        return None
    return sum(v[1] for v in idle.values()) / prof["calls"] * 1e3


METRICS: Dict[str, Callable[[Dict[str, Any]], Optional[float]]] = {
    "serve.pre_host_ms": lambda r: median_ms(r, ("serve.pre",)),
    "serve.launch_ms": lambda r: median_ms(r, ("serve.launch",)),
    "serve.d2h_wait_ms": lambda r: median_ms(r, ("serve.d2h",)),
    "serve.post_self_ms": lambda r: median_ms(r, ("serve.post",), minus=("serve.d2h",)),
    "serve.d2h_per_frame": _d2h_per_frame,
    "train.forward_host_ms": lambda r: median_ms(r, ("train.forward",)),
    "train.criterion_host_ms": lambda r: median_ms(r, ("train.criterion",)),
    "train.backward_host_ms": lambda r: median_ms(r, ("train.backward",)),
    "train.update_host_ms": lambda r: median_ms(r, ("train.optim", "train.ema")),
    "train.python_idle_ms": _python_idle_ms,
    "train.match_device_ms": _match_device_ms,
}


# the measurement of one cell (on the card)


def _serve(cell, seed, seconds, device):
    from .kinds import serve_stream as k
    from . import judge, weights

    mix = cell["mix"]
    st = k.setup(cell, seed, device)
    backend, pool, thr = st["backend"], st["pool"], st["thresholds"]
    rng = np.random.default_rng(seed % weights.SEED_MOD)
    timed = k.window(backend, pool, thr, seconds, rng, mix["sample_frames"])
    rec = {"kind": "serve_stream",
           "timed": {"frames": timed["frames"], "window_s": timed["window_s"],
                     "p50_ms": float(np.median(timed["latency_s"])) * 1e3}}
    rec["program_spans"] = window(lambda n: k.serve(backend, pool, thr, n), seconds)
    if rec["program_spans"]:
        rec["traced"] = {"frames": rec["program_spans"]["calls"],
                         "p50_ms": float(np.median(rec["program_spans"]["call_s"])) * 1e3}
    distinct = mix["profile_distinct"]
    it = iter(range(10**9))
    rec["profile"] = profiled(lambda: k.serve(backend, pool[:distinct], thr, next(it)),
                              mix["profile_frames"])
    rec["numbers"] = k.compared(cell, st.pop("state"), pool, thr, timed["sample"], device)
    rec["correct"] = bool(judge.verdict(rec["numbers"], cell["limits"])[0]
                          and timed["malformed"] == 0)
    return rec


def _train(cell, seed, seconds, device):
    from .kinds import train_steps as k
    from . import judge

    mix = cell["mix"]
    st = k.setup(cell, seed, device)
    state, step, batches = st["state"], st["step"], st["batches"]
    first = mix["checked_steps"] + mix["warmup_steps"]
    timed = k.window(state, step, batches, seconds, device, first)
    rec = {"kind": "train_steps",
           "timed": {"steps": timed["steps"], "window_s": timed["window_s"],
                     "img_per_s": timed["steps"] * mix["batch"] / timed["window_s"]}}
    nxt = first + timed["steps"]
    rec["program_spans"] = window(
        lambda n: k.call(step, state, batches[(nxt + n) % len(batches)]), seconds)
    if rec["program_spans"]:
        w = rec["program_spans"]
        rec["traced"] = {"steps": w["calls"], "img_per_s": w["calls"] * mix["batch"]
                         / w["window_s"]}
        nxt += w["calls"]
    it = iter(range(10**9))
    rec["profile"] = profiled(
        lambda: k.call(step, state, batches[(nxt + next(it)) % len(batches)]),
        mix["profile_steps"])
    ours = st["ours"]
    del state, step, st
    rec["numbers"] = judge.train_numbers(ours, k.reference_readings(cell, seed, batches, device))
    rec["correct"] = bool(judge.verdict(rec["numbers"], cell["limits"])[0]
                          and timed["failed"] == 0)
    return rec


ROOTS = {"serve_stream": ("serve.frame", ("serve.pre_host_ms", "serve.launch_ms",
                                          "serve.d2h_wait_ms", "serve.post_self_ms")),
         "train_steps": ("train.step", ("train.forward_host_ms", "train.criterion_host_ms",
                                        "train.backward_host_ms", "train.update_host_ms"))}


def summary(rec) -> Dict[str, Any]:
    """The record's numbers: ``METRICS`` that read something, the median
    root span beside the sum of its parts' metrics, and the breakdowns."""
    out = {"metrics": {k: v for k, f in METRICS.items() if (v := f(rec)) is not None}}
    root, parts = ROOTS[rec["kind"]]
    out["root_ms"] = median_ms(rec, (root,))
    out["parts_ms"] = sum(out["metrics"].get(p) or 0.0 for p in parts)
    for k in ("timed", "traced", "correct", "numbers"):
        out[k] = rec.get(k)
    prof = rec["profile"]
    out["profile"] = {k: prof[k] for k in ("busy_s", "window_s", "calls", "activities",
                                           "idle_gaps", "idle_by_span", "span_device_s")}
    if rec.get("program_spans"):
        out["counters"] = rec["program_spans"]["counters"]
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="the program's spans and counters in one cell")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    from . import manifest

    if not torch.cuda.is_available():
        raise SystemExit("perfbench.program_trace: no CUDA card")
    cell = manifest.cell(args.workload)
    run = {"serve_stream": _serve, "train_steps": _train}[cell["mix"]["kind"]]
    rec = run(cell, args.seed, args.seconds, "cuda")
    out = {"workload": args.workload, "seed": args.seed, "device": torch.cuda.get_device_name(0),
           **summary(rec)}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
