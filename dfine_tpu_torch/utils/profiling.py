"""Profiling and observability (port of ``dfine_tpu/utils/profiling.py``).

* the program's tracer: ``span(name)`` around a phase, ``count(name, n)``
  at an event, switched by ``tracing(on)`` and read by ``drain()`` /
  ``counters()``. Off (the default) a span is one shared no-op object and
  a count returns at once. On, each span records its name, host start and
  end (``time.perf_counter_ns``), its parent span's name and its root's id
  (a serving call's frame number, a train step's ``state.step``) into a
  bounded buffer, with one stack of open spans a thread; while a
  torch.profiler is active it also opens ``record_function(name)``, so the
  span lies on the profiler's clock around the ops and launches it caused;
* ``trace(dir)``: torch.profiler over the enclosed region (CPU and, where
  there is one, CUDA activity) with the tracer on, written as a Chrome
  trace that shows the program's spans above its ops and kernels;
* ``device_memory_stats``: the card's allocator statistics in MiB
  (``torch.cuda.memory_stats``), empty without CUDA.

The spans: ``serve.frame`` (one ``BaseServing.__call__``) holding
``serve.pre``, ``serve.program`` (with ``serve.launch``, a CUDA graph's
replay) and ``serve.post`` (with ``serve.d2h``, the results' copies to
the host, and with the mask head ``serve.masks``, an image's masks
resized to its frame, thresholded and cut to their boxes);
``train.step`` holding ``train.forward``, ``train.criterion`` (with
``train.match``), ``train.backward``, ``train.optim`` and ``train.ema``
on the eager step, and ``train.inputs`` (the CDN draw, the copies into
the graph's inputs, the rates written) and ``train.replay`` on a step
that replays its CUDA graph, where the phase spans run only while a
graph is captured. The counters: ``serve.d2h_copies`` (each result
copied to the host), ``serve.mask_bytes`` (the bytes of the masks copied
to the host), ``serve.mask_h2d`` (the host-made tensors the mask path
copies to the card), ``serve.host_copies`` (each frame the host made
contiguous before its H2D), ``train.graph_captures``,
``train.graph_replays`` and ``train.eager_steps`` (the steps that ran
without a graph).
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
from pathlib import Path
from typing import Any, Dict, Hashable, List, NamedTuple, Optional

import torch

# spans kept between two drains; past it the oldest are dropped and counted
BUFFER = 65536


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    parent: Optional[str]  # the enclosing span's name, None for a root
    root: Any  # the root span's id, shared by every span of its tree


_on = False
_spans: collections.deque = collections.deque(maxlen=BUFFER)
_counts: Dict[str, int] = collections.Counter()
_local = threading.local()
_lock = threading.Lock()  # the buffer and the counters, shared by every thread


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("name", "root", "parent", "start", "rf")

    def __init__(self, name: str, root: Hashable):
        self.name, self.root = name, root

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.parent = stack[-1] if stack else None
        if self.parent is not None:
            self.root = self.parent.root
        stack.append(self)
        self.rf = None
        if torch.autograd._profiler_enabled():
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        _local.stack.pop()
        rec = Span(self.name, self.start, end,
                   self.parent.name if self.parent is not None else None, self.root)
        with _lock:
            if len(_spans) == _spans.maxlen:
                _counts["profiling.spans_dropped"] += 1
            _spans.append(rec)
        return False


def span(name: str, root: Hashable = None):
    """A context manager around one phase of the program. ``root``: the id
    of the tree a span without an enclosing span starts; an enclosed span
    takes its parent's."""
    if not _on:
        return _NO_SPAN
    return _Span(name, root)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while tracing is on."""
    if _on:
        with _lock:
            _counts[name] += n


class tracing:
    """Switch the tracer: ``tracing(True)`` turns it on for the process;
    ``with tracing(True): ...`` for the block, restoring the state before
    it."""

    def __init__(self, on: bool = True):
        global _on
        self.before = _on
        _on = bool(on)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        global _on
        _on = self.before
        return False


def counters() -> Dict[str, int]:
    """The tracer's counters, and each kernel wrapper's launches since its
    last reset as ``launches.<wrapper>``."""
    from ..ops.kernels import launch_counts

    with _lock:
        out = dict(_counts)
    out.update({f"launches.{k}": v for k, v in launch_counts().items()})
    return out


def drain() -> Dict[str, Any]:
    """The spans recorded since the last drain, oldest first, and the
    counters; then clears both (the kernel wrappers' launch counts too)."""
    from ..ops.kernels import reset_launch_counts

    out = counters()
    with _lock:
        spans = list(_spans)
        _spans.clear()
        _counts.clear()
    reset_launch_counts()
    return {"spans": spans, "counters": out}


@contextlib.contextmanager
def trace(log_dir: str | Path):
    """Profile the enclosed region with the tracer on: ``with trace(dir):
    step(...)`` writes ``dir/trace.json``, the program's spans above the
    ops and kernels they caused."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    with tracing(True), profile(activities=acts) as prof:
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
