"""The program's tracer (``dfine_tpu_torch.utils.profiling``): off, spans and
counts record nothing and never open a profiler range; on, a served frame
and a train step give their span trees, the buffer is bounded and cleared
by ``drain``, and under torch.profiler each span encloses the ops it
caused (the spans lie on the profiler's clock)."""

import collections
import logging
import sys
import threading

import numpy as np
import pytest
import torch

from dfine_tpu_torch.utils import profiling

SMALL = (("decoder.num_layers", 1), ("decoder.num_queries", 50), ("decoder.num_denoising", 10))


@pytest.fixture(autouse=True)
def drained():
    profiling.drain()
    yield
    profiling.drain()


@pytest.fixture(scope="module")
def backend():
    from dfine_tpu_torch import AOTModel

    return AOTModel("n", None, 5, 320, 320, conf_thresh=0.0, half=False, device="cpu",
                    max_batch_size=1, cfg_overrides=SMALL)


@pytest.fixture(scope="module")
def train():
    from dfine_tpu_torch.models.dfine import build_model
    from dfine_tpu_torch.train.criterion import CriterionConfig
    from dfine_tpu_torch.train.optim import OptimConfig, build_optimizer
    from dfine_tpu_torch.train.train_step import TrainState, make_train_step

    torch.manual_seed(0)
    model = build_model("n", 5, False, device="cpu", cfg_overrides=SMALL)
    state = TrainState.create(model, build_optimizer(model, OptimConfig()))
    step = make_train_step(CriterionConfig(num_classes=5), compute_dtype=torch.float32)
    batch = {"images": torch.rand(1, 3, 160, 160),
             "targets": {"labels": torch.tensor([[1, 2, 0]]),
                         "boxes": torch.tensor([[[.5, .5, .2, .2], [.3, .3, .1, .2],
                                                 [.5, .5, .1, .1]]]),
                         "valid": torch.tensor([[True, True, False]])}}
    return state, lambda: step(state, batch, generator=torch.Generator().manual_seed(0))


def _frame(hw=(180, 320)):
    return np.random.default_rng(0).integers(0, 255, (*hw, 3), dtype=np.uint8)


def test_off_records_nothing_and_opens_no_range(monkeypatch, backend, train):
    def refuse(*a, **k):
        raise AssertionError("record_function called with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd, "_profiler_enabled", lambda: True)
    assert profiling.span("serve.frame", root=1) is profiling.span("train.step")
    profiling.count("serve.d2h_copies", 3)
    backend(_frame())
    train[1]()
    out = profiling.drain()
    assert out["spans"] == []
    assert not any(k.startswith(("serve.", "train.", "profiling.")) for k in out["counters"])


def test_serving_span_tree_and_counters(backend, caplog, monkeypatch):
    # the package's console logger stops propagation once the trainer has
    # made it (utils/logging.py): caplog reads the records at the root
    monkeypatch.setattr(logging.getLogger("dfine_tpu_torch"), "propagate", True)
    with profiling.tracing(True):
        backend(_frame())
    spans = profiling.drain()
    tree = {s.name: s for s in spans["spans"]}
    assert sorted(tree) == ["serve.d2h", "serve.frame", "serve.post", "serve.pre",
                            "serve.program"]  # eager on the CPU: no graph, no serve.launch
    assert len({s.root for s in tree.values()}) == 1 and tree["serve.frame"].root is not None
    assert tree["serve.frame"].parent is None and tree["serve.d2h"].parent == "serve.post"
    assert {tree[k].parent for k in ("serve.pre", "serve.program", "serve.post")} == {
        "serve.frame"}
    root = tree["serve.frame"]
    assert all(root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns for s in tree.values())
    assert spans["counters"]["serve.d2h_copies"] == 3

    backend._warned_host_copy = False
    strided = np.ascontiguousarray(_frame((180, 640)))[:, ::2]
    with profiling.tracing(True), caplog.at_level(logging.WARNING, "dfine_tpu_torch"):
        backend(strided)
        backend(strided)
    out = profiling.drain()
    assert out["counters"]["serve.host_copies"] == 2
    assert len({s.root for s in out["spans"]}) == 2
    assert sum("not C-contiguous" in r.getMessage() for r in caplog.records) == 1


def test_train_span_tree_on_the_profilers_clock(train):
    from torch.profiler import ProfilerActivity, profile

    state, step = train
    first = state.step
    with profiling.tracing(True), profile(activities=[ProfilerActivity.CPU]) as prof:
        step()
    spans = profiling.drain()["spans"]
    tree = {s.name: s for s in spans}
    assert sorted(tree) == ["train.backward", "train.criterion", "train.ema", "train.forward",
                            "train.match", "train.optim", "train.step"]
    assert {s.root for s in spans} == {first} and state.step == first + 1
    assert tree["train.match"].parent == "train.criterion"
    assert {tree[k].parent for k in tree if k not in ("train.step", "train.match")} == {
        "train.step"}

    events = list(prof.events())
    ranges = {e.name: e for e in events if e.name in tree}
    assert sorted(ranges) == sorted(tree)
    ops = [e for e in events if e.name.startswith("aten::")]
    step_r = ranges["train.step"].time_range
    for name, e in ranges.items():
        r = e.time_range
        assert step_r.start <= r.start and r.end <= step_r.end, name
        inside = [o for o in ops if o.thread == e.thread and r.start <= o.time_range.start
                  and o.time_range.end <= r.end]
        assert inside, f"{name} encloses no aten op"
    conv = [o for o in ops if o.name == "aten::convolution"]
    fwd = ranges["train.forward"].time_range
    assert conv and all(fwd.start <= o.time_range.start <= o.time_range.end <= fwd.end
                        for o in conv)


def test_drain_clears_and_the_buffer_is_bounded(monkeypatch):
    monkeypatch.setattr(profiling, "_spans", collections.deque(maxlen=4))
    with profiling.tracing(True):
        for i in range(10):
            with profiling.span("serve.frame", root=i):
                pass
        profiling.count("serve.d2h_copies", 2)
    assert not profiling._on
    out = profiling.drain()
    assert [s.root for s in out["spans"]] == [6, 7, 8, 9]
    assert out["counters"]["profiling.spans_dropped"] == 6
    assert out["counters"]["serve.d2h_copies"] == 2
    assert "launches.ms_deform_attn_fwd" in out["counters"]
    again = profiling.drain()
    assert again["spans"] == [] and "serve.d2h_copies" not in again["counters"]


def test_threads_lose_no_count_and_keep_their_own_stacks():
    def work(i):
        for _ in range(500):
            with profiling.span("serve.frame", root=i):
                with profiling.span("serve.pre"):
                    profiling.count("serve.d2h_copies")

    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with profiling.tracing(True):
            threads = [threading.Thread(target=work, args=(i,)) for i in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(before)
    out = profiling.drain()
    assert out["counters"]["serve.d2h_copies"] == 16 * 500
    assert len(out["spans"]) == 2 * 16 * 500
    pre = collections.Counter(s.root for s in out["spans"] if s.name == "serve.pre")
    assert pre == {i: 500 for i in range(16)}
    assert {s.parent for s in out["spans"] if s.name == "serve.pre"} == {"serve.frame"}
