"""``perfbench/program_trace.py``: its reductions on a hand-made event list,
its readers on records with and without the program's spans, and its
windows against a program with and without the tracer."""

from types import SimpleNamespace

import pytest
import torch

from perfbench import manifest, program_trace as pt
from perfbench import trace
from perfbench.tests import tiny

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


def ev(name, start, end, device=CPU, annotation=False):
    rng = SimpleNamespace(start=float(start), end=float(end), elapsed_us=lambda: end - start)
    return SimpleNamespace(name=name, device_type=device, is_user_annotation=annotation,
                           time_range=rng)


NAMES = {"train.step", "train.forward", "train.match"}
# host (µs): the window 0-100; train.step 0-100 holding train.forward 0-50
# (an aten op 10-20 in it) and train.match 60-80 (a launch 62-64 in it);
# device: kernels 5-15, 30-40, 65-70, 72-75 and train.match's device-side
# range 64-76. Idle gaps: 0-5, 15-30, 40-65, 70-72, 75-100.
EVENTS = [ev(trace.WINDOW, 0, 100, annotation=True), ev("train.step", 0, 100, annotation=True),
          ev("train.forward", 0, 50, annotation=True), ev("aten::add", 10, 20),
          ev("train.match", 60, 80, annotation=True), ev("cudaLaunchKernel", 62, 64),
          ev("k_a", 5, 15, CUDA), ev("k_b", 30, 40, CUDA), ev("k_c", 65, 70, CUDA),
          ev("k_d", 72, 75, CUDA), ev("train.match", 64, 76, CUDA, annotation=True)]


def test_idle_gaps_and_idle_by_span():
    assert pt.idle_gaps(EVENTS) == [(0, 5), (15, 30), (40, 65), (70, 72), (75, 100)]
    got = pt.idle_by_span(EVENTS, NAMES)
    assert sorted(got) == ["train.forward", "train.match"]
    # forward: every gap from 0 to 65 (45 µs), 30 of them with no op open
    assert got["train.forward"] == pytest.approx([45e-6, 30e-6])
    assert got["train.match"] == pytest.approx([27e-6, 27e-6])
    assert pt.idle_by_span(EVENTS, set()) == {}


def test_span_device_time_is_the_union_inside_its_device_range():
    assert pt.span_device_s(EVENTS, NAMES) == pytest.approx({"train.match": 8e-6})
    assert pt.span_device_s([e for e in EVENTS if e.device_type == CPU or
                             not e.is_user_annotation], NAMES) == {}


def test_existing_reduction_sees_no_device_range():
    kept = [e for e in EVENTS if not pt._device_range(e, NAMES)]
    red = trace.reduce(kept, 1e-4, 1)
    assert red["activities"] == 4 and red["busy_s"] == pytest.approx(28e-6)
    assert dict(red["idle_gaps"])["train.match"] == pytest.approx(27e-6)


def _span(name, start_ms, end_ms, parent, root):
    return [name, int(start_ms * 1e6), int(end_ms * 1e6), parent, root]


SERVE = {"kind": "serve_stream", "program_spans": {"counters": {"serve.d2h_copies": 6}, "spans": [
    _span("serve.pre", 0, 1, "serve.frame", 1), _span("serve.launch", 1.1, 1.2, "serve.program", 1),
    _span("serve.program", 1, 1.5, "serve.frame", 1), _span("serve.d2h", 1.5, 7.5, "serve.post", 1),
    _span("serve.post", 1.5, 8, "serve.frame", 1), _span("serve.frame", 0, 8, None, 1),
    _span("serve.pre", 10, 12, "serve.frame", 2), _span("serve.launch", 12, 12.3, "serve.program", 2),
    _span("serve.program", 12, 12.5, "serve.frame", 2), _span("serve.d2h", 12.5, 16.5, "serve.post", 2),
    _span("serve.post", 12.5, 17, "serve.frame", 2), _span("serve.frame", 10, 17, None, 2)]}}
TRAIN = {"kind": "train_steps", "program_spans": {"counters": {}, "spans": [
    _span("train.forward", 0, 80, "train.step", 5), _span("train.match", 81, 83, "train.criterion", 5),
    _span("train.criterion", 80, 100, "train.step", 5), _span("train.backward", 100, 190, "train.step", 5),
    _span("train.optim", 190, 210, "train.step", 5), _span("train.ema", 210, 220, "train.step", 5),
    _span("train.step", 0, 222, None, 5),
    _span("train.forward", 300, 360, "train.step", 6), _span("train.criterion", 360, 390, "train.step", 6),
    _span("train.backward", 390, 500, "train.step", 6), _span("train.optim", 500, 530, "train.step", 6),
    _span("train.step", 300, 531, None, 6)]},
    "profile": {"calls": 2, "idle_by_span": {"train.forward": [0.1, 0.04], "train.ema": [0.01, 0.02],
                                            "serve.pre": [1.0, 1.0]},
                "span_device_s": {"train.match": 0.002}}}
EXPECTED = {"serve.pre_host_ms": 1.5, "serve.launch_ms": 0.2, "serve.d2h_wait_ms": 5.0,
            "serve.post_self_ms": 0.5, "serve.d2h_per_frame": 3.0,
            "train.forward_host_ms": 70.0, "train.criterion_host_ms": 25.0,
            "train.backward_host_ms": 100.0, "train.update_host_ms": 30.0,
            "train.python_idle_ms": 30.0, "train.match_device_ms": 1.0}
# a record of a program without the tracer: the kinds' keys, none of these
PARENT = {"kind": "train_steps", "steps": 3, "profile": {"calls": 3, "busy_s": 0.2,
                                                         "idle_gaps": []}}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_metric_reads_its_spans_and_none_without(name):
    read = pt.METRICS[name]
    rec = SERVE if name.startswith("serve.") else TRAIN
    assert read(rec) == pytest.approx(EXPECTED[name])
    for other in ({}, PARENT, dict(PARENT, program_spans=None),
                  SERVE if rec is TRAIN else TRAIN):
        assert read(other) is None, other


def test_windows_with_and_without_the_tracer(monkeypatch):
    from dfine_tpu_torch.utils import profiling

    def call(n):
        with profiling.span("serve.frame", root=n):
            torch.ones(4).sum()

    win = pt.window(call, 0.05)
    assert win["calls"] == len(win["call_s"]) > 0 and not profiling._on
    assert [s[0] for s in win["spans"]] == ["serve.frame"] * win["calls"]
    assert [s[4] for s in win["spans"]] == list(range(win["calls"]))
    prof = pt.profiled(lambda: call(0), 2)
    assert {"busy_s", "idle_gaps", "kernel_s", "idle_by_span", "span_device_s"} <= set(prof)

    monkeypatch.setattr(pt, "tracer", lambda: None)
    assert pt.window(call, 0.01) is None
    assert set(pt.profiled(lambda: call(0), 1)) == set(prof)


@pytest.mark.parametrize("name,run", [("tiny_serve", pt._serve), ("tiny_train", pt._train)])
def test_measurement_of_a_tiny_cell(tmp_path, name, run):
    cell = manifest.cell(name, tiny.make_root(tmp_path))
    out = pt.summary(run(cell, 2147483655, 0.5, "cpu"))
    assert out["correct"] is True and out["root_ms"] > 0
    kind = "serve." if name == "tiny_serve" else "train."
    # on the CPU: no graph (no serve.launch), no device activity (no device numbers)
    assert set(out["metrics"]) == {k for k in EXPECTED if k.startswith(kind)} - {
        "serve.launch_ms", "train.python_idle_ms", "train.match_device_ms"}
    # eager serving on the CPU computes inside serve.program, which no part covers
    assert (0.0 if name == "tiny_serve" else 0.5) < out["parts_ms"] / out["root_ms"] <= 1.0
