"""The traffic kinds' generators and entry points, and the readers that
divide by the timed window, at tiny sizes on the CPU."""

import json
import types

import numpy as np
import pytest

from perfbench import calibrate, manifest
from perfbench.kinds import serve_stream, train_steps
from perfbench.manifest import ROOT
from perfbench.tests import tiny

COCO_TRAIN2017_MEAN = 860001 / 118287


def test_frames_are_contiguous_hwc_uint8():
    pool = serve_stream.frames(2147483661, 2, (36, 64), "cpu")
    assert pool.dtype == np.uint8 and pool.shape == (2, 36, 64, 3)
    assert pool.flags["C_CONTIGUOUS"] and pool[1].flags["C_CONTIGUOUS"]
    assert np.array_equal(pool, serve_stream.frames(2147483661, 2, (36, 64), "cpu"))


@pytest.mark.parametrize("seed", [2147483662, 4000000001])
def test_ring_holds_the_mix_counts_in_the_seeds_order(seed):
    cfg = tiny.config()
    mix = tiny.TRAIN_MIX
    batches = train_steps.ring(cfg, mix, seed, "cpu")
    counts = [int(n) for b in batches for n in b["targets"]["valid"].sum(1)]
    assert sorted(counts) == sorted(mix["boxes_per_image"])
    for b in batches:
        v = b["targets"]["valid"]
        assert v.shape == (mix["batch"], mix["gt_slots"])
        assert b["targets"]["masks"].flatten(2).amax(2)[~v].sum() == 0


def test_ring_refuses_counts_that_do_not_fit():
    bad = dict(tiny.TRAIN_MIX, boxes_per_image=[1, 2, 3])
    with pytest.raises(ValueError):
        train_steps.ring(tiny.config(), bad, 2147483663, "cpu")


def test_train_mix_counts_follow_coco_train2017():
    mix = manifest.load_json(ROOT / "perfbench" / "traffic" / "train_b8.json")
    counts = mix["boxes_per_image"]
    assert len(counts) == mix["batch"] * mix["ring_batches"]
    assert abs(np.mean(counts) - COCO_TRAIN2017_MEAN) < 0.1
    cam = manifest.load_json(ROOT / "perfbench" / "traffic" / "cam720_closed.json")
    assert cam["keep_per_frame"] == round(COCO_TRAIN2017_MEAN)


def test_chunk_rates():
    issued = [0.5 * i for i in range(1, 50)]
    assert train_steps.chunk_rates(issued, 8, 10.0) == [16.0, 16.0]


@pytest.mark.parametrize("metric,rec", [
    ("serve.idle_share", {"kind": "serve_stream", "frames": 100, "window_s": 2.0,
                          "profile": {"busy_s": 0.15, "calls": 10, "window_s": 0.9}}),
    ("train.idle_share", {"kind": "train_steps", "steps": 20, "window_s": 4.0,
                          "profile": {"busy_s": 0.15, "calls": 3, "window_s": 1.1}}),
])
def test_idle_share_reads_the_timed_window(metric, rec):
    # a call takes 20 ms (serving) or 200 ms (a step) in the timed window;
    # the profiled window's own wall is longer and must not be used
    per_call = rec["window_s"] / rec.get("frames", rec.get("steps"))
    want = 100.0 * (1 - rec["profile"]["busy_s"] / rec["profile"]["calls"] / per_call)
    assert abs(manifest.reader(metric)(rec) - want) < 1e-9


def test_serve_mfu_reads_the_timed_window():
    rec = {"kind": "serve_stream", "frames": 100, "window_s": 1.0, "flops_per_frame": 9.89e10,
           "span_window": {"frames": 1, "window_s": 100.0}}
    assert abs(manifest.reader("serve.mfu")(rec) - 1.0) < 1e-9


@pytest.mark.parametrize("kind", ["serve_stream", "train_steps"])
def test_each_kind_has_a_calibrate_entry_and_its_faults(kind):
    mod = manifest.kind(kind)
    assert callable(mod.calibrate) and mod.FAULTS and callable(mod.run)


def test_calibrate_dispatches_through_the_kind(monkeypatch, capsys):
    seen = {}

    def fake_calibrate(cell, seeds, seconds, faults, device):
        seen.update(cell=cell["name"], faults=faults, seconds=seconds)
        for s in seeds:
            yield s, {"program": {"loss_gap": 0.0}}

    fake = types.SimpleNamespace(FAULTS=("half_batch",), calibrate=fake_calibrate)
    monkeypatch.setattr(manifest, "kind", lambda name: fake)
    assert calibrate.main(["--workload", "m_seg_train_b8", "--seeds", "5,6", "--faults"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["seed"] for x in lines] == [5, 6] and seen["faults"] == ("half_batch",)
    assert seen["cell"] == "m_seg_train_b8"


def test_a_null_limit_is_reported_and_not_compared():
    from perfbench import judge

    ok, check = judge.verdict({"a": 0.5, "b": 9.0}, {"a": 1.0, "b": None})
    assert ok and check["b"] == {"value": 9.0, "limit": None}
    assert not judge.verdict({"a": 0.5, "b": 9.0}, {"a": 1.0})[0]
    assert not judge.verdict({"a": 2.0, "b": 9.0}, {"a": 1.0, "b": None})[0]
