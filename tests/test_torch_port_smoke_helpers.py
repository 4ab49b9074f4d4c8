"""Helpers of ``chip_smoke.py`` that run on the host, on the CPU: the
relabel threshold of its apps phase (``keep_threshold``), the score drift
between two backends near it (``threshold_drift``), and the reading of the
backward kernel's ptxas lines (``ptxas_numbers``, ``bwd_build``); and those
of ``chip_deform_bwd_ab.py``: its turn order, means and equality verdict.
Both scripts import only numpy and the standard library at module level, so
they load here."""

import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_deform_bwd_ab  # noqa: E402
import chip_smoke  # noqa: E402

KEEP = chip_smoke.APPS_KEEP


def _brute_force(frames, keep):
    """Every threshold between two consecutive distinct scores, by loops:
    the widest gap among those keeping keep // 2 to keep in the busiest
    frame (the lowest of equal gaps)."""
    distinct = sorted({float(x) for f in frames for x in f})
    best = None
    for lo, hi in zip(distinct, distinct[1:]):
        busiest = max((sum(1 for x in f if x >= hi) for f in frames), default=0)
        if keep // 2 <= busiest <= keep and (best is None or hi - lo > best[1] - best[0]):
            best = (lo, hi)
    return best


def _frames(seed, n=8, per=300):
    """Descending sigmoid scores a frame, as the decode gives them, f32."""
    rng = np.random.default_rng(seed)
    return [np.sort(1 / (1 + np.exp(-rng.normal(-3.0, 1.5, per))))[::-1].astype(np.float32)
            for _ in range(n)]


def _check(frames, keep):
    thr, gap, below, above, straddled = chip_smoke.keep_threshold(frames, keep)
    assert straddled == 0
    assert (below, above) == _brute_force(frames, keep)
    assert gap == pytest.approx(above - below) and below < thr < above
    kept = [int((f >= np.float32(thr)).sum()) for f in frames]  # postprocess's rule, in f32
    assert keep // 2 <= max(kept) <= keep
    every = np.concatenate([np.zeros(0, np.float32), *frames]).astype(np.float64)
    # half the gap away, less the f32 rounding of the middle
    assert np.abs(every - thr).min() >= gap / 2 - float(np.spacing(np.float32(thr)))
    return thr, gap, kept


def test_threshold_sits_in_the_widest_gap_where_the_old_rule_sat_on_a_score():
    """Random score sets: the old rule, max over frames of score[keep] +
    1e-6, sits 1e-6 above a score by construction; the new threshold leaves
    every score at least half the widest admissible gap away."""
    frames = _frames(0)
    for seed in range(1, 6):
        _check(_frames(seed), KEEP)
    old = max(float(f[KEEP]) for f in frames) + 1e-6
    every = np.concatenate(frames).astype(np.float64)
    assert np.abs(every - old).min() < 2e-6
    thr, gap, kept = _check(frames, KEEP)
    assert gap > 100 * 1e-6
    assert np.abs(every - thr).min() > 50 * np.abs(every - old).min()


def test_ties_are_kept_or_dropped_together():
    """Repeated scores count once as a candidate boundary, a tie group is
    never split, and a tie across the whole window leaves no threshold."""
    frames = [np.asarray([0.9, 0.8, 0.8, 0.8, 0.5, 0.5, 0.2, 0.1], np.float32),
              np.asarray([0.85, 0.8, 0.3, 0.3, 0.3], np.float32)]
    thr, gap, kept = _check(frames, 6)
    assert kept == [4, 2] and thr == pytest.approx(0.65) and gap == pytest.approx(0.3)
    for f in frames:  # no tie group straddles the threshold
        for value in np.unique(f):
            assert len({bool(x >= np.float32(thr)) for x in f[f == value]}) == 1
    tied = [np.asarray([0.9] + [0.5] * 30, np.float32)]
    with pytest.raises(ValueError, match="no threshold keeps 10-20"):
        chip_smoke.keep_threshold(tied, KEEP)


def test_a_frame_without_detections():
    """A frame with no score keeps nothing and takes no part in the gaps;
    no frame at all, or no score anywhere, leaves no threshold."""
    rich = _frames(7, n=2)
    thr, _, kept = _check([np.zeros(0, np.float32), *rich], KEEP)
    assert kept[0] == 0
    assert thr == chip_smoke.keep_threshold(rich, KEEP)[0]
    for frames in ([], [np.zeros(0, np.float32)]):
        with pytest.raises(ValueError):
            chip_smoke.keep_threshold(frames, KEEP)


def test_threshold_leaves_every_span_of_two_backends_whole():
    """Spans of a detection's scores in two backends (``paired_spans``):
    the threshold lies in the widest gap that no span straddles, away from
    every score and span end by half of it, even where a wider gap of the
    scores alone lies inside a span; where every admissible gap lies inside
    a span, in the widest of those inside the fewest."""
    frames = [np.asarray([0.9, 0.7, 0.6, 0.5, 0.45, 0.2], np.float32),
              np.asarray([0.8, 0.55, 0.3], np.float32)]
    assert chip_smoke.keep_threshold(frames, 6)[2:4] == pytest.approx((0.3, 0.45))
    box = np.arange(4, dtype=np.float64)
    ref = [(np.stack([box, box + 10]), np.asarray([0.44, 0.71], np.float32))]
    ours = [(np.stack([box + 10.5, box]), np.asarray([0.69, 0.31], np.float32))]
    spans = chip_smoke.paired_spans(ref, ours)
    np.testing.assert_allclose(spans[0], [[0.31, 0.44], [0.69, 0.71]], rtol=1e-6)
    thr, gap, below, above, straddled = chip_smoke.keep_threshold(frames, 6, spans)
    assert straddled == 0 and (below, above) == pytest.approx((0.2, 0.3))
    assert thr == pytest.approx(0.25) and gap == pytest.approx(0.1)
    ends = np.concatenate([*frames, spans[0].ravel()]).astype(np.float64)
    assert np.abs(ends - thr).min() >= gap / 2 - 1e-7
    wide = [np.asarray([[0.0, 1.0]], np.float32), np.asarray([[0.25, 0.65]], np.float32)]
    thr, gap, below, above, straddled = chip_smoke.keep_threshold(frames, 6, wide)
    assert straddled == 1 and (below, above) == pytest.approx((0.0, 0.2))
    alone = chip_smoke.paired_spans([(np.zeros((0, 4)), np.zeros(0))],
                                    [(box[None], np.asarray([0.5], np.float32))])
    np.testing.assert_allclose(alone[0], [[0.5, 0.5]])


def test_threshold_drift_pairs_detections_by_box_near_the_threshold():
    """Two frames served by two backends in another order, and a frame
    without detections: the near detections (within 0.01 of conf 0.25) are
    paired by box, their largest score difference and box distance
    reported, a pair on two sides of conf counted, a near detection that
    ours lacks counted as unpaired, far ones ignored; the margin is ref's
    nearest score to conf."""
    conf, window = 0.25, 0.02
    box = np.arange(4, dtype=np.float64)
    ref = [(np.stack([box, box + 10, box + 20]), np.array([0.30, 0.251, 0.245])),
           (np.stack([box + 30, box + 40]), np.array([0.2545, 0.235])),
           (np.zeros((0, 4)), np.zeros(0))]
    ours = [(np.stack([box + 20.5, box + 10, box]), np.array([0.2446, 0.2495, 0.36])),
            (np.stack([box + 40]), np.array([0.235])),
            (np.zeros((0, 4)), np.zeros(0))]
    got = chip_smoke.threshold_drift(ref, ours, conf, window)
    assert got["near"] == 3 and got["unpaired"] == 1 and got["crossings"] == 1
    assert got["drift"] == pytest.approx(0.0015)
    assert got["box_l1_max"] == pytest.approx(2.0)
    assert got["margin"] == pytest.approx(0.001)
    same = chip_smoke.threshold_drift(ref, ref, conf, window)
    assert same["drift"] == 0.0 and same["crossings"] == same["unpaired"] == 0
    assert same["drift"] < same["margin"]


def test_widened_threshold_takes_the_first_window_with_a_free_gap():
    """Every gap of the first window (6-12 kept in the busiest frame) lies
    inside a span, the second window's (3-12) has one outside them: that
    window and its gap are taken; with the first window free it is taken
    as it is; where no window has a free gap, the window with the fewest
    spans over its threshold, the first of equal ones."""
    scores = [np.asarray([0.95, 0.9, 0.85] + list(np.linspace(0.6, 0.4, 9)) + [0.1] * 4,
                         np.float32)]
    covering = [np.asarray([[0.05, 0.61]], np.float32)]  # over every 6-12 threshold
    windows = ((6, 12), (3, 12), (1, 16))
    with_spans = chip_smoke.keep_threshold(scores, 12, covering, low=6)
    assert with_spans[4] == 1
    (thr, gap, below, above, straddled), window = chip_smoke.widened_threshold(
        scores, covering, windows)
    assert window == (3, 12) and straddled == 0
    assert (below, above) == pytest.approx((0.61, 0.85))
    assert thr == pytest.approx(0.73) and gap == pytest.approx(0.24)
    got, window = chip_smoke.widened_threshold(scores, (), windows)
    assert window == (6, 12) and got == chip_smoke.keep_threshold(scores, 12, low=6)
    everywhere = [np.asarray([[0.0, 1.0]], np.float32)]
    got, window = chip_smoke.widened_threshold(scores, everywhere, windows)
    assert window == (6, 12) and got[4] == 1
    with pytest.raises(ValueError, match="no keep window"):
        chip_smoke.widened_threshold([np.zeros(0, np.float32)], (), windows)


def test_straddling_pairs_and_either_way_answers():
    """``straddling`` keeps, a frame, the box pairs whose two scores lie on
    two sides of conf and their lowest score; ``EitherWay`` serves each
    frame at conf with those detections all kept (served at that lowest
    score) or all dropped, the other detections by their own score, every
    per-detection entry filtered alike."""
    conf = 0.5
    box = np.arange(4, dtype=np.float64)
    eager = [(np.stack([box, box + 10, box + 20]), np.asarray([0.52, 0.7, 0.3], np.float32)),
             (np.stack([box + 30]), np.asarray([0.6], np.float32))]
    pt2 = [(np.stack([box + 20, box + 10, box]), np.asarray([0.31, 0.71, 0.49], np.float32)),
           (np.stack([box + 30]), np.asarray([0.61], np.float32))]
    straddle = chip_smoke.straddling(eager, pt2, conf)
    np.testing.assert_array_equal(straddle[0][0], box[None])
    np.testing.assert_array_equal(straddle[0][1], box[None])
    assert straddle[0][2] == pytest.approx(0.49)
    assert len(straddle[1][0]) == 0 and straddle[1][2] is None

    class Served:  # a backend answering each frame by its conf_thresh
        conf_thresh = 0.0

        def __init__(self, frames):
            self.frames, self.calls, self.i = frames, [], 0

        def __call__(self, img):
            boxes, scores = self.frames[self.i]
            self.i += 1
            self.calls.append(self.conf_thresh)
            keep = scores >= self.conf_thresh
            return [{"boxes": boxes[keep], "scores": scores[keep],
                     "labels": np.arange(len(scores))[keep],
                     "masks": np.ones((len(scores), 2, 2), np.uint8)[keep],
                     "all_scores": scores}]

    for kept in (True, False):
        model = Served(pt2)
        way = chip_smoke.EitherWay(model, straddle, 1, conf, kept)
        first, second = way(None)[0], way(None)[0]
        assert model.calls == ([pytest.approx(0.49), conf] if kept else [conf, conf])
        want = [0.71, 0.49] if kept else [0.71]
        np.testing.assert_allclose(first["scores"], want, rtol=1e-6)
        assert len(first["boxes"]) == len(first["labels"]) == len(first["masks"]) == len(want)
        assert len(first["all_scores"]) == 3
        np.testing.assert_allclose(second["scores"], [0.61], rtol=1e-6)
    model = Served(eager)
    way = chip_smoke.EitherWay(model, straddle, 0, conf, False)
    np.testing.assert_allclose(way(None)[0]["scores"], [0.7], rtol=1e-6)


def test_infer_threshold_picks_the_frames_the_served_backend_keeps_most():
    """``infer_threshold`` takes its threshold from the served scores alone
    (``keep_threshold`` keeping 1 to APPS_KEEP in the busiest frame) and the
    frames with the most detections at it, the first of equal ones; every
    chosen frame count is what the threshold keeps there, and the busiest
    keeps at least one. A frame without detections is allowed; no score at
    all raises."""
    rng = np.random.default_rng(0)
    frames = [rng.uniform(0.2, 0.3, 25).astype(np.float32), np.zeros(0, np.float32),
              rng.uniform(0.2, 0.29, 8).astype(np.float32),
              rng.uniform(0.2, 0.28, 3).astype(np.float32)]
    conf, chosen, dets = chip_smoke.infer_threshold(frames, 3)
    assert conf == chip_smoke.keep_threshold(frames, chip_smoke.APPS_KEEP, low=1)[0]
    at = [int((f >= conf).sum()) for f in frames]
    assert 1 <= max(at) <= chip_smoke.APPS_KEEP and dets[0] == max(at)
    assert dets == [at[i] for i in chosen] and dets == sorted(dets, reverse=True)
    assert len(chosen) == 3 and chosen[0] == 0 and 1 not in chosen[:2]
    tied = [np.asarray([0.5, 0.1], np.float32)] * 3
    assert chip_smoke.infer_threshold(tied, 2)[1:] == ([0, 1], [1, 1])
    with pytest.raises(ValueError):
        chip_smoke.infer_threshold([np.zeros(0, np.float32)] * 2, 2)


def _bwd_ptxas(stack=0, spill=0, registers=48, drop=0):
    """ptxas_by_kernel's value for the backward kernel's 12 instances (the
    last ``drop`` left out), each with these numbers."""
    out = {}
    for tv in ("f", "13__nv_bfloat16"):
        for tp in ("f", "13__nv_bfloat16" if tv == "f" else "S1_"):
            for d in (16, 32, 64):
                name = f"_ZN12_GLOBAL__N_125ms_deform_attn_bwd_kernelI{tv}{tp}Li{d}ELi1EEEvPKT_"
                out[name] = (f"{stack} bytes stack frame, {spill} bytes spill stores, {spill} "
                             f"bytes spill loads; Used {registers} registers, used 0 barriers")
    out["_ZN12_GLOBAL__N_121other_kernelEv"] = "Used 10 registers"
    return dict(list(out.items())[drop:])


def test_ptxas_numbers_reads_registers_stack_and_spills():
    line = ("80 bytes stack frame, 0 bytes spill stores, 4 bytes spill loads; Used 71 "
            "registers, used 0 barriers, 80 bytes cumulative stack size")
    assert chip_smoke.ptxas_numbers(line) == {"registers": 71, "stack_frame_bytes": 80,
                                              "spill_store_bytes": 0, "spill_load_bytes": 4}
    assert chip_smoke.ptxas_numbers("Used 10 registers")["stack_frame_bytes"] is None


def test_bwd_build_wants_every_instance_without_stack_or_spill():
    """Clean: all 12 instances, none with a stack frame or spill; the main
    instance (bf16 value, f32 payload, D = 32) found. A stack frame (the first
    design's level table), a spill, or a missing instance is not clean."""
    got = chip_smoke.bwd_build(_bwd_ptxas())
    assert got["clean"] and got["instances"] == chip_smoke.BWD_INSTANCES == 12
    assert got["main"] == {"registers": 48, "stack_frame_bytes": 0, "spill_store_bytes": 0,
                           "spill_load_bytes": 0}
    assert not chip_smoke.bwd_build(_bwd_ptxas(stack=80))["clean"]
    assert not chip_smoke.bwd_build(_bwd_ptxas(spill=4))["clean"]
    assert not chip_smoke.bwd_build(_bwd_ptxas(drop=1))["clean"]
    assert chip_smoke.bwd_build({})["main"] is None


def test_ab_turns_run_in_the_order_earlier_kernel_kernel_earlier():
    calls = []

    def time_one(who):
        calls.append(who)
        return float(len(calls))

    turns = chip_deform_bwd_ab.in_turns(time_one)
    assert calls == ["earlier", "kernel", "kernel", "earlier"]
    assert turns == {"earlier": [1.0, 4.0], "kernel": [2.0, 3.0]}
    assert chip_deform_bwd_ab.means(turns) == {"earlier": 2.5, "kernel": 2.5}
    assert chip_deform_bwd_ab.means({"a": [0.1, 0.2, 0.6]})["a"] == pytest.approx(0.3)


def test_bwd_verdict_wants_idx_contrib_and_both_gradients():
    """``bwd_equal`` (the smoke's and the A/B script's verdict): idx equal,
    contrib bit-equal and both gradients within GRAD_REL_TOL (the limit
    itself passes); any one of them off is not."""
    tol = chip_smoke.GRAD_REL_TOL
    ok = {"idx_equal": True, "contrib_bit_equal": True, "grad_att_max_rel_err": tol,
          "grad_loc_max_rel_err": 0.0}
    assert chip_smoke.bwd_equal(ok)
    for key, bad in (("idx_equal", False), ("contrib_bit_equal", False),
                     ("grad_att_max_rel_err", 2 * tol), ("grad_loc_max_rel_err", 1.01 * tol),
                     ("grad_att_max_rel_err", float("nan"))):
        assert not chip_smoke.bwd_equal({**ok, key: bad}), key


def test_bwd_compared_reads_gaps_idx_and_contrib_bits():
    """``bwd_compared`` on the plain backward against itself and against a
    copy with one contrib element moved by one bit and one idx changed;
    and on the value-frozen outputs (no streams on either side)."""
    import torch

    from dfine_tpu_torch.ops.kernels.deform_attn import ms_deform_attn_bwd_plain

    value, loc, att, g, shapes, pts = _small_bwd_inputs()
    for payload, bits in ((torch.float32, torch.int32), (torch.bfloat16, torch.int16)):
        ref = ms_deform_attn_bwd_plain(value, shapes, loc, att, g, pts, payload)
        same = chip_smoke.bwd_compared(ref, ref)
        assert same["idx_equal"] and same["contrib_bit_equal"] and same["max_abs_err"] == 0.0
        assert same["entries"] == 4 * 2 * 5 * 8 * 5
        contrib = [c.clone() for c in ref[3]]
        contrib[1].view(bits).view(-1)[3] += 1
        idx = [i.clone() for i in ref[2]]
        idx[0].view(-1)[0] = -7
        grad_att = ref[0] * (1 + 1e-3)
        moved = chip_smoke.bwd_compared((grad_att, ref[1], idx, contrib), ref)
        assert not moved["idx_equal"] and not moved["contrib_bit_equal"]
        assert moved["grad_att_max_rel_err"] == pytest.approx(1e-3, rel=1e-2)
        assert not chip_smoke.bwd_equal(moved)
    frozen = ms_deform_attn_bwd_plain(value, shapes, loc, att, g, pts, need_value=False)
    assert chip_smoke.bwd_equal(chip_smoke.bwd_compared(frozen, frozen))
    assert not chip_smoke.bwd_compared(ref, frozen)["idx_equal"]


def _small_bwd_inputs():
    """value [2, 20, 8, 32], loc, att, g_out over levels (4, 4), (2, 2) with
    points (3, 2), 5 queries, from a seed."""
    import torch

    b, q, h, d = 2, 5, 8, 32
    rng = np.random.default_rng(0)
    value = torch.from_numpy(rng.normal(size=(b, 20, h, d)).astype(np.float32))
    loc = torch.from_numpy(rng.uniform(0, 1, (b, q, h, 5, 2)).astype(np.float32))
    att = torch.from_numpy(rng.uniform(0, 1, (b, q, h, 5)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(b, q, h * d)).astype(np.float32))
    return value, loc, att, g, ((4, 4), (2, 2)), (3, 2)


def test_ab_output_bytes_counts_every_output_once():
    """The two gradients and each level's idx and contrib views (one
    allocation each) of the plain backward on a small case."""
    import torch

    from dfine_tpu_torch.ops.kernels.deform_attn import ms_deform_attn_bwd_plain

    value, loc, att, g, shapes, pts = _small_bwd_inputs()
    points = 2 * 5 * 8 * 5
    for payload, size in ((torch.float32, 4), (torch.bfloat16, 2)):
        out = ms_deform_attn_bwd_plain(value, shapes, loc, att, g, pts, payload)
        assert chip_deform_bwd_ab.output_bytes(out) == (points * 3 * 4 + 4 * points * 4
                                                        + 4 * points * 32 * size)
