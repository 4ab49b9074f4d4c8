"""Helpers of ``chip_smoke.py`` that run on the host, on the CPU: the
relabel threshold of its apps phase (``keep_threshold``) and the score
drift between two backends near it (``threshold_drift``). The script
imports only numpy and the standard library at module level, so it loads
here."""

import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

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
