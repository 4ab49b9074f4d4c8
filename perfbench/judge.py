"""What decides ``correct``: the numbers that compare what the timed path
produced with the plain reference, each held to its limit.

With random weights the model's discrete choices (the encoder's top-k of
8400 anchors, the matching of queries to targets) sit on near-ties, so
bf16 rounding flips a few of them in every sound run and moves the answers
that hang on them far: the worst detection or the worst leaf reads the
same for a sound run, the fp8 control and a broken program. The numbers are
therefore shares and medians, which a few flipped choices leave alone and
a lower precision or a fault moves.

Serving (a sample of the window's frames): each served detection is
matched to the reference query whose box lies nearest (L1, in the frame's
pixels). ``unmatched_share``: the share of served detections with no
reference query within MATCH_PX in every coordinate; ``box_gap_median_px``
the median of the coordinate gap to the nearest query; ``score_gap_median``
the median gap between a served score and the reference's score of that
query and the served class, over the matched detections;
``mask_gap_median`` the median, over the served detections, of the share
of the pixels of the served mask and the nearest query's sure inside (its
probability 0.05 or more above the frame's threshold, in its box) on which
the served mask contradicts the reference (set where the reference is
sure outside, unset where it is sure inside); pixels within 0.05 of the
threshold are rounding's and do not count, nor does a detection with
nothing inside on either side. A frame answered with nothing reads
as all unmatched.

Training (the first three steps): ``loss_gap`` the largest relative gap
of a step's total loss; ``grad_gap_median`` and ``grad_gap_q90`` the median
and the 90th percentile over the leaves of the gap between the norms of
the first clipped gradient (the optimizer's first moment over 1 - beta1)
of the program and of the reference, over the larger of the reference's
norm of that leaf and of the median leaf; ``change_gap_median`` and
``ema_gap_median`` the median of the same gap of each parameter's change,
and of its EMA copy's, after step 3, over the leaves whose reference
gradient is at least a thousandth of the median leaf's (the rest move
under AdamW by round-off alone). A leaf that one side has and the other
has not reads 1.
"""

from __future__ import annotations

import math
import sys
from typing import Dict, List

import numpy as np

NOUGHT_SHARE = 1e-3
MATCH_PX = 4.0


def serve_numbers(served: List[dict], refs: List[dict]) -> Dict[str, float]:
    """``served``: the program's result dicts of the sampled frames;
    ``refs``: the reference's view of the same frames (``scores`` [Q, C],
    ``boxes`` [Q, 4] xyxy pixels, ``mask(qs)`` -> (sure inside, sure
    outside) [len(qs), H, W] at the frame's size)."""
    box, score, mask, empty = [], [], [], 0
    seg = any("masks" in o for o in served)
    for ans, ref in zip(served, refs):
        rb, rs = ref["boxes"], ref["scores"]
        b, s, lab = ans["boxes"], ans["scores"], ans["labels"].astype(np.int64)
        if len(s):
            near = np.abs(b[:, None, :] - rb[None, :, :]).sum(-1).argmin(1)
            gap = np.abs(b - rb[near]).max(-1)
            hit = gap <= MATCH_PX
            box += list(gap)
            score += list(np.abs(s - rs[near, lab])[hit])
            if seg:
                pos, neg = ref["mask"](near)
                ours = ans["masks"].astype(bool)
                bad = ((ours & neg) | (~ours & pos)).reshape(len(s), -1).sum(1)
                union = ((ours & (pos | neg)) | pos).reshape(len(s), -1).sum(1)
                mask += list(bad[union > 0] / union[union > 0])
        else:
            empty += 1
    box = np.asarray(box)
    unmatched = float(((box > MATCH_PX).sum() + empty) / max(len(box) + empty, 1))
    out = {"unmatched_share": unmatched if len(box) else 1.0,
           "box_gap_median_px": float(np.median(box)) if len(box) else math.inf,
           "score_gap_median": float(np.median(score)) if score else math.inf}
    if seg:
        out["mask_gap_median"] = float(np.median(mask)) if mask else 0.0
    return out


def _leaf_gaps(ours: Dict[str, float], theirs: Dict[str, float], keys) -> np.ndarray:
    keys = list(keys)
    if not keys:
        return np.zeros(1)
    med = float(np.median([theirs[k] for k in keys]))
    return np.asarray([abs(ours[k] - theirs[k]) / max(theirs[k], med, 1e-30) if k in ours
                       else 1.0 for k in keys])


def train_numbers(ours: dict, theirs: dict) -> Dict[str, float]:
    """``ours`` / ``theirs``: {"losses": [floats], "grad": {leaf: norm},
    "change": {leaf: norm}, "ema": {leaf: norm}} of the program and the
    reference."""
    loss = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(ours["losses"], theirs["losses"]))
    if not all(math.isfinite(a) for a in ours["losses"]):
        loss = math.inf
    g_ref = theirs["grad"]
    keys = sorted(set(g_ref) | set(ours["grad"]))
    grad = _leaf_gaps(ours["grad"], {k: g_ref.get(k, 0.0) for k in keys}, keys)
    grad[[k not in g_ref for k in keys]] = 1.0
    med = float(np.median(list(g_ref.values()))) if g_ref else 0.0
    live = [k for k, v in g_ref.items() if v >= NOUGHT_SHARE * med]
    return {"loss_gap": loss,
            "grad_gap_median": float(np.median(grad)),
            "grad_gap_q90": float(np.quantile(grad, 0.9)),
            "change_gap_median": float(np.median(_leaf_gaps(ours["change"], theirs["change"],
                                                            live))),
            "ema_gap_median": float(np.median(_leaf_gaps(ours["ema"], theirs["ema"], live)))}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]):
    """(correct, {name: {"value", "limit"}}): every number within its limit.
    A number whose limit is null in the cell's limits is reported and not
    compared (it has no upper reading: ``PERF.md`` names it with its
    readings); a number absent from them fails, as its limit is missing."""
    check = {k: {"value": v, "limit": limits.get(k)} for k, v in numbers.items()}
    ok = all(k in limits and (c["limit"] is None or (math.isfinite(c["value"])
                                                     and c["value"] <= c["limit"]))
             for k, c in check.items())
    return ok, check


def print_check(check: Dict[str, dict]) -> None:
    """Each number compared beside its limit, as the last lines on stderr."""
    for k, c in check.items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr, flush=True)
