"""Operations of a frame's forward (the reference's count) over the frame
time of the timed window (its wall over its frames) times the bf16 peak,
in %."""

from perfbench.counts.peaks import BF16_FLOPS_PER_S


def read(rec):
    if rec.get("kind") != "serve_stream" or not rec["frames"] or "flops_per_frame" not in rec:
        return None
    return 100.0 * rec["flops_per_frame"] / (rec["window_s"] / rec["frames"] * BF16_FLOPS_PER_S)
