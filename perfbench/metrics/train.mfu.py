"""Operations of a forward and backward of a batch (the reference's count)
over the window's step time (wall over steps) times the bf16 peak, in %."""

from perfbench.counts.peaks import BF16_FLOPS_PER_S


def read(rec):
    if rec.get("kind") != "train_steps" or not rec["steps"] or "flops_per_step" not in rec:
        return None
    return 100.0 * rec["flops_per_step"] / (rec["window_s"] / rec["steps"] * BF16_FLOPS_PER_S)
