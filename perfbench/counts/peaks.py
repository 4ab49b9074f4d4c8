"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the full 700 W power limit; a card set below it reads lower shares)."""

BF16_FLOPS_PER_S = 989e12  # tensor cores, bf16 / fp16, dense
FP32_FLOPS_PER_S = 67e12  # outside the tensor cores
HBM_BYTES_PER_S = 3.35e12


def least_seconds(nbytes: float, flops: float, flops_per_s: float = FP32_FLOPS_PER_S):
    """The least time the card can take for the work: the larger of its
    bytes over the memory bandwidth and its operations over the peak."""
    return max(nbytes / HBM_BYTES_PER_S, flops / flops_per_s)
