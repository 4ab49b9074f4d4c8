"""Hand-written CUDA kernels (sources in ``dfine_tpu_torch/csrc``), each
beside its plain PyTorch version and with a launch counter on its wrapper."""

from .deform_attn import ms_deform_attn_fwd, ms_deform_attn_fwd_plain  # noqa: F401
from .scatter_rows import (rows_scatter_add, rows_scatter_add_bf16_plain,  # noqa: F401
                           rows_scatter_add_mxu, rows_scatter_add_plain, rows_scatter_add_tiled)

WRAPPERS = (ms_deform_attn_fwd, rows_scatter_add, rows_scatter_add_mxu, rows_scatter_add_tiled)


def reset_launch_counts() -> None:
    for fn in WRAPPERS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in WRAPPERS}
