"""Hand-written CUDA kernels (sources in ``dfine_tpu_torch/csrc``), each
beside its plain PyTorch version and with a launch counter on its wrapper."""

from .deform_attn import (HEAD_DIMS, MAX_LEVELS, MAX_POINTS, ms_deform_attn_fwd,  # noqa: F401
                          ms_deform_attn_fwd_plain, ms_deform_attn_op)
from .scatter_rows import (TILE_WIDTHS, rows_scatter_add, rows_scatter_add_bf16_plain,  # noqa: F401
                           rows_scatter_add_mxu, rows_scatter_add_plain, rows_scatter_add_tiled)

WRAPPERS = (ms_deform_attn_fwd, rows_scatter_add, rows_scatter_add_mxu, rows_scatter_add_tiled)


def reset_launch_counts() -> None:
    for fn in WRAPPERS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in WRAPPERS}


def check_kernel_limits(model) -> None:
    """Raise if a built ``DFINE`` has a shape the kernels refuse: its head
    dim (``decoder.hidden_dim // encoder.nhead``) outside what the sampling
    kernel and the value-gradient scatters take, more than ``MAX_POINTS``
    sampling points over the levels (``decoder.num_points``), or more than
    ``MAX_LEVELS`` levels (``decoder.num_levels``). Called where a model
    reaches a CUDA device, so that such a model fails there and not at its
    first forward."""
    dec = model.decoder
    d = dec.hidden_dim // dec.nhead
    points = dec.decoder.layers[0].cross_attn.num_points_list
    levels = len(dec.input_proj)
    if d not in HEAD_DIMS or d not in TILE_WIDTHS:
        raise ValueError(f"head dim decoder.hidden_dim // encoder.nhead = {d}: the CUDA kernels "
                         f"take {sorted(set(HEAD_DIMS) & set(TILE_WIDTHS))}")
    if sum(points) > MAX_POINTS:
        raise ValueError(f"decoder.num_points {list(points)} sum to {sum(points)}: the sampling "
                         f"kernel takes at most {MAX_POINTS}")
    if levels > MAX_LEVELS:
        raise ValueError(f"decoder.num_levels = {levels}: the sampling kernel takes at most "
                         f"{MAX_LEVELS}")
