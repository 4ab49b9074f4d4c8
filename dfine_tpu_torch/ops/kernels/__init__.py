"""Hand-written CUDA kernels (sources in ``dfine_tpu_torch/csrc``), each
beside its plain PyTorch version and with a launch counter on its wrapper.
``WRAPPERS`` are those whose launches a step or a frame makes a fixed
number of (``launch_counts``); ``batch_norm_train`` launches four times a
BatchNorm of the model and keeps its own count."""

from .batch_norm import batch_norm_train  # noqa: F401
from .deform_attn import (HEAD_DIMS, MAX_LEVELS, MAX_POINTS, ms_deform_attn_bwd,  # noqa: F401
                          ms_deform_attn_bwd_plain, ms_deform_attn_fwd, ms_deform_attn_fwd_plain,
                          ms_deform_attn_op)
from .hungarian import MAX_Q, hungarian_lap  # noqa: F401
from .scatter_rows import (TILE_WIDTHS, rows_scatter_add, rows_scatter_add_bf16_plain,  # noqa: F401
                           rows_scatter_add_mxu, rows_scatter_add_plain, rows_scatter_add_tiled)

WRAPPERS = (ms_deform_attn_fwd, ms_deform_attn_bwd, rows_scatter_add, rows_scatter_add_mxu,
            rows_scatter_add_tiled, hungarian_lap)


def reset_launch_counts() -> None:
    for fn in WRAPPERS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in WRAPPERS}


def check_kernel_limits(model) -> None:
    """Raise if a built ``DFINE`` has a shape the kernels refuse: a decoder
    layer whose head dim (its cross-attention width over its heads:
    ``decoder.hidden_dim // encoder.nhead``, times ``decoder.layer_scale``
    past ``decoder.eval_idx``) is outside what the sampling kernel and the
    value-gradient scatters take, more than ``MAX_POINTS`` sampling points
    over the levels (``decoder.num_points``), or more than ``MAX_LEVELS``
    levels (``decoder.num_levels``): the deformable-attention backward
    kernel takes the sampling kernel's limits. Every layer is read, the wide ones that
    only training runs too. Called where a model reaches a CUDA device, so
    that such a model fails there and not at its first forward."""
    dec = model.decoder
    dims = sorted(set(HEAD_DIMS) & set(TILE_WIDTHS))
    levels = len(dec.input_proj)
    for i, layer in enumerate(dec.decoder.layers):
        attn = layer.cross_attn
        d = attn.embed_dim // attn.num_heads
        if d not in dims:
            setting = ("decoder.hidden_dim * decoder.layer_scale // encoder.nhead"
                       if attn.embed_dim != dec.hidden_dim else
                       "decoder.hidden_dim // encoder.nhead")
            raise ValueError(f"decoder layer {i}: head dim {setting} = {d}: the CUDA kernels "
                             f"take {dims}")
        points = attn.num_points_list
        if sum(points) > MAX_POINTS:
            raise ValueError(f"decoder.num_points {list(points)} sum to {sum(points)}: the "
                             f"sampling kernel takes at most {MAX_POINTS}")
    if levels > MAX_LEVELS:
        raise ValueError(f"decoder.num_levels = {levels}: the sampling kernel takes at most "
                         f"{MAX_LEVELS}")
