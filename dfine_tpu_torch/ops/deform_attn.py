"""Multi-scale deformable attention core (port of
``dfine_tpu/ops/deform_attn.py:30-101, :273-437``).

``ms_deform_attn_core`` is the plain PyTorch gather formulation.
``MSDeformAttnCore`` is the op the model runs: its forward is the custom op
``dfine_tpu_torch::ms_deform_attn_fwd`` (the sampling kernel on the card,
the plain version on the CPU), its backward computes the location and
attention gradients and the value gradient's scatter inputs in closed form
(deform_attn.py:306-434, the corner tables at :235-241) in one call of
``ms_deform_attn_bwd`` for all levels (the backward kernel on the card, its
plain version on the CPU) and sends each level's value gradient through
the scatter kernel that ``set_deform_bwd`` chose, as
``ms_deform_attn_core_fused(scatter_impl=...)`` does:

- ``"pallas"`` (the default): ``rows_scatter_add``, f32 payload;
- ``"mxu"``: ``rows_scatter_add_mxu``, payload rounded once to bf16;
- ``"tiled"``: ``rows_scatter_add_tiled``, the same bf16 payload, sorted,
  deterministic.

The JAX package's other settings are XLA formulations measured on the TPU,
with no kernel; they are not ported and ``set_deform_bwd`` raises on them.
On CPU tensors the kernels take their plain versions.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from .kernels.deform_attn import ms_deform_attn_bwd, ms_deform_attn_fwd_plain, ms_deform_attn_op
from .kernels.scatter_rows import rows_scatter_add, rows_scatter_add_mxu, rows_scatter_add_tiled

ms_deform_attn_core = ms_deform_attn_fwd_plain

_SCATTERS = {"pallas": rows_scatter_add, "mxu": rows_scatter_add_mxu,
             "tiled": rows_scatter_add_tiled}
_DEFORM_BWD = "pallas"


def set_deform_bwd(impl: str) -> None:
    """Choose the value-gradient scatter of every ``MSDeformAttnCore``
    forward run after this call (read at forward time, as the JAX package
    reads it at trace time)."""
    global _DEFORM_BWD
    if impl not in _SCATTERS:
        raise ValueError(f"unknown deform backward {impl!r}: use 'pallas', 'mxu' or 'tiled'")
    _DEFORM_BWD = impl


def deform_bwd_impl() -> str:
    return _DEFORM_BWD


class MSDeformAttnCore(torch.autograd.Function):
    """out = core(value, loc, att); see ``ms_deform_attn_fwd`` for layouts.
    The backward reads the head dim from the value itself, so the wide
    layers' value (head dim 64) goes to the scatter at D = 64."""

    @staticmethod
    def forward(ctx, value, loc, att, spatial_shapes: Sequence[Tuple[int, int]],
                num_points: Sequence[int]):
        spatial_shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
        num_points = tuple(int(p) for p in num_points)
        ctx.save_for_backward(value, loc, att)
        ctx.spatial_shapes = spatial_shapes
        ctx.num_points = num_points
        ctx.scatter = _SCATTERS[_DEFORM_BWD]
        flat = [n for hw in spatial_shapes for n in hw]
        return ms_deform_attn_op(value, flat, loc, att, list(num_points))

    @staticmethod
    def backward(ctx, g_out):
        value, loc, att = ctx.saved_tensors
        need_value = ctx.needs_input_grad[0]
        b, q = loc.shape[:2]
        nhead, d = value.shape[2], value.shape[3]
        # mxu/tiled: each contribution is rounded once to bf16 (scatter_rows.py:184, :282)
        payload = torch.float32 if ctx.scatter is rows_scatter_add else torch.bfloat16
        g = g_out.reshape(b, q, nhead * d).to(torch.float32).contiguous()
        grad_att, grad_loc, idx, contrib = ms_deform_attn_bwd(
            value, ctx.spatial_shapes, loc, att, g, ctx.num_points, payload, need_value)
        grad_value = None
        if need_value:
            grad_val_parts = []
            for (h, w), idx_l, contrib_l in zip(ctx.spatial_shapes, idx, contrib):
                gv = ctx.scatter(idx_l, contrib_l, h * w)  # [B*H, HW, D]
                grad_val_parts.append(gv.reshape(b, nhead, h * w, d).permute(0, 2, 1, 3))
            grad_value = torch.cat(grad_val_parts, 1).to(value.dtype)
        return grad_value, grad_loc.to(loc.dtype), grad_att.to(att.dtype), None, None


def ms_deform_attn(value, spatial_shapes, loc, att, num_points) -> torch.Tensor:
    """The deformable-attention core as the model calls it (through
    ``MSDeformAttnCore``). Returns [B, Q, nhead*d] f32."""
    return MSDeformAttnCore.apply(value, loc, att, spatial_shapes, num_points)


def grid_sample_bilinear(image: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """grid_sample(bilinear, zero padding, align_corners=False) in the JAX
    package's layout (``dfine_tpu/ops/deform_attn.py:440-471``): image [B, H,
    W, C], grid [B, Hg, Wg, 2] in [-1, 1] (x, y) -> [B, Hg, Wg, C]."""
    out = F.grid_sample(image.permute(0, 3, 1, 2), grid, mode="bilinear", padding_mode="zeros",
                        align_corners=False)
    return out.permute(0, 2, 3, 1)
