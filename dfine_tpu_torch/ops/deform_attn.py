"""Multi-scale deformable attention core (port of
``dfine_tpu/ops/deform_attn.py:30-101, :273-437``).

``ms_deform_attn_core`` is the plain PyTorch gather formulation.
``MSDeformAttnCore`` is the op the model runs: its forward is the custom op
``dfine_tpu_torch::ms_deform_attn_fwd`` (the sampling kernel on the card,
the plain version on the CPU), its backward computes the location and
attention gradients in closed form (the corner tables of
deform_attn.py:235-241) and sends each
level's value gradient through the scatter kernel that ``set_deform_bwd``
chose, as ``ms_deform_attn_core_fused(scatter_impl=...)`` does:

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

from .kernels.deform_attn import ms_deform_attn_fwd_plain, ms_deform_attn_op
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

# (dy, dx, weight, d weight / d fx, d weight / d fy) per bilinear corner
_CORNER_TABLE = (
    (0, 0, lambda fx, fy: (1 - fx) * (1 - fy), lambda fx, fy: -(1 - fy), lambda fx, fy: -(1 - fx)),
    (0, 1, lambda fx, fy: fx * (1 - fy), lambda fx, fy: (1 - fy), lambda fx, fy: -fx),
    (1, 0, lambda fx, fy: (1 - fx) * fy, lambda fx, fy: -fy, lambda fx, fy: (1 - fx)),
    (1, 1, lambda fx, fy: fx * fy, lambda fx, fy: fy, lambda fx, fy: fx),
)


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
        f32 = torch.float32
        # mxu/tiled: each contribution is rounded once to bf16 (scatter_rows.py:184, :282)
        payload = f32 if ctx.scatter is rows_scatter_add else torch.bfloat16
        g = g_out.reshape(b, q, nhead, d).to(f32)
        att32 = att.to(f32)
        grad_loc = torch.zeros(loc.shape, dtype=f32, device=loc.device)
        grad_att = torch.zeros(att.shape, dtype=f32, device=att.device)
        grad_val_parts = []
        hw_start = p_start = 0
        for (h, w), p in zip(ctx.spatial_shapes, ctx.num_points):
            hw = h * w
            v_t = value[:, hw_start : hw_start + hw].to(f32).permute(0, 2, 1, 3)  # [B,H,HW,D]
            l = loc[:, :, :, p_start : p_start + p].to(f32)
            a = att32[:, :, :, p_start : p_start + p]  # [B,Q,H,P]
            x = l[..., 0] * w - 0.5
            y = l[..., 1] * h - 0.5
            x0 = torch.floor(x)
            y0 = torch.floor(y)
            fx = x - x0
            fy = y - y0
            x0i = x0.long()
            y0i = y0.long()

            ga_l = torch.zeros_like(a)
            gfx = torch.zeros_like(a)
            gfy = torch.zeros_like(a)
            idx_parts, contrib_parts = [], []
            for dy, dx, w_fn, dwdx_fn, dwdy_fn in _CORNER_TABLE:
                xi = x0i + dx
                yi = y0i + dy
                valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
                idx = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)  # [B,Q,H,P]
                idx_t = idx.permute(0, 2, 1, 3).reshape(b, nhead, q * p, 1)
                vc = torch.gather(v_t, 2, idx_t.expand(-1, -1, -1, d))
                vc = vc.reshape(b, nhead, q, p, d).permute(0, 2, 1, 3, 4)  # [B,Q,H,P,D]
                g_dot_v = torch.einsum("bqhd,bqhpd->bqhp", g, vc)
                m = valid.to(f32)
                wgt = w_fn(fx, fy) * m
                ga_l = ga_l + wgt * g_dot_v
                gfx = gfx + m * dwdx_fn(fx, fy) * g_dot_v
                gfy = gfy + m * dwdy_fn(fx, fy) * g_dot_v
                if need_value:
                    contrib = (a * wgt)[..., None] * g[:, :, :, None, :]  # [B,Q,H,P,D]
                    idx_eff = torch.where(valid, idx, -1)
                    idx_parts.append(idx_eff.permute(0, 2, 1, 3).reshape(b * nhead, q * p))
                    contrib_parts.append(
                        contrib.permute(0, 2, 1, 3, 4).reshape(b * nhead, q * p, d).to(payload))
            grad_att[:, :, :, p_start : p_start + p] = ga_l
            grad_loc[:, :, :, p_start : p_start + p, 0] = a * gfx * w  # dx/du = W
            grad_loc[:, :, :, p_start : p_start + p, 1] = a * gfy * h
            if need_value:
                idx_all = torch.cat(idx_parts, 1).to(torch.int32).contiguous()
                contrib_all = torch.cat(contrib_parts, 1).contiguous()
                gv = ctx.scatter(idx_all, contrib_all, hw)  # [B*H, HW, D]
                grad_val_parts.append(gv.reshape(b, nhead, hw, d).permute(0, 2, 1, 3))
            hw_start += hw
            p_start += p

        grad_value = torch.cat(grad_val_parts, 1).to(value.dtype) if need_value else None
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
