"""The multi-scale deformable-attention core as plain ``grid_sample``
arithmetic (the classic formulation of Deformable DETR's PyTorch
reference), written for the benchmark and sharing no code with the
program's kernels or their plain versions.

Layouts: value [B, sum(h*w), H, D], loc [B, Q, H, P, 2] (x, y in [0, 1],
the points of each level consecutive, ``num_points`` of them a level),
att [B, Q, H, P]. Returns [B, Q, H*D] in float32. Bilinear, zero padding,
half-pixel centres (``align_corners=False``).

``recorded`` is a list that, while not None, receives one (spatial_shapes,
num_points, value_shape, loc, att) tuple a call, detached: the byte counts
of ``perfbench/counts`` read the sampling locations from it.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

recorded = None


def ms_deform_attn(value: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
                   loc: torch.Tensor, att: torch.Tensor,
                   num_points: Sequence[int]) -> torch.Tensor:
    b, _, heads, d = value.shape
    q = loc.shape[1]
    if recorded is not None:
        recorded.append((tuple((int(h), int(w)) for h, w in spatial_shapes),
                         tuple(int(p) for p in num_points), tuple(value.shape),
                         loc.detach(), att.detach()))
    grids = 2.0 * loc.float() - 1.0
    out = value.new_zeros((b * heads, d, q), dtype=torch.float32)
    start, p0 = 0, 0
    for (h, w), p in zip(spatial_shapes, num_points):
        v = value[:, start:start + h * w].float()  # [B, hw, H, D]
        v = v.permute(0, 2, 3, 1).reshape(b * heads, d, h, w)
        g = grids[:, :, :, p0:p0 + p].permute(0, 2, 1, 3, 4).reshape(b * heads, q, p, 2)
        s = F.grid_sample(v, g, mode="bilinear", padding_mode="zeros", align_corners=False)
        a = att[:, :, :, p0:p0 + p].float().permute(0, 2, 1, 3).reshape(b * heads, 1, q, p)
        out = out + (s * a).sum(-1)  # [B*H, D, Q]
        start += h * w
        p0 += p
    return out.reshape(b, heads * d, q).transpose(1, 2).contiguous()
