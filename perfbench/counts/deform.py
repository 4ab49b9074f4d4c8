"""Bytes and operations of the deformable-attention kernels, from the
sampling locations the reference computed (``reference.deform.recorded``):
the counts of ``chip_smoke.py::_touched``, ``_deform_bound`` and
``_bwd_bound``. Only the value rows that a valid bilinear corner reads are
counted, each once; loc, att, the upstream gradient and the outputs once.
Dtypes are the ones the configurations run: value in bf16 (2 bytes),
loc, att and the forward's output in f32, the backward's payload in f32.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from .peaks import least_seconds

VALUE_BYTES = 2
F32 = 4


def touched(loc: torch.Tensor, shapes: Sequence[Tuple[int, int]], points: Sequence[int],
            rows_per_batch: int) -> Tuple[int, int]:
    """(distinct (batch, row, head) value rows a valid corner of ``loc``
    [B, Q, H, P, 2] reads, number of valid corners)."""
    b, q, heads = loc.shape[:3]
    keys, corners, start, p0 = [], 0, 0, 0
    head = torch.arange(heads, device=loc.device)[None, None, :, None]
    batch = torch.arange(b, device=loc.device)[:, None, None, None]
    for (h, w), p in zip(shapes, points):
        lv = loc[:, :, :, p0:p0 + p].float()
        x0 = torch.floor(lv[..., 0] * w - 0.5).long()
        y0 = torch.floor(lv[..., 1] * h - 0.5).long()
        for dy in (0, 1):
            for dx in (0, 1):
                xi, yi = x0 + dx, y0 + dy
                valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
                key = (batch * rows_per_batch + start + yi * w + xi) * heads + head
                keys.append(key[valid])
                corners += int(valid.sum().item())
        start += h * w
        p0 += p
    return torch.unique(torch.cat(keys)).numel(), corners


def forward_call(call) -> Tuple[float, float]:
    """(bytes, operations) of one sampling call: the touched value rows,
    loc, att and the output once; an FMA a channel for each valid corner
    and for each point's attention weight."""
    shapes, points, vshape, loc, att = call
    b, s, heads, d = vshape
    rows, corners = touched(loc, shapes, points, s)
    q = loc.shape[1]
    nbytes = rows * d * VALUE_BYTES + loc.numel() * F32 + att.numel() * F32 + b * q * heads * d * F32
    return float(nbytes), float(corners * 2 * d + att.numel() * 2 * d)


def backward_call(call) -> Tuple[float, float]:
    """(bytes, operations) of one backward call: the touched value rows,
    loc, att and the upstream gradient read once; grad_loc and grad_att
    written once, and for each of the 4 corners of every (query, head,
    point) an index (4 bytes) and d channels of the f32 payload; an FMA a
    channel for each valid corner's g.v and a product a channel for each
    corner's contribution."""
    shapes, points, vshape, loc, att = call
    b, s, heads, d = vshape
    rows, corners = touched(loc, shapes, points, s)
    q = loc.shape[1]
    entries = 4 * att.numel()
    nbytes = (rows * d * VALUE_BYTES + 2 * (loc.numel() + att.numel()) * F32
              + b * q * heads * d * F32 + entries * (4 + d * F32))
    return float(nbytes), float(corners * 2 * d + entries * d)


def least_seconds_of(calls, which) -> float:
    """The least time of every recorded call together (``which``:
    ``forward_call`` or ``backward_call``)."""
    return sum(least_seconds(*which(c)) for c in calls)
