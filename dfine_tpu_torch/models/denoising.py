"""Contrastive denoising (CDN) queries with static geometry (port of
``dfine_tpu/models/denoising.py``).

The group geometry is fixed by ``max_gt`` (the G of the padded targets):
``num_group = max(1, num_denoising // G)`` groups of ``2*G`` slots, a
positive half and a negative half; pad slots carry the background class and
are masked everywhere. The random draws are split from the geometry:
``draw_cdn_noise`` draws ``(flip, new_label, sign, part)`` from an explicit
``torch.Generator``; ``build_cdn_queries`` takes them and is deterministic,
so a caller can hand both frameworks the same noise.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..ops.boxes import box_cxcywh_to_xyxy, box_xyxy_to_cxcywh, inverse_sigmoid


class DnMeta(NamedTuple):
    num_group: int
    num_denoising: int  # total DN slots = 2 * num_group * max_gt
    max_gt: int


class CdnNoise(NamedTuple):
    """The random part of the CDN queries, each over the [B, D] slots:
    ``flip`` bool (label replaced), ``new_label`` int64 in [0, C),
    ``sign`` [B, D, 4] in {-1, +1}, ``part`` [B, D, 4] in [0, 1)."""

    flip: torch.Tensor
    new_label: torch.Tensor
    sign: torch.Tensor
    part: torch.Tensor

    def to(self, device) -> "CdnNoise":
        return CdnNoise(*(t.to(device) for t in self))


def num_groups(num_denoising: int, max_gt: int) -> int:
    return max(1, num_denoising // max_gt)


def dn_attn_mask(num_group: int, max_gt: int, num_queries: int) -> np.ndarray:
    """Boolean keep-mask [T, T] (True = may attend), T = DN + Q: matching
    queries never see DN slots, DN groups are blind to each other, everyone
    sees the matching queries."""
    d = 2 * max_gt * num_group
    t = d + num_queries
    keep = np.ones((t, t), dtype=bool)
    keep[d:, :d] = False
    for g in range(num_group):
        s, e = 2 * max_gt * g, 2 * max_gt * (g + 1)
        keep[s:e, :s] = False
        keep[s:e, e:d] = False
    return keep


def draw_cdn_noise(batch: int, max_gt: int, num_classes: int, num_denoising: int = 100,
                   label_noise_ratio: float = 0.5,
                   generator: Optional[torch.Generator] = None,
                   device: Optional[torch.device] = None) -> CdnNoise:
    """The four draws of ``build_cdn_queries`` (denoising.py:79-92) from
    ``generator``, on ``device`` (the generator's own by default)."""
    d = 2 * num_groups(num_denoising, max_gt) * max_gt
    device = generator.device if device is None and generator is not None else device
    kw = dict(generator=generator, device=device)
    flip = torch.rand((batch, d), **kw) < label_noise_ratio * 0.5
    new_label = torch.randint(0, num_classes, (batch, d), **kw)
    sign = torch.randint(0, 2, (batch, d, 4), **kw).float() * 2.0 - 1.0
    part = torch.rand((batch, d, 4), **kw)
    return CdnNoise(flip, new_label, sign, part)


def build_cdn_queries(labels: torch.Tensor, boxes: torch.Tensor, valid: torch.Tensor,
                      noise: CdnNoise, num_classes: int, num_denoising: int = 100,
                      label_noise_ratio: float = 0.5, box_noise_scale: float = 1.0):
    """labels [B, G] int, boxes [B, G, 4] cxcywh in [0, 1], valid [B, G] bool
    -> (dn_class_ids [B, D] int64, dn_bbox_unact [B, D, 4], DnMeta). Pad
    slots carry class ``num_classes`` (the embedding's zero row)."""
    b, g = labels.shape
    num_group = num_groups(num_denoising, g)
    reps = 2 * num_group
    cls = torch.where(valid, labels.long(), num_classes).repeat(1, reps)  # [B, D]
    box = torch.where(valid[..., None], boxes.float(), 0.0).repeat(1, reps, 1)
    vmask = valid.repeat(1, reps)
    negative = torch.zeros((1, 2 * g), dtype=torch.float32, device=boxes.device)
    negative[:, g:] = 1.0  # the second half of each group
    negative = negative.repeat(1, num_group)

    if label_noise_ratio > 0:
        cls = torch.where(noise.flip & vmask, noise.new_label, cls)
    if box_noise_scale > 0:
        known = box_cxcywh_to_xyxy(box)
        diff = (box[..., 2:] * 0.5).repeat(1, 1, 2) * box_noise_scale
        part = noise.part + negative[..., None]  # negatives pushed outside [1, 2)
        known = (known + noise.sign * part * diff).clamp(0.0, 1.0)
        box = box_xyxy_to_cxcywh(known).abs()
    return cls, inverse_sigmoid(box), DnMeta(num_group, reps * g, g)


# dn_match_indices' index rows on a device, by (G, num_group, device): made
# once, so that a train step copies nothing from the host
_DN_ROWS: Dict[Tuple, Tuple[torch.Tensor, torch.Tensor]] = {}


def dn_match_indices(valid: torch.Tensor, num_group: int):
    """Fixed DN matching: DN query ``g*2*G + j`` <-> target ``j`` of each
    group g. Returns (query_idx [B, num_group*G] int64, tgt_idx [..] int64,
    pair_valid [..] bool)."""
    b, g = valid.shape
    key = (g, num_group, str(valid.device))
    if key not in _DN_ROWS:
        j = np.arange(g)
        q_idx = np.concatenate([gg * 2 * g + j for gg in range(num_group)])
        with torch.inference_mode(False):  # usable by autograd after serving
            _DN_ROWS[key] = tuple(torch.from_numpy(a).to(valid.device)
                                  for a in (q_idx, np.tile(j, num_group)))
    q_rows, t_rows = _DN_ROWS[key]
    return q_rows[None].expand(b, -1), t_rows[None].expand(b, -1), valid.repeat(1, num_group)
