"""Hungarian matching for the train step (port of ``dfine_tpu/matcher.py``).

The costs of every output set are computed on the device in one stacked
pass, ``[S, B, G, Q]``; the assignments are solved on the host by
``scipy.optimize.linear_sum_assignment``, the reference's own solver, one
reduced problem (the valid GT rows) per (set, image). That is one
device-to-host copy, and so one synchronisation, per train step. (The JAX
package solves on the device only because its TPU runtime has no host
callbacks, ``dfine_tpu/ops/hungarian.py:1-33``.) The "go" union across sets
is device code again. The focal class cost is the only one ported (the
reference's default); one-to-many matching is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch
from scipy.optimize import linear_sum_assignment

from .ops.boxes import box_cxcywh_to_xyxy, generalized_box_iou_pairwise


@dataclass(frozen=True)
class MatcherConfig:
    """Cost weights (reference src/d_fine/configs.py:40-51)."""

    cost_class: float = 2.0
    cost_bbox: float = 5.0
    cost_giou: float = 2.0
    alpha: float = 0.25
    gamma: float = 2.0


def matching_cost(pred_logits: torch.Tensor, pred_boxes: torch.Tensor,
                  tgt_labels: torch.Tensor, tgt_boxes: torch.Tensor, tgt_valid: torch.Tensor,
                  cfg: MatcherConfig) -> torch.Tensor:
    """Dense cost [..., B, G, Q] (rows GT slots, columns queries) of logits
    [..., B, Q, C] and boxes [..., B, Q, 4] against labels [..., B, G],
    boxes [B, G, 4]: focal class cost + L1 + -GIoU; invalid GT rows are 0."""
    logits = pred_logits.float()
    boxes = pred_boxes.float()
    tboxes = tgt_boxes.float()
    idx = tgt_labels.long()[..., None, :].expand(*logits.shape[:-1], tgt_labels.shape[-1])
    p = torch.gather(torch.sigmoid(logits), -1, idx)  # [..., B, Q, G]
    neg = (1 - cfg.alpha) * (p**cfg.gamma) * (-torch.log1p(-(p - 1e-8)))
    pos = cfg.alpha * ((1 - p) ** cfg.gamma) * (-torch.log(p + 1e-8))
    cost_class = pos - neg
    cost_bbox = (boxes[..., :, None, :] - tboxes[..., None, :, :]).abs().sum(-1)  # [..,B,Q,G]
    cost_giou = -generalized_box_iou_pairwise(box_cxcywh_to_xyxy(boxes),
                                              box_cxcywh_to_xyxy(tboxes))
    c = cfg.cost_bbox * cost_bbox + cfg.cost_class * cost_class + cfg.cost_giou * cost_giou
    c = torch.nan_to_num(c, nan=1.0).transpose(-1, -2)  # [..., B, G, Q]
    return torch.where(tgt_valid[..., None], c, 0.0)


def go_union(match: torch.Tensor, tgt_valid: torch.Tensor,
             num_queries: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Union of the (query, target) matches of all sets, match [S, B, G]
    (-1 on pad rows): each query keeps the target it was matched to most
    often, ties to the smaller target index. Returns go_q, go_t [B, S*G]
    int64 and go_valid [B, S*G] bool."""
    s, b, g = match.shape
    k = s * g
    dev = match.device
    q_flat = match.permute(1, 0, 2).reshape(b, k)
    t_flat = torch.arange(g, device=dev).repeat(s)[None].expand(b, k)
    v_flat = tgt_valid[:, None, :].expand(b, s, g).reshape(b, k)
    count = (match[:, None] == match[None, :]).sum(0)  # [S, B, G]: sets agreeing on slot g
    c_flat = count.permute(1, 0, 2).reshape(b, k)
    # higher count wins, ties to the smaller target; distinct pairs sharing
    # a query always score differently
    score = torch.where(v_flat, c_flat * (g + 1) + (g - t_flat), -1)
    safe = torch.where(v_flat, q_flat, num_queries)  # column num_queries absorbs the pads
    best = torch.full((b, num_queries + 1), -1, dtype=score.dtype, device=dev)
    best = best.scatter_reduce(1, safe, score, "amax")
    winner = v_flat & (score == best.gather(1, safe))
    idx = torch.arange(k, device=dev)[None].expand(b, k)
    first = torch.full((b, num_queries + 1), k, dtype=idx.dtype, device=dev)
    first = first.scatter_reduce(1, torch.where(winner, q_flat, num_queries),
                                 torch.where(winner, idx, k), "amin")
    keep = winner & (idx == first.gather(1, safe))
    return q_flat, t_flat, keep


def hungarian(costs: torch.Tensor, tgt_valid: torch.Tensor) -> torch.Tensor:
    """Exact min-cost assignment of every (set, image) problem of costs
    [S, B, G, Q] over its valid rows, by scipy on the host. Returns the
    column of each row [S, B, G] int64 on the costs' device, -1 on pad rows."""
    c = costs.detach().float().cpu().numpy()  # the step's one device-to-host sync
    v = tgt_valid.detach().cpu().numpy()
    s, b, g, _ = c.shape
    out = np.full((s, b, g), -1, np.int64)
    for bi in range(b):
        rows = np.flatnonzero(v[bi])
        if rows.size == 0:
            continue
        for si in range(s):
            r, col = linear_sum_assignment(c[si, bi][rows])
            out[si, bi, rows[r]] = col
    return torch.from_numpy(out).to(costs.device)


def solve_matchings(costs: torch.Tensor, tgt_valid: torch.Tensor):
    """Solve every assignment and build the go union. Pad rows come back
    as -1 from the solver and are sanitized to 0 here (matcher.py:179-184):
    every consumer masks them, and a -1 index is a device fault on CUDA.
    Returns match [S, B, G], go_q, go_t [B, S*G] int64, go_valid [B, S*G]."""
    q = costs.shape[-1]
    match = hungarian(costs, tgt_valid)
    go_q, go_t, go_valid = go_union(match, tgt_valid, q)
    return match.clamp_min(0), torch.where(go_valid, go_q, 0), go_t, go_valid
