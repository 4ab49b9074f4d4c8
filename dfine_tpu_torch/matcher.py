"""Hungarian matching for the train step (port of ``dfine_tpu/matcher.py``).

The costs of every output set are computed on the device in one stacked
pass, ``[S, B, G, Q]``, and every (set, image) assignment over its valid
rows is solved there too, as the JAX package does: on the card by one
launch of the exact Hungarian kernel for all S * B problems
(``ops/kernels/hungarian.py``, ``csrc/hungarian_lap.cu``), on the CPU by its
plain version. No cost reaches the host, so matching does not synchronise
the step. The "go" union across sets is device code too. The class cost is
the focal one (the reference's default) or, with ``use_focal_loss=False``,
the softmax one; ``match_one_to_many`` repeats the exact assignment k times
with each round's queries blocked; no step calls it yet (the reference's
``return_topk`` has no caller either).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from .ops.boxes import box_cxcywh_to_xyxy, generalized_box_iou_pairwise
from .ops.kernels.hungarian import hungarian_lap


@dataclass(frozen=True)
class MatcherConfig:
    """Cost weights (reference src/d_fine/configs.py:40-51)."""

    cost_class: float = 2.0
    cost_bbox: float = 5.0
    cost_giou: float = 2.0
    alpha: float = 0.25
    gamma: float = 2.0
    use_focal_loss: bool = True


def matching_cost(pred_logits: torch.Tensor, pred_boxes: torch.Tensor,
                  tgt_labels: torch.Tensor, tgt_boxes: torch.Tensor, tgt_valid: torch.Tensor,
                  cfg: MatcherConfig) -> torch.Tensor:
    """Dense cost [..., B, G, Q] (rows GT slots, columns queries) of logits
    [..., B, Q, C] and boxes [..., B, Q, 4] against labels [..., B, G],
    boxes [B, G, 4]: class cost (focal, or softmax without ``use_focal_loss``)
    + L1 + -GIoU; invalid GT rows are 0."""
    logits = pred_logits.float()
    boxes = pred_boxes.float()
    tboxes = tgt_boxes.float()
    idx = tgt_labels.long()[..., None, :].expand(*logits.shape[:-1], tgt_labels.shape[-1])
    if cfg.use_focal_loss:
        p = torch.gather(torch.sigmoid(logits), -1, idx)  # [..., B, Q, G]
        neg = (1 - cfg.alpha) * (p**cfg.gamma) * (-torch.log1p(-(p - 1e-8)))
        pos = cfg.alpha * ((1 - p) ** cfg.gamma) * (-torch.log(p + 1e-8))
        cost_class = pos - neg
    else:
        cost_class = -torch.gather(logits.softmax(-1), -1, idx)
    cost_bbox = (boxes[..., :, None, :] - tboxes[..., None, :, :]).abs().sum(-1)  # [..,B,Q,G]
    cost_giou = -generalized_box_iou_pairwise(box_cxcywh_to_xyxy(boxes),
                                              box_cxcywh_to_xyxy(tboxes))
    c = cfg.cost_bbox * cost_bbox + cfg.cost_class * cost_class + cfg.cost_giou * cost_giou
    c = torch.nan_to_num(c, nan=1.0).transpose(-1, -2)  # [..., B, G, Q]
    # written row-major (the solver reads whole rows) by the masking itself:
    # no copy; nan_to_num left no inf, so the pad rows are exactly (+-)0
    out = torch.empty(c.shape, dtype=c.dtype, device=c.device)
    return torch.mul(c, tgt_valid[..., None], out=out)


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
    [S, B, G, Q] over its valid rows (tgt_valid [B, G]), on the costs'
    device. Returns the column of each row [S, B, G] int64, -1 on pad rows."""
    return hungarian_lap(costs, tgt_valid).long()


def match_one_to_many(costs: torch.Tensor, tgt_valid: torch.Tensor, k: int) -> torch.Tensor:
    """One-to-many matching (matcher.py:132-160): k rounds of the exact
    assignment of costs [S, B, G, Q] (or [B, G, Q]) over each problem's
    valid rows, on the costs' device; after each round the queries matched
    to valid rows cost 1e6 more (f32, as in JAX), so each valid row collects
    k distinct queries. Returns query indices [..., k, G] (round-major)
    int64, -1 on pad rows."""
    squeeze = costs.dim() == 3
    c = (costs[None] if squeeze else costs).detach().float()
    q = c.shape[-1]
    rounds = []
    for _ in range(k):
        m = hungarian(c, tgt_valid)  # [S, B, G]
        rounds.append(m)
        # block the queries of valid rows (column q absorbs the pad rows)
        blocked = torch.zeros((*m.shape[:2], q + 1), dtype=torch.bool, device=c.device)
        blocked.scatter_(2, torch.where(m >= 0, m, q), True)
        c = c + torch.where(blocked[..., None, :q], 1e6, 0.0)
    out = torch.stack(rounds, dim=-2)  # [S, B, k, G]
    return out[0] if squeeze else out


def solve_matchings(costs: torch.Tensor, tgt_valid: torch.Tensor):
    """Solve every assignment and build the go union. Pad rows come back
    as -1 from the solver and are sanitized to 0 here (matcher.py:179-184):
    every consumer masks them, and a -1 index is a device fault on CUDA.
    Returns match [S, B, G], go_q, go_t [B, S*G] int64, go_valid [B, S*G]."""
    q = costs.shape[-1]
    match = hungarian(costs, tgt_valid)
    go_q, go_t, go_valid = go_union(match, tgt_valid, q)
    return match.clamp_min(0), torch.where(go_valid, go_q, 0), go_t, go_valid
