"""D-FINE det+seg criterion (port of ``dfine_tpu/train/criterion.py``).

Targets are padded: labels [B, G], boxes [B, G, 4] cxcywh, valid [B, G],
and for the ``masks`` loss masks [B, G, Hm', Wm'] with mask_valid [B, G]
(``valid`` where absent). Every output set shares the [B, Q, .] shapes, so
the losses run stacked over a set axis, in the order final, aux_0.., pre,
enc_0.. (as the JAX package's vmapped pass does); the DN sets are stacked
the same way. Each loss function below takes that leading set axis S and
returns one value per set. Matching is ``matcher.solve_matchings`` (the
exact Hungarian solver on the device, no host round trip). Losses:
``vfl``, ``focal`` (with ``label_smoothing``), ``boxes``, ``local`` (FGL +
DDF) and ``masks`` (focal BCE + Dice of the matched queries' lazy mask
logits, with the DN zip truncation of
criterion.py:520-591). Class-agnostic encoder sets are padded to C classes
with -20 columns and matched to class 0 (criterion.py:338-366). With
``axis_name`` (data parallelism) the box normalizers are means over the
ranks (criterion.py:380-381); the DN group count, the DDF weights and the
mask normalizer stay per rank, as in JAX.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..matcher import MatcherConfig, matching_cost, solve_matchings
from ..models.denoising import dn_match_indices
from ..ops.boxes import box_cxcywh_to_xyxy, box_iou_aligned, generalized_box_iou_aligned
from ..ops.fdr import bbox2distance
from ..utils.profiling import span

def default_weight_dict() -> Dict[str, float]:
    """Loss weights (reference src/d_fine/configs.py:26-38)."""
    return {"loss_vfl": 1.0, "loss_bbox": 5.0, "loss_giou": 2.0, "loss_fgl": 0.15,
            "loss_ddf": 1.5, "loss_mask_bce": 10.0, "loss_mask_dice": 10.0}


@dataclass(frozen=True)
class CriterionConfig:
    num_classes: int = 80
    losses: Tuple[str, ...] = ("vfl", "boxes", "local")
    weight_dict: Dict[str, float] = field(default_factory=default_weight_dict)
    alpha: float = 0.75
    gamma: float = 2.0
    reg_max: int = 32
    reg_scale: float = 4.0
    up: float = 0.5
    label_smoothing: float = 0.0
    matcher: MatcherConfig = field(default_factory=MatcherConfig)
    ddf_temperature: float = 5.0


def _bce_with_logits(logits, targets):
    return logits.clamp_min(0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))


def _pair_iou(pred_boxes, q_idx, pair_boxes):
    """IoU of matched pairs: pred [S, B, Q, 4] at q_idx [S or 1, B, K]
    against pair_boxes [B, K, 4] (cxcywh). Returns [S, B, K]."""
    p = gather_q(pred_boxes.float(), q_idx)
    return box_iou_aligned(box_cxcywh_to_xyxy(p), box_cxcywh_to_xyxy(pair_boxes.float()))[0]


def gather_q(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [S, B, Q, F], idx [S or 1, B, K] (or [B, K]) -> [S, B, K, F]."""
    if idx.dim() == 2:
        idx = idx[None]
    s, b, _, f = x.shape
    return torch.gather(x, 2, idx.expand(s, b, -1)[..., None].expand(s, b, -1, f))


def loss_vfl(logits, boxes, q_idx, pair_labels, pair_boxes, pair_valid, num_boxes,
             cfg: CriterionConfig):
    """Varifocal loss per set. logits [S, B, Q, C], boxes [S, B, Q, 4];
    pairs (q_idx [S or 1, B, K], target labels [S or 1, B, K] and boxes
    [B, K, 4]), valid [B, K]. Returns [S]."""
    logits = logits.float()
    s, b, q, c = logits.shape
    iou = _pair_iou(boxes, q_idx, pair_boxes).detach()  # [S, B, K]
    q_idx = (q_idx if q_idx.dim() == 3 else q_idx[None]).expand(s, b, -1)
    safe_q = torch.where(pair_valid, q_idx, q)  # column q absorbs the pads
    lab = torch.where(pair_valid, pair_labels.expand(s, b, -1), cfg.num_classes)
    cls_grid = torch.full((s, b, q + 1), cfg.num_classes, dtype=torch.long,
                          device=logits.device).scatter(2, safe_q, lab.long())[..., :q]
    iou_grid = torch.zeros((s, b, q + 1), device=logits.device).scatter(
        2, safe_q, torch.where(pair_valid, iou, 0.0))[..., :q]
    onehot = F.one_hot(cls_grid, cfg.num_classes + 1)[..., :-1].float()
    target_score = iou_grid[..., None] * onehot
    pred_score = torch.sigmoid(logits).detach()
    weight = cfg.alpha * pred_score.pow(cfg.gamma) * (1.0 - onehot) + target_score
    bce = _bce_with_logits(logits, target_score) * weight
    return bce.sum((1, 2, 3)) / num_boxes


def loss_focal(logits, q_idx, pair_labels, pair_valid, num_boxes, cfg: CriterionConfig):
    """Sigmoid focal classification loss with label smoothing per set
    (criterion.py:117-140), arguments as ``loss_vfl``'s. Returns [S]."""
    logits = logits.float()
    s, b, q, c = logits.shape
    q_idx = (q_idx if q_idx.dim() == 3 else q_idx[None]).expand(s, b, -1)
    safe_q = torch.where(pair_valid, q_idx, q)
    lab = torch.where(pair_valid, pair_labels.expand(s, b, -1), cfg.num_classes)
    cls_grid = torch.full((s, b, q + 1), cfg.num_classes, dtype=torch.long,
                          device=logits.device).scatter(2, safe_q, lab.long())[..., :q]
    target = F.one_hot(cls_grid, cfg.num_classes + 1)[..., :-1].float()
    if cfg.label_smoothing > 0:
        target = target * (1 - cfg.label_smoothing) + cfg.label_smoothing / c
    p = torch.sigmoid(logits)
    p_t = p * target + (1 - p) * (1 - target)
    loss = _bce_with_logits(logits, target) * (1 - p_t) ** cfg.gamma
    alpha_t = cfg.alpha * target + (1 - cfg.alpha) * (1 - target)
    return (alpha_t * loss).sum((1, 2, 3)) / num_boxes


def loss_boxes(boxes, q_idx, pair_boxes, pair_valid, num_boxes):
    """L1 and GIoU losses per set on the pairs (q_idx [B, K] or
    [S, B, K], pair_boxes [B, K, 4]). Returns ([S], [S])."""
    src = gather_q(boxes.float(), q_idx)
    dst = pair_boxes.float()[None]
    m = pair_valid.float()
    l1 = ((src - dst).abs().sum(-1) * m).sum((1, 2)) / num_boxes
    giou = 1.0 - generalized_box_iou_aligned(box_cxcywh_to_xyxy(src), box_cxcywh_to_xyxy(dst))
    return l1, (giou * m).sum((1, 2)) / num_boxes


def fgl_targets(ref_points, q_idx, pair_boxes, cfg: CriterionConfig):
    """FGL bin targets of the pairs from the (layer-invariant) initial
    reference points ref_points [B, Q, 4]. Returns three [B, K, 4]."""
    ref = gather_q(ref_points.float()[None], q_idx)[0].detach()
    dst = box_cxcywh_to_xyxy(pair_boxes.float())
    b, k = q_idx.shape
    t_bins, w_r, w_l = bbox2distance(ref.reshape(-1, 4), dst.reshape(-1, 4), cfg.reg_max,
                                     cfg.reg_scale, cfg.up)
    return t_bins.reshape(b, k, 4), w_r.reshape(b, k, 4), w_l.reshape(b, k, 4)


def loss_fgl(corners, q_idx, pair_valid, pair_iou, num_boxes, cfg: CriterionConfig, cache):
    """Unimodal distribution focal loss over the corner bins, IoU-weighted,
    per set. corners [S, B, Q, 4*(R+1)], pair_iou [S, B, K]. Returns [S]."""
    t_bins, w_r, w_l = cache
    s = corners.shape[0]
    b, k = q_idx.shape
    logp = F.log_softmax(gather_q(corners.float(), q_idx).reshape(s, b, k, 4, cfg.reg_max + 1),
                         -1)
    left = t_bins.long()
    right = (left + 1).clamp(0, cfg.reg_max)
    ce_l = -torch.gather(logp, -1, left[None, ..., None].expand(s, -1, -1, -1, 1))[..., 0]
    ce_r = -torch.gather(logp, -1, right[None, ..., None].expand(s, -1, -1, -1, 1))[..., 0]
    loss = ce_l * w_l + ce_r * w_r  # [S, B, K, 4]
    loss = loss * pair_iou.detach()[..., None] * pair_valid.float()[..., None]
    return loss.sum((1, 2, 3)) / num_boxes


def ddf_teacher_cache(teacher_corners, teacher_logits, cfg: CriterionConfig):
    """Teacher-side DDF terms shared by every student set: the tempered
    corner distribution, its log, and the max class probability per query."""
    b, q = teacher_logits.shape[:2]
    teach = teacher_corners.float().detach().reshape(b, q, 4, cfg.reg_max + 1)
    t_prob = (teach / cfg.ddf_temperature).softmax(-1)
    t_log = t_prob.clamp_min(1e-12).log()
    w_base = torch.sigmoid(teacher_logits.float()).max(-1).values.detach()
    return t_prob, t_log, w_base


def loss_ddf(corners, teacher_cache, q_idx, pair_valid, pair_iou, num_pos, num_neg,
             cfg: CriterionConfig):
    """Decoupled distillation focal loss from the teacher into each student
    set. corners [S, B, Q, 4*(R+1)], pair_iou [S, B, K]. Returns [S]."""
    T = cfg.ddf_temperature
    t_prob, t_log, w_base = teacher_cache
    s, b, q = corners.shape[:3]
    pred = corners.float().reshape(s, b, q, 4, cfg.reg_max + 1)
    safe_q = torch.where(pair_valid, q_idx, q)[None].expand(s, -1, -1)
    w = torch.cat([w_base, w_base.new_zeros(b, 1)], 1)[None].repeat(s, 1, 1)
    w = w.scatter(2, safe_q, torch.where(pair_valid, pair_iou, 0.0))[..., :q].detach()
    mask = torch.zeros((b, q + 1), dtype=torch.bool, device=corners.device)
    mask = mask.scatter(1, safe_q[0], pair_valid)[:, :q]
    kl = (t_prob * (t_log - F.log_softmax(pred / T, -1))).sum(-1)  # [S, B, Q, 4]
    loss = w[..., None] * (T**2) * kl
    m4 = mask[..., None].expand(b, q, 4).float()
    pos_cnt = m4.sum().clamp_min(1.0)
    neg_cnt = (1.0 - m4).sum().clamp_min(1.0)
    loss_pos = (loss * m4).sum((1, 2, 3)) / pos_cnt
    loss_neg = (loss * (1.0 - m4)).sum((1, 2, 3)) / neg_cnt
    return (loss_pos * num_pos + loss_neg * num_neg) / (num_pos + num_neg)


def mask_logits(embed: torch.Tensor, q_idx: torch.Tensor, mask_feat: torch.Tensor):
    """The lazy mask head's logits of the matched queries: embed [S, B, Q, C]
    gathered at q_idx [S, B, K], times mask_feat [B, C, Hm, Wm], in fp32
    after the product (criterion.py:267-269). Returns [S, B, K, Hm, Wm]."""
    emb = gather_q(embed, q_idx)  # [S, B, K, C]
    s, b, k, c = emb.shape
    hm, wm = mask_feat.shape[-2:]
    prod = torch.bmm(emb.transpose(0, 1).reshape(b, s * k, c),
                     mask_feat.reshape(b, c, hm * wm).to(emb.dtype))
    return prod.float().reshape(b, s, k, hm, wm).transpose(0, 1)


def loss_masks(pred, gt, m):
    """Adaptive-alpha focal BCE, a mean over each instance's pixels, and
    Dice (criterion.py:288-305) per set: pred [S, B, K, Hm, Wm] logits,
    gt [B, K, Hm, Wm] in [0, 1], m [B, K] the supervised pairs. Both are
    divided by max(#m, 1). Returns ([S], [S])."""
    mf = m.float()
    n_inst = mf.sum().clamp_min(1.0)
    alpha = 0.5 + 0.25 * (1.0 - 2.0 * gt.mean((2, 3), keepdim=True)).clamp(-1.0, 1.0)
    p = torch.sigmoid(pred)
    p_t = p * gt + (1 - p) * (1 - gt)
    alpha_t = alpha * gt + (1 - alpha) * (1 - gt)
    focal = alpha_t * (1 - p_t) ** 2.0 * _bce_with_logits(pred, gt)
    loss_bce = (focal.mean((3, 4)) * mf).sum((1, 2)) / n_inst
    pf, gf = p.flatten(3), gt.flatten(2)
    dice = 1.0 - (2.0 * (pf * gf).sum(-1) + 1e-6) / (pf.sum(-1) + gf.sum(-1) + 1e-6)
    return loss_bce, (dice * mf).sum((1, 2)) / n_inst


def _gt_masks(targets, size):
    """The GT masks at the mask head's size (nearest with half-pixel centres,
    as ``jax.image.resize``'s "nearest"), clipped to [0, 1], and mask_valid."""
    gt = targets["masks"].float()
    if tuple(gt.shape[2:]) != tuple(size):
        gt = F.interpolate(gt, size=tuple(size), mode="nearest-exact")
    return gt.clamp(0.0, 1.0), targets.get("mask_valid", targets["valid"])


def _mean_over_ranks(x: torch.Tensor, axis_name: Optional[str]) -> torch.Tensor:
    """psum(x) / world over the process group of ``axis_name``."""
    if axis_name is None:
        return x
    from ..parallel.dp import all_reduce_mean_

    x = x.clone()
    all_reduce_mean_([x])
    return x


def criterion_forward(outputs: Dict[str, Any], targets: Dict[str, torch.Tensor],
                      cfg: CriterionConfig, axis_name: Optional[str] = None
                      ) -> Dict[str, torch.Tensor]:
    """Weighted losses of every supervised set and their ``total``, each
    ``nan_to_num``'ed (criterion.py:315-613); ``axis_name``: the box
    normalizers averaged over the ranks."""
    labels, tboxes, valid = targets["labels"].long(), targets["boxes"].float(), targets["valid"]
    b = valid.shape[0]
    use, wd = set(cfg.losses), cfg.weight_dict
    losses: Dict[str, torch.Tensor] = {}

    def put(name, suffixes, values):
        if name in wd:
            for suf, v in zip(suffixes, values):
                losses[name + suf] = v * wd[name]

    aux = list(outputs.get("aux_outputs", []))
    enc = list(outputs.get("enc_aux_outputs", []))
    main = [outputs] + aux + [outputs["pre_outputs"]]
    n_aux = len(aux)
    suffixes = ([""] + [f"_aux_{i}" for i in range(n_aux)] + ["_pre"]
                + [f"_enc_{i}" for i in range(len(enc))])
    c = outputs["pred_logits"].shape[-1]
    enc_lg = [s_["pred_logits"] for s_ in enc]
    enc_labels = labels
    if outputs.get("enc_meta", {}).get("class_agnostic", False):
        # one objectness column, padded to C with columns of sigmoid(-20) ~ 2e-9
        enc_lg = [torch.cat([lg, lg.new_full((*lg.shape[:-1], c - lg.shape[-1]), -20.0)], -1)
                  for lg in enc_lg]
        enc_labels = torch.zeros_like(labels)
    lg_s = torch.stack([s_["pred_logits"] for s_ in main] + enc_lg).float()  # [S, B, Q, C]
    bx_s = torch.stack([s_["pred_boxes"] for s_ in main + enc]).float()
    lb_s = torch.stack([labels] * len(main) + [enc_labels] * len(enc))  # [S, B, G]
    q = lg_s.shape[2]
    with span("train.match"):
        costs = matching_cost(lg_s.detach(), bx_s.detach(), lb_s, tboxes, valid, cfg.matcher)
        match, go_q, go_t, go_valid = solve_matchings(costs, valid)

    counts = _mean_over_ranks(torch.stack([valid.sum(), go_valid.sum()]).float(), axis_name)
    num_boxes, num_boxes_go = counts.clamp_min(1.0).unbind()
    scale = 8.0 / b  # DDF pos/neg weights: batch-size invariant
    mask_cnt = go_valid.sum().float() * 4.0
    num_pos = (mask_cnt * scale).clamp_min(1e-12).sqrt()
    num_neg = ((b * q * 4.0 - mask_cnt) * scale).clamp_min(1e-12).sqrt()

    go_boxes = torch.gather(tboxes, 1, go_t[..., None].expand(-1, -1, 4))
    if "vfl" in use:
        put("loss_vfl", suffixes, loss_vfl(lg_s, bx_s, match, lb_s, tboxes, valid, num_boxes, cfg))
    if "focal" in use:
        put("loss_focal", suffixes, loss_focal(lg_s, match, lb_s, valid, num_boxes, cfg))
    if "boxes" in use:
        l1, giou = loss_boxes(bx_s, go_q, go_boxes, go_valid, num_boxes_go)
        put("loss_bbox", suffixes, l1)
        put("loss_giou", suffixes, giou)
    if "local" in use:  # corner sets: final (no ddf) and aux (ddf)
        n_loc = 1 + n_aux
        cr_s = torch.stack([s_["pred_corners"] for s_ in main[:n_loc]])
        iou_s = _pair_iou(bx_s[:n_loc], go_q[None], go_boxes)
        cache = fgl_targets(outputs["ref_points"], go_q, go_boxes, cfg)
        put("loss_fgl", suffixes[:n_loc],
            loss_fgl(cr_s, go_q, go_valid, iou_s, num_boxes_go, cfg, cache))
        if n_aux:
            teacher = ddf_teacher_cache(outputs["pred_corners"], outputs["pred_logits"], cfg)
            put("loss_ddf", suffixes[1:n_loc],
                loss_ddf(cr_s[1:], teacher, go_q, go_valid, iou_s[1:], num_pos, num_neg, cfg))
    mask_feat = outputs.get("mask_feat")
    with_masks = "masks" in use and mask_feat is not None and "mask_embed" in outputs
    if with_masks and "masks" in targets:  # final and aux sets, each on its own match
        gt, mask_valid = _gt_masks(targets, mask_feat.shape[-2:])
        n_m = 1 + n_aux
        emb = torch.stack([s_["mask_embed"] for s_ in main[:n_m]])
        bce, dice = loss_masks(mask_logits(emb, match[:n_m], mask_feat), gt, valid & mask_valid)
        put("loss_mask_bce", suffixes[:n_m], bce)
        put("loss_mask_dice", suffixes[:n_m], dice)

    if "dn_outputs" in outputs:  # fixed DN matching (criterion.py:493-609)
        dn_q, dn_t, dn_valid = dn_match_indices(valid, outputs["dn_meta"]["dn_num_group"])
        dn_num_boxes = num_boxes * outputs["dn_meta"]["dn_num_group"]
        dn_sets = outputs["dn_outputs"]
        # with masks, the reference's zip truncation leaves the last DN layer
        # out of the DN sets, its masks supervised alone as "_dn_final"
        dn_masks = with_masks and "mask_embed" in dn_sets[0]
        dn_iter = dn_sets[:-1] if dn_masks else dn_sets
        n_dn = len(dn_iter)
        dn_all = dn_iter + [outputs["dn_pre_outputs"]]  # pre: vfl and boxes only
        dn_suf = [f"_dn_{i}" for i in range(n_dn)] + ["_dn_pre"]
        dn_lg = torch.stack([d_["pred_logits"] for d_ in dn_all]).float()
        dn_bx = torch.stack([d_["pred_boxes"] for d_ in dn_all]).float()
        dn_labels = torch.gather(labels, 1, dn_t)
        dn_boxes = torch.gather(tboxes, 1, dn_t[..., None].expand(-1, -1, 4))
        if "vfl" in use:
            put("loss_vfl", dn_suf, loss_vfl(dn_lg, dn_bx, dn_q[None], dn_labels[None], dn_boxes,
                                             dn_valid, dn_num_boxes, cfg))
        if "boxes" in use:
            l1, giou = loss_boxes(dn_bx, dn_q, dn_boxes, dn_valid, dn_num_boxes)
            put("loss_bbox", dn_suf, l1)
            put("loss_giou", dn_suf, giou)
        if "local" in use and n_dn:
            cr_dn = torch.stack([d_["pred_corners"] for d_ in dn_iter])
            iou_dn = _pair_iou(dn_bx[:n_dn], dn_q[None], dn_boxes)
            cache = fgl_targets(dn_sets[0]["ref_points"], dn_q, dn_boxes, cfg)
            put("loss_fgl", dn_suf, loss_fgl(cr_dn, dn_q, dn_valid, iou_dn, dn_num_boxes, cfg,
                                             cache))
            teacher = ddf_teacher_cache(dn_sets[-1]["pred_corners"], dn_sets[-1]["pred_logits"],
                                        cfg)
            put("loss_ddf", dn_suf,
                loss_ddf(cr_dn, teacher, dn_q, dn_valid, iou_dn, num_pos, num_neg, cfg))
        if dn_masks and "masks" in targets:  # every DN layer, the last as "_dn_final"
            dn_gt = gt.gather(1, dn_t[..., None, None].expand(-1, -1, *gt.shape[2:]))
            emb = torch.stack([d_["mask_embed"] for d_ in dn_sets])
            bce, dice = loss_masks(mask_logits(emb, dn_q[None].expand(len(dn_sets), -1, -1),
                                               mask_feat),
                                   dn_gt, dn_valid & torch.gather(mask_valid, 1, dn_t))
            dn_mask_suf = dn_suf[:n_dn] + ["_dn_final"]
            put("loss_mask_bce", dn_mask_suf, bce)
            put("loss_mask_dice", dn_mask_suf, dice)

    losses = {k: torch.nan_to_num(v, nan=0.0) for k, v in losses.items()}
    losses["total"] = sum(losses.values())
    return losses
