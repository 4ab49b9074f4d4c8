"""DFINETransformer decoder (port of ``dfine_tpu/models/decoder.py``): top-k
query selection (``default``, ``one2many``, ``agnostic``), decoder layers of
self-attention + deformable cross-attention + gate + FFN, the FDR integral
with distance2bbox, LQE, and the mask pixel decoder.

Eval mode runs ``eval_idx + 1`` layers and returns the last layer's
outputs. With ``layer_scale`` > 1 the layers past ``eval_idx`` are wide
(``hidden_dim * layer_scale``, FFN ``dim_feedforward * layer_scale``, their
score and box heads too, decoder.py:515-590): train mode enters them with
the query features, the query positions and the value repeated channel-wise
(JAX's "nearest" resize by an integer factor), and eval mode never runs
them. ``num_levels`` above the encoder's maps adds stride-2 levels
(decoder.py:374-385): a 3x3 stride-2 conv and BatchNorm over the
unprojected last map, then over the previous level.

Train mode (``self.training``) runs all ``num_layers`` layers and returns
the sets the criterion supervises (decoder.py:390-729): the final
layer, ``aux_outputs``, ``pre_outputs``, ``enc_aux_outputs`` and, when
targets are given, the contrastive-denoising queries' ``dn_outputs``,
``dn_pre_outputs`` and ``dn_meta``. With the mask head, train mode emits the
lazy mask head (decoder.py:659-673): each layer's set carries its queries'
``mask_embed`` [B, Q, mask_dim] and the final set also the pixel decoder's
``mask_feat`` [B, mask_dim, Hm, Wm]; the criterion takes the product of the
matched embeddings alone, never [B, Q, Hm, Wm] logits per set. Submodule
names follow the reference (uc-vision) layout, which
``dfine_tpu.utils.checkpoint.torch_key_to_flax`` translates.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.boxes import inverse_sigmoid
from ..ops.deform_attn import ms_deform_attn
from ..ops.fdr import distance2bbox, integral, weighting_function
from .denoising import CdnNoise, build_cdn_queries, dn_attn_mask, draw_cdn_noise
from .layers import (MLP, BatchNorm2d, ConvNorm, LayerNorm, MultiHeadSelfAttention,
                     get_activation)


def bias_init_with_prob(prior: float) -> float:
    return float(-math.log((1 - prior) / prior))


def chan_repeat(x: torch.Tensor, factor: int) -> torch.Tensor:
    """The last dim ``factor`` times as wide, each channel repeated in place:
    JAX's ``jax.image.resize(..., "nearest")`` by an integer factor (torch's
    ``nearest-exact``, not ``nearest``, in general)."""
    return x.repeat_interleave(factor, -1)


def generate_anchors(spatial_shapes: Sequence[Tuple[int, int]], grid_size: float = 0.05,
                     eps: float = 1e-2):
    """Per-level anchors in logit space, +inf where invalid. Returns numpy
    (anchors [1, sumHW, 4] f32, valid [1, sumHW, 1] bool)."""
    anchors = []
    for lvl, (h, w) in enumerate(spatial_shapes):
        gy, gx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        xy = (np.stack([gx, gy], -1).astype(np.float32) + 0.5) / np.array([w, h], np.float32)
        wh = np.full_like(xy, grid_size * (2.0**lvl))
        anchors.append(np.concatenate([xy, wh], -1).reshape(-1, 4))
    a = np.concatenate(anchors, 0)[None]
    valid = ((a > eps) & (a < 1 - eps)).all(-1, keepdims=True)
    a = np.log(a / (1 - a))
    return np.where(valid, a, np.inf).astype(np.float32), valid


def offsets_bias_init(num_heads: int, num_points_list: Sequence[int]) -> np.ndarray:
    """Radial grid init of the sampling-offset biases."""
    thetas = np.arange(num_heads, dtype=np.float32) * (2.0 * np.pi / num_heads)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], -1)
    grid = grid / np.abs(grid).max(-1, keepdims=True)
    total = sum(num_points_list)
    grid = np.tile(grid.reshape(num_heads, 1, 2), (1, total, 1))
    scaling = np.concatenate([np.arange(1, n + 1) for n in num_points_list]).reshape(1, -1, 1)
    return (grid * scaling).reshape(-1).astype(np.float32)


class MSDeformableAttention(nn.Module):
    """Query-conditioned multi-scale deformable attention (no value/output
    projections). The core always goes through ``MSDeformAttnCore``."""

    def __init__(self, embed_dim, num_heads, num_points_list, offset_scale=0.5):
        super().__init__()
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.num_points_list = tuple(num_points_list)
        self.offset_scale = offset_scale
        total_p = sum(self.num_points_list)
        self.sampling_offsets = nn.Linear(embed_dim, total_p * num_heads * 2)
        self.attention_weights = nn.Linear(embed_dim, total_p * num_heads)
        # 1 / points of each point's level (the reference's num_points_scale
        # buffer); not in the state_dict, as the reference importer skips it
        self.register_buffer("num_points_scale", self._points_scale(), persistent=False)

    def _points_scale(self) -> torch.Tensor:
        return torch.tensor([1.0 / n for n in self.num_points_list for _ in range(n)],
                            dtype=torch.float32)

    def init_special_(self, generator=None):
        nn.init.zeros_(self.sampling_offsets.weight)
        with torch.no_grad():
            self.sampling_offsets.bias.copy_(torch.from_numpy(
                offsets_bias_init(self.num_heads, self.num_points_list)))
        nn.init.zeros_(self.attention_weights.weight)
        nn.init.zeros_(self.attention_weights.bias)
        with torch.no_grad():
            self.num_points_scale.copy_(self._points_scale())

    def forward(self, query, reference_points, value, spatial_shapes):
        """query [B,Q,C], reference_points [B,Q,4] cxcywh, value [B,sumHW,nhead,d]."""
        b, q = query.shape[:2]
        total_p = sum(self.num_points_list)
        offsets = self.sampling_offsets(query).reshape(b, q, self.num_heads, total_p, 2)
        attn = self.attention_weights(query).reshape(b, q, self.num_heads, total_p)
        attn = attn.float().softmax(-1)
        ref = reference_points.float()
        off = (offsets.float() * self.num_points_scale[:, None]
               * ref[:, :, None, None, 2:] * self.offset_scale)
        loc = ref[:, :, None, None, :2] + off  # [B,Q,H,P,2]
        out = ms_deform_attn(value, spatial_shapes, loc.contiguous(), attn.contiguous(),
                             self.num_points_list)
        return out.to(query.dtype)


class Gate(nn.Module):
    """Gated fusion of the self and cross features, then LayerNorm."""

    def __init__(self, d_model):
        super().__init__()
        self.d_model = d_model
        self.gate = nn.Linear(2 * d_model, 2 * d_model)
        self.norm = LayerNorm(d_model)

    def init_special_(self, generator=None):
        nn.init.zeros_(self.gate.weight)
        nn.init.constant_(self.gate.bias, bias_init_with_prob(0.5))

    def forward(self, x1, x2):
        gates = torch.sigmoid(self.gate(torch.cat([x1, x2], -1)))
        g1, g2 = gates[..., : self.d_model], gates[..., self.d_model :]
        return self.norm(g1 * x1 + g2 * x2)


class LQE(nn.Module):
    """Location quality estimator: corner-distribution statistics refine the
    class scores."""

    def __init__(self, k, hidden_dim, num_layers, reg_max):
        super().__init__()
        self.k, self.reg_max = k, reg_max
        self.reg_conf = MLP(4 * (k + 1), hidden_dim, 1, num_layers)

    def init_special_(self, generator=None):
        nn.init.zeros_(self.reg_conf.layers[-1].weight)
        nn.init.zeros_(self.reg_conf.layers[-1].bias)

    def forward(self, scores, pred_corners):
        b, l = pred_corners.shape[:2]
        prob = pred_corners.reshape(b, l, 4, self.reg_max + 1).float().softmax(-1)
        topk = prob.topk(self.k, dim=-1).values
        stat = torch.cat([topk, topk.mean(-1, keepdim=True)], -1)
        return scores + self.reg_conf(stat.reshape(b, l, -1).to(scores.dtype))


class TransformerDecoderLayer(nn.Module):
    """Self-attn + deformable cross-attn + gate + FFN."""

    def __init__(self, d_model, n_head, dim_feedforward, num_points_list, activation="relu"):
        super().__init__()
        self.self_attn = MultiHeadSelfAttention(d_model, n_head)
        self.norm1 = LayerNorm(d_model)
        self.cross_attn = MSDeformableAttention(d_model, n_head, num_points_list)
        self.gateway = Gate(d_model)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm3 = LayerNorm(d_model)
        self.act = get_activation(activation)

    def init_special_(self, generator=None):
        for lin in (self.linear1, self.linear2):
            nn.init.xavier_uniform_(lin.weight, generator=generator)

    def forward(self, target, ref_points, value, spatial_shapes, query_pos, attn_mask=None):
        q = k = target + query_pos
        target = self.norm1(target + self.self_attn(q, k, target, attn_mask))
        t2 = self.cross_attn(target + query_pos, ref_points, value, spatial_shapes)
        target = self.gateway(target, t2)
        target = target + self.linear2(self.act(self.linear1(target)))
        return self.norm3(target.clamp(-65504, 65504))


class TransformerDecoder(nn.Module):
    """Holds the decoder layers and their LQEs (the reference's
    ``decoder.decoder`` key prefix); the layers past ``eval_idx`` are
    ``layer_scale`` times as wide."""

    def __init__(self, hidden_dim, nhead, dim_feedforward, num_points, num_layers, reg_max,
                 activation, eval_idx, layer_scale):
        super().__init__()
        self.layers = nn.ModuleList(
            TransformerDecoderLayer(hidden_dim * (layer_scale if i > eval_idx else 1), nhead,
                                    dim_feedforward * (layer_scale if i > eval_idx else 1),
                                    num_points, activation)
            for i in range(num_layers))
        self.lqe_layers = nn.ModuleList(LQE(4, 64, 2, reg_max) for _ in range(num_layers))


class MaskPixelDecoder(nn.Module):
    """FPN maps + encoder memory -> mask features at twice the resolution of
    the first level (stride 4 at s/m/l/x)."""

    def __init__(self, in_channels: Sequence[int], enc_channels: int, out_ch: int = 256):
        super().__init__()
        self.lateral = nn.ModuleList(nn.Conv2d(c, out_ch, 1, bias=False) for c in in_channels)
        self.bn = nn.ModuleList(BatchNorm2d(out_ch) for _ in in_channels)
        self.enc_proj = nn.Conv2d(enc_channels, out_ch, 1, bias=False)
        self.enc_bn = BatchNorm2d(out_ch)
        self.upconv = nn.ConvTranspose2d(out_ch, out_ch, 2, stride=2, bias=False)
        self.bn1 = BatchNorm2d(out_ch)

    def bn_pairs(self) -> Tuple[Tuple[str, str], ...]:
        """(conv, BatchNorm) submodule names (``layers.ConvBN.bn_pairs``);
        ``upconv`` is a ``ConvTranspose2d``."""
        return tuple((f"lateral.{i}", f"bn.{i}") for i in range(len(self.lateral))) + \
            (("enc_proj", "enc_bn"), ("upconv", "bn1"))

    def forward(self, feats: List[torch.Tensor], enc_feat: torch.Tensor) -> torch.Tensor:
        x = self.bn[0](self.lateral[0](feats[0]))
        size = x.shape[-2:]
        for i in range(1, len(feats)):
            t = self.bn[i](self.lateral[i](feats[i]))
            x = x + F.interpolate(t, size=size, mode="bilinear", align_corners=False)
        e = self.enc_bn(self.enc_proj(enc_feat))
        x = x + F.interpolate(e, size=size, mode="bilinear", align_corners=False)
        return self.bn1(self.upconv(x), "relu")


class DFINETransformer(nn.Module):
    def __init__(self, num_classes=80, hidden_dim=256, num_queries=300,
                 feat_channels: Sequence[int] = (256, 256, 256), num_levels=3,
                 num_points: Sequence[int] = (3, 6, 3), nhead=8, num_layers=6,
                 dim_feedforward=1024, activation="relu", num_denoising=100, eval_idx=-1,
                 eps=1e-2, query_select_method="default", reg_max=32, reg_scale=4.0, up=0.5,
                 enable_mask_head=False, mask_dim=256, layer_scale=1, label_noise_ratio=0.5,
                 box_noise_scale=1.0):
        super().__init__()
        if query_select_method not in ("default", "one2many", "agnostic"):
            raise ValueError(f"unknown query_select_method {query_select_method!r}")
        if layer_scale < 1 or (hidden_dim * layer_scale) % nhead:
            raise ValueError(f"decoder.layer_scale = {layer_scale}: must be >= 1 and keep "
                             f"the wide width divisible by encoder.nhead = {nhead}")
        if layer_scale > 1 and enable_mask_head:
            # decoder.py:520-525: the one mask MLP cannot take queries of two widths
            raise ValueError("decoder.layer_scale > 1 is incompatible with the mask head")
        hd = hidden_dim
        self.num_classes, self.hidden_dim, self.num_queries = num_classes, hd, num_queries
        self.nhead, self.num_layers, self.eps = nhead, num_layers, eps
        self.eval_idx = eval_idx if eval_idx >= 0 else num_layers + eval_idx
        self.layer_scale = layer_scale
        self.extra_levels = max(0, num_levels - len(feat_channels))
        # the width of layer i and of its score and box heads
        widths = [hd * (layer_scale if i > self.eval_idx else 1) for i in range(num_layers)]
        self.reg_max, self.reg_scale, self.up = reg_max, float(reg_scale), float(up)
        self.enable_mask_head = enable_mask_head
        self.query_select_method = query_select_method
        self.num_denoising = num_denoising
        self.label_noise_ratio, self.box_noise_scale = label_noise_ratio, box_noise_scale

        self.input_proj = nn.ModuleList(
            nn.Identity() if c == hd else ConvNorm(nn.Conv2d(c, hd, 1, bias=False),
                                                   BatchNorm2d(hd))
            for c in feat_channels)
        for i in range(len(feat_channels), num_levels):  # extra levels, stride 2 each
            c = feat_channels[-1] if i == len(feat_channels) else hd
            self.input_proj.append(ConvNorm(nn.Conv2d(c, hd, 3, 2, 1, bias=False),
                                            BatchNorm2d(hd)))
        self.decoder = TransformerDecoder(hd, nhead, dim_feedforward, num_points, num_layers,
                                          reg_max, activation, self.eval_idx, layer_scale)
        if num_denoising > 0:
            self.denoising_class_embed = nn.Embedding(num_classes + 1, hd, padding_idx=num_classes)
        self.enc_output = nn.Sequential(OrderedDict(proj=nn.Linear(hd, hd), norm=LayerNorm(hd)))
        # agnostic: one objectness logit per anchor (decoder.py:444)
        self.enc_score_head = nn.Linear(hd, 1 if query_select_method == "agnostic"
                                        else num_classes)
        self.enc_bbox_head = MLP(hd, hd, 4, 3)
        self.query_pos_head = MLP(4, 2 * hd, hd, 2)
        self.pre_bbox_head = MLP(hd, hd, 4, 3)
        self.dec_score_head = nn.ModuleList(nn.Linear(d, num_classes) for d in widths)
        self.dec_bbox_head = nn.ModuleList(MLP(d, d, 4 * (reg_max + 1), 3) for d in widths)
        if enable_mask_head:
            # the FPN maps come from the encoder, wider than the decoder at size x
            self.pixel_decoder = MaskPixelDecoder(feat_channels, hd, mask_dim)
            self.mask_head = MLP(hd, hd, mask_dim, 3)
        self._const_cache: Dict[Tuple, Tuple[torch.Tensor, ...]] = {}

    def init_special_(self, generator=None):
        """The JAX package's initializers where they differ from torch's."""
        cls_bias = bias_init_with_prob(0.01)
        for proj in self.input_proj[: len(self.input_proj) - self.extra_levels]:
            if not isinstance(proj, nn.Identity):
                nn.init.xavier_uniform_(proj.conv.weight, generator=generator)
        nn.init.xavier_uniform_(self.enc_output.proj.weight, generator=generator)
        for head in [self.enc_score_head, *self.dec_score_head]:
            nn.init.constant_(head.bias, cls_bias)
        for mlp in [self.enc_bbox_head, self.pre_bbox_head, *self.dec_bbox_head]:
            nn.init.zeros_(mlp.layers[-1].weight)
            nn.init.zeros_(mlp.layers[-1].bias)
        for lin in self.query_pos_head.layers:
            nn.init.xavier_uniform_(lin.weight, generator=generator)

    def _constants(self, spatial_shapes, device):
        """(anchors, valid mask, FDR projection) for these shapes, cached."""
        key = (tuple(spatial_shapes), str(device))
        if key not in self._const_cache:
            anchors, valid = generate_anchors(spatial_shapes, eps=self.eps)
            project = weighting_function(self.reg_max, self.up, self.reg_scale)
            with torch.inference_mode(False):  # usable by autograd after serving
                self._const_cache[key] = (
                    torch.from_numpy(anchors).to(device), torch.from_numpy(valid).to(device),
                    torch.tensor(project, dtype=torch.float32, device=device))
        return self._const_cache[key]

    def _select(self, enc_logits: torch.Tensor) -> torch.Tensor:
        """The anchors that become queries [B, Q] (decoder.py:457-469):
        ``default`` by the best class score, ``one2many`` top-k over all
        (anchor, class) scores, an anchor possibly more than once,
        ``agnostic`` by the one objectness score."""
        b, s, c = enc_logits.shape
        if self.query_select_method == "one2many":
            flat = enc_logits.reshape(b, -1).topk(min(self.num_queries, s * c), dim=1).indices
            return flat // self.num_classes
        if self.query_select_method == "agnostic":
            score = enc_logits[..., 0]
        else:
            score = enc_logits.max(-1).values
        return score.topk(min(self.num_queries, s), dim=1).indices

    def _dn_mask(self, num_group, max_gt, device) -> torch.Tensor:
        key = ("dn", num_group, max_gt, str(device))
        if key not in self._const_cache:
            keep = dn_attn_mask(num_group, max_gt, self.num_queries)
            self._const_cache[key] = torch.from_numpy(keep).to(device)
        return self._const_cache[key]

    def draw_noise(self, labels: torch.Tensor,
                   generator: Optional[torch.Generator]) -> Optional[CdnNoise]:
        """The CDN draws a train-mode forward on targets with these labels
        [B, G] makes from ``generator`` when it is given none (None: this
        decoder makes no CDN queries)."""
        if self.num_denoising <= 0:
            return None
        return draw_cdn_noise(labels.shape[0], labels.shape[1], self.num_classes,
                              self.num_denoising, self.label_noise_ratio, generator,
                              device=labels.device)

    def _cdn(self, targets, dn_noise: Optional[CdnNoise], generator, dtype):
        """The CDN queries of a train step: (content [B, D, C], reference
        logits [B, D, 4], keep-mask [T, T], meta)."""
        labels, boxes, valid = targets["labels"], targets["boxes"], targets["valid"]
        if dn_noise is None:
            dn_noise = self.draw_noise(labels, generator)
        dn_cls, dn_bbox_unact, meta = build_cdn_queries(
            labels, boxes, valid, dn_noise, self.num_classes, self.num_denoising,
            self.label_noise_ratio, self.box_noise_scale)
        # the padding row contributes zeros (decoder.py:423-424)
        dn_content = torch.where((dn_cls == self.num_classes)[..., None], 0.0,
                                 self.denoising_class_embed(dn_cls)).to(dtype)
        return dn_content, dn_bbox_unact, self._dn_mask(meta.num_group, meta.max_gt,
                                                        labels.device), meta

    def forward(self, feats: List[torch.Tensor], inner_feats: List[torch.Tensor],
                targets: Optional[Dict[str, torch.Tensor]] = None,
                dn_noise: Optional[CdnNoise] = None,
                generator: Optional[torch.Generator] = None):
        """``targets`` (train mode only: labels [B, G], boxes [B, G, 4]
        cxcywh, valid [B, G]) turn on the CDN queries, whose noise is
        ``dn_noise`` or drawn from ``generator``."""
        train = self.training
        b = feats[0].shape[0]
        hd = self.hidden_dim
        proj = [p(f) for p, f in zip(self.input_proj, feats)]
        for i in range(len(feats), len(self.input_proj)):  # the extra levels
            proj.append(self.input_proj[i](feats[-1] if i == len(feats) else proj[-1]))
        spatial_shapes = tuple((int(p.shape[2]), int(p.shape[3])) for p in proj)
        memory = torch.cat([p.flatten(2).transpose(1, 2) for p in proj], 1)  # [B,S,C]
        anchors, valid, project = self._constants(spatial_shapes, memory.device)
        memory = valid.to(memory.dtype) * memory

        out_mem = self.enc_output(memory)
        enc_logits = self.enc_score_head(out_mem)
        topk_ind = self._select(enc_logits)  # [B, Q]

        def gather_q(x):
            return torch.gather(x, 1, topk_ind[..., None].expand(-1, -1, x.shape[-1]))

        topk_memory = gather_q(out_mem)
        topk_anchors = gather_q(anchors.expand(b, -1, -1))
        enc_bbox_unact = self.enc_bbox_head(topk_memory) + topk_anchors
        ref_unact = enc_bbox_unact.detach()
        output = topk_memory.detach()

        attn_mask = dn_meta = None
        if train and self.num_denoising > 0 and targets is not None:
            if memory.shape[1] < self.num_queries:
                raise ValueError(f"training canvas too small: {memory.shape[1]} anchors < "
                                 f"{self.num_queries} queries")
            dn_content, dn_unact, attn_mask, dn_meta = self._cdn(targets, dn_noise, generator,
                                                                 output.dtype)
            ref_unact = torch.cat([dn_unact.to(ref_unact.dtype), ref_unact], 1)
            output = torch.cat([dn_content, output], 1)

        value = memory.reshape(b, memory.shape[1], self.nhead, hd // self.nhead)
        num_run = self.num_layers if train else self.eval_idx + 1
        ls = self.layer_scale
        if ls > 1 and num_run > self.eval_idx + 1:  # the wide value view, built once
            value_wide = chan_repeat(memory, ls).reshape(b, memory.shape[1], self.nhead,
                                                         hd * ls // self.nhead)
        output_detach = torch.zeros_like(output)
        pred_corners_undetach = 0.0
        ref_points_detach = torch.sigmoid(ref_unact)
        ref_points_initial = pre_scores = pre_bboxes = None
        dtype = output.dtype
        dec_logits, dec_boxes, dec_corners, dec_refs, dec_hs = [], [], [], [], []
        for i in range(num_run):
            wide = ls > 1 and i > self.eval_idx
            if wide and i == self.eval_idx + 1:  # into the wide tail (decoder.py:562-566)
                output = chan_repeat(output, ls)
                output_detach = output.detach()
            query_pos = self.query_pos_head(ref_points_detach.to(dtype)).clamp(-10, 10)
            if wide:
                query_pos = chan_repeat(query_pos, ls)
            output = self.decoder.layers[i](output, ref_points_detach,
                                            value_wide if wide else value, spatial_shapes,
                                            query_pos, attn_mask)
            if i == 0:
                pre_unact = self.pre_bbox_head(output) + inverse_sigmoid(ref_points_detach)
                pre_bboxes = torch.sigmoid(pre_unact)
                ref_points_initial = pre_bboxes.detach()
                pre_scores = self.dec_score_head[0](output)
            pred_corners = self.dec_bbox_head[i](output + output_detach) + pred_corners_undetach
            inter_ref_bbox = distance2bbox(ref_points_initial,
                                           integral(pred_corners, project, self.reg_max),
                                           self.reg_scale)
            if train or i == self.eval_idx:
                scores = pre_scores if i == 0 else self.dec_score_head[i](output)
                dec_logits.append(self.decoder.lqe_layers[i](scores, pred_corners))
                dec_boxes.append(inter_ref_bbox)
                dec_corners.append(pred_corners)
                dec_refs.append(ref_points_initial)
                dec_hs.append(output)
            pred_corners_undetach = pred_corners
            ref_points_detach = inter_ref_bbox.detach()
            output_detach = output.detach()

        mask_feat = embeds = None
        if self.enable_mask_head:
            h0, w0 = spatial_shapes[0]
            # NCHW-contiguous, as the encoder hands its maps on: on the card a
            # conv keeps a channels-last input's layout, which the train-mode
            # BatchNorm after it does not take
            mem0 = memory[:, : h0 * w0].transpose(1, 2).reshape(b, hd, h0, w0).contiguous()
            mask_feat = self.pixel_decoder(inner_feats, mem0)  # [B, C, Hm, Wm]
            embeds = [self.mask_head(h) for h in dec_hs]  # row-wise: DN and matching alike
        if not train:
            out = {"pred_logits": dec_logits[-1], "pred_boxes": dec_boxes[-1]}
            if self.enable_mask_head:
                masks = torch.einsum("bqc,bchw->bqhw", embeds[-1], mask_feat)
                out["pred_masks"] = torch.sigmoid(masks)
            return out

        d = dn_meta.num_denoising if dn_meta is not None else 0

        def sets(part):
            out_ = [{"pred_logits": lg[:, part], "pred_boxes": bx[:, part],
                     "pred_corners": cr[:, part], "ref_points": rf[:, part]}
                    for lg, bx, cr, rf in zip(dec_logits, dec_boxes, dec_corners, dec_refs)]
            for s_, e in zip(out_, embeds or ()):
                s_["mask_embed"] = e[:, part]
            return out_

        main = sets(slice(d, None))
        out = dict(main[-1])
        if mask_feat is not None:
            out["mask_feat"] = mask_feat
        out["aux_outputs"] = main[:-1]
        out["enc_aux_outputs"] = [{"pred_logits": gather_q(enc_logits),
                                   "pred_boxes": torch.sigmoid(enc_bbox_unact)}]
        out["pre_outputs"] = {"pred_logits": pre_scores[:, d:], "pred_boxes": pre_bboxes[:, d:]}
        out["enc_meta"] = {"class_agnostic": self.query_select_method == "agnostic"}
        if dn_meta is not None:
            out["dn_outputs"] = sets(slice(0, d))
            out["dn_pre_outputs"] = {"pred_logits": pre_scores[:, :d],
                                     "pred_boxes": pre_bboxes[:, :d]}
            out["dn_meta"] = {"dn_num_group": dn_meta.num_group,
                              "dn_num_split": (dn_meta.num_denoising, self.num_queries),
                              "max_gt": dn_meta.max_gt}
        return out
