"""The D-FINE model of a benchmark configuration: backbone -> encoder ->
decoder, built from the configuration's own file (``perfbench/configs``).
A frozen copy of the program's ``models/dfine.py`` in fp32, with nothing
of the program imported."""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn as nn

from .decoder import DFINETransformer
from .denoising import CdnNoise
from .hgnetv2 import HGNetv2
from .hybrid_encoder import HybridEncoder


class DFINE(nn.Module):
    """Input [B, 3, H, W] NCHW, float in [0, 1] or uint8 (normalized here).
    Output ``pred_logits [B,Q,C]``, ``pred_boxes [B,Q,4]`` (cxcywh,
    normalized) and, with the mask head, ``pred_masks [B,Q,Hm,Wm]``
    (probabilities)."""

    def __init__(self, cfg: Dict[str, Any]):
        super().__init__()
        bcfg, ecfg, dcfg = cfg["backbone"], cfg["encoder"], cfg["decoder"]
        num_classes, enable_mask_head = cfg["num_classes"], cfg["mask_head"]
        self.backbone = HGNetv2(bcfg["name"], bcfg["use_lab"], bcfg["return_idx"])
        self.encoder = HybridEncoder(
            in_channels=ecfg["in_channels"], feat_strides=ecfg["feat_strides"],
            hidden_dim=ecfg["hidden_dim"], nhead=ecfg["nhead"],
            dim_feedforward=ecfg["dim_feedforward"], enc_act=ecfg["enc_act"],
            use_encoder_idx=ecfg["use_encoder_idx"],
            num_encoder_layers=ecfg["num_encoder_layers"], expansion=ecfg["expansion"],
            depth_mult=ecfg["depth_mult"], act=ecfg["act"])
        self.decoder = DFINETransformer(
            num_classes=num_classes, hidden_dim=dcfg["hidden_dim"],
            num_queries=dcfg["num_queries"], feat_channels=dcfg["feat_channels"],
            num_levels=dcfg["num_levels"], num_points=dcfg["num_points"],
            nhead=ecfg["nhead"], num_layers=dcfg["num_layers"],
            dim_feedforward=dcfg["dim_feedforward"], num_denoising=dcfg["num_denoising"],
            eval_idx=dcfg["eval_idx"], query_select_method=dcfg["query_select_method"],
            reg_max=dcfg["reg_max"], reg_scale=dcfg["reg_scale"],
            enable_mask_head=enable_mask_head, mask_dim=dcfg["mask_dim"],
            layer_scale=dcfg.get("layer_scale", 1), label_noise_ratio=dcfg["label_noise_ratio"],
            box_noise_scale=dcfg["box_noise_scale"])

    def forward(self, x: torch.Tensor, targets: Optional[Dict[str, torch.Tensor]] = None,
                dn_noise: Optional[CdnNoise] = None,
                generator: Optional[torch.Generator] = None):
        """Eval mode: the serving outputs. Train mode (``model.train()``):
        the criterion's sets (see ``DFINETransformer``); with ``targets``
        (labels [B, G], boxes [B, G, 4] cxcywh, valid [B, G]) also the CDN
        queries, their noise given as ``dn_noise`` or drawn from
        ``generator``."""
        if not x.is_floating_point():  # uint8 frames
            x = x.float() / 255.0
        feats = self.backbone(x.float())
        outs, inner_outs = self.encoder(feats)
        return self.decoder(outs, inner_outs, targets, dn_noise, generator)


def build(cfg: Dict[str, Any], device) -> DFINE:
    """The configuration's model on ``device`` in fp32, eval mode. Its
    weights are whatever the caller loads into it."""
    with torch.device(device):
        return DFINE(cfg).eval()
