"""DFINE: backbone -> encoder -> decoder (port of ``dfine_tpu/models/dfine.py``),
and ``build_model``."""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn

from ..configs import model_config
from ..device import resolve_device
from ..ops.kernels import check_kernel_limits
from .decoder import DFINETransformer
from .denoising import CdnNoise
from .hgnetv2 import HGNetv2
from .hybrid_encoder import HybridEncoder
from .layers import FP32_MODULES, LearnableAffine, MultiHeadSelfAttention


class DFINE(nn.Module):
    """Input [B, 3, H, W] NCHW, float in [0, 1] or uint8 (normalized here).
    Output ``pred_logits [B,Q,C]``, ``pred_boxes [B,Q,4]`` (cxcywh,
    normalized) and, with the mask head, ``pred_masks [B,Q,Hm,Wm]``
    (probabilities)."""

    def __init__(self, size: str = "m", num_classes: int = 80, enable_mask_head: bool = False,
                 cfg_overrides: Sequence[Tuple[str, Any]] = ()):
        super().__init__()
        cfg = model_config(size, cfg_overrides)
        bcfg, ecfg, dcfg = cfg["backbone"], cfg["encoder"], cfg["decoder"]
        self.size = size
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

    @property
    def dtype(self) -> torch.dtype:
        return self.backbone.stem.stem1.conv.weight.dtype

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
        feats = self.backbone(x.to(self.dtype))
        outs, inner_outs = self.encoder(feats)
        return self.decoder(outs, inner_outs, targets, dn_noise, generator)


@torch.no_grad()
def reset_parameters(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Initialize every parameter and buffer from ``generator``: torch's
    defaults (uniform +-1/sqrt(fan_in) for weights and biases), xavier
    in-projections, unit norms, then the JAX package's special initializers
    (``init_special_``) where a module has them."""
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            fan_in, _ = nn.init._calculate_fan_in_and_fan_out(m.weight)
            bound = 1.0 / math.sqrt(fan_in)
            m.weight.uniform_(-bound, bound, generator=generator)
            if m.bias is not None:
                m.bias.uniform_(-bound, bound, generator=generator)
        elif isinstance(m, nn.Embedding):
            m.weight.normal_(generator=generator)
            if m.padding_idx is not None:
                m.weight[m.padding_idx].zero_()
        elif isinstance(m, (nn.BatchNorm2d, nn.LayerNorm)):
            m.reset_parameters()
        elif isinstance(m, LearnableAffine):
            m.scale.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, MultiHeadSelfAttention):
            nn.init.xavier_uniform_(m.in_proj_weight, generator=generator)
            m.in_proj_bias.zero_()
    for m in model.modules():
        if isinstance(m, MultiHeadSelfAttention):
            m.out_proj.bias.zero_()
        if hasattr(m, "init_special_"):
            m.init_special_(generator)
    return model


def set_compute_dtype(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast the parameters to ``dtype``, except those of the fp32 norms."""
    for m in model.modules():
        if not isinstance(m, FP32_MODULES):
            for p in m.parameters(recurse=False):
                p.data = p.data.to(dtype)
    return model


def build_model(size: str, num_classes: int, enable_mask_head: bool = False,
                dtype: torch.dtype = torch.float32,
                device: Optional[Union[str, torch.device]] = None,
                cfg_overrides: Sequence[Tuple[str, Any]] = ()) -> DFINE:
    """An eval-mode DFINE of ``size`` with weights drawn from a generator
    seeded with 0, on ``device`` (default: the card; raises without CUDA).
    ``dtype`` casts the parameters, for serving; training keeps fp32
    parameters and computes in bf16 under autocast (``train.train_step``).
    ``cfg_overrides``: (("section.key", value), ...) patched over the size's
    configuration, e.g. (("decoder.query_select_method", "agnostic"),). On a
    CUDA device a configuration beyond the kernels' limits raises here
    (``check_kernel_limits``)."""
    dev = resolve_device(device)
    with torch.device("meta"):
        model = DFINE(size, num_classes, enable_mask_head, cfg_overrides)
    if dev.type == "cuda":
        check_kernel_limits(model)
    model.to_empty(device="cpu")
    reset_parameters(model, torch.Generator().manual_seed(0))
    return set_compute_dtype(model, dtype).to(dev).eval()
