"""HybridEncoder: AIFI self-attention over the stride-32 map, then top-down
FPN and bottom-up PAN (port of ``dfine_tpu/models/hybrid_encoder.py``).
Returns ``(outs, inner_outs)``; the FPN maps feed the mask pixel decoder."""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import (ConvBNA, ConvNorm, LayerNorm, MultiHeadSelfAttention, RepNCSPELAN4, SCDown,
                     BatchNorm2d, get_activation)


def sincos_pos_embed_2d(w: int, h: int, embed_dim: int, temperature: float = 10000.0) -> np.ndarray:
    """2D sincos embedding [1, w*h, C] with the reference's w-major flatten
    (meshgrid ``indexing='ij'`` over (w, h)), kept for checkpoint parity."""
    assert embed_dim % 4 == 0
    grid_w, grid_h = np.meshgrid(
        np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32), indexing="ij")
    pos_dim = embed_dim // 4
    omega = np.arange(pos_dim, dtype=np.float32) / pos_dim
    omega = 1.0 / (temperature**omega)
    out_w = grid_w.reshape(-1)[:, None] * omega[None]
    out_h = grid_h.reshape(-1)[:, None] * omega[None]
    return np.concatenate(
        [np.sin(out_w), np.cos(out_w), np.sin(out_h), np.cos(out_h)], axis=1
    )[None].astype(np.float32)


class AIFILayer(nn.Module):
    """Post-norm transformer encoder layer."""

    def __init__(self, d_model, nhead, dim_feedforward, act="gelu"):
        super().__init__()
        self.self_attn = MultiHeadSelfAttention(d_model, nhead)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)
        self.act = get_activation(act)

    def forward(self, src, pos_embed):
        q = src + pos_embed.to(src.dtype)
        src = self.norm1(src + self.self_attn(q, q, src))
        return self.norm2(src + self.linear2(self.act(self.linear1(src))))


class TransformerEncoder(nn.Module):
    def __init__(self, num_layers, *layer_args):
        super().__init__()
        self.layers = nn.ModuleList(AIFILayer(*layer_args) for _ in range(num_layers))

    def forward(self, src, pos_embed):
        for layer in self.layers:
            src = layer(src, pos_embed)
        return src


class HybridEncoder(nn.Module):
    def __init__(self, in_channels: Sequence[int] = (512, 1024, 2048),
                 feat_strides: Sequence[int] = (8, 16, 32), hidden_dim: int = 256,
                 nhead: int = 8, dim_feedforward: int = 1024, enc_act: str = "gelu",
                 use_encoder_idx: Sequence[int] = (2,), num_encoder_layers: int = 1,
                 pe_temperature: float = 10000.0, expansion: float = 1.0,
                 depth_mult: float = 1.0, act: str = "silu"):
        super().__init__()
        hd = hidden_dim
        nlev = len(in_channels)
        c4 = round(expansion * hd // 2)
        n_csp = round(3 * depth_mult)
        self.hidden_dim = hd
        self.use_encoder_idx = tuple(use_encoder_idx)
        self.pe_temperature = pe_temperature
        self.input_proj = nn.ModuleList(
            ConvNorm(nn.Conv2d(c, hd, 1, bias=False), BatchNorm2d(hd))
            for c in in_channels
        )
        self.encoder = nn.ModuleList(
            TransformerEncoder(num_encoder_layers, hd, nhead, dim_feedforward, enc_act)
            for _ in self.use_encoder_idx
        )
        self.lateral_convs = nn.ModuleList(ConvBNA(hd, hd, 1, 1) for _ in range(nlev - 1))
        self.fpn_blocks = nn.ModuleList(
            RepNCSPELAN4(2 * hd, hd, 2 * hd, c4, n_csp, act) for _ in range(nlev - 1))
        self.downsample_convs = nn.ModuleList(
            nn.Sequential(SCDown(hd, hd, 3, 2)) for _ in range(nlev - 1))
        self.pan_blocks = nn.ModuleList(
            RepNCSPELAN4(2 * hd, hd, 2 * hd, c4, n_csp, act) for _ in range(nlev - 1))
        self._pos_cache: Dict[Tuple, torch.Tensor] = {}

    def _pos_embed(self, w, h, device) -> torch.Tensor:
        key = (w, h, str(device))
        if key not in self._pos_cache:
            pe = sincos_pos_embed_2d(w, h, self.hidden_dim, self.pe_temperature)
            with torch.inference_mode(False):  # usable by autograd after serving
                self._pos_cache[key] = torch.from_numpy(pe).to(device)
        return self._pos_cache[key]

    def forward(self, feats: List[torch.Tensor]) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        proj = [p(f) for p, f in zip(self.input_proj, feats)]
        for enc, idx in zip(self.encoder, self.use_encoder_idx):
            b, c, h, w = proj[idx].shape
            src = proj[idx].flatten(2).transpose(1, 2)  # [B, h*w, C]
            src = enc(src, self._pos_embed(w, h, src.device))
            proj[idx] = src.transpose(1, 2).reshape(b, c, h, w).contiguous()

        nlev = len(proj)
        inner_outs = [proj[-1]]
        for idx in range(nlev - 1, 0, -1):
            k = nlev - 1 - idx
            feat_high = self.lateral_convs[k](inner_outs[0])
            inner_outs[0] = feat_high
            up = F.interpolate(feat_high, scale_factor=2.0, mode="nearest")
            inner_outs.insert(0, self.fpn_blocks[k](torch.cat([up, proj[idx - 1]], 1)))

        outs = [inner_outs[0]]
        for idx in range(nlev - 1):
            down = self.downsample_convs[idx](outs[-1])
            outs.append(self.pan_blocks[idx](torch.cat([down, inner_outs[idx + 1]], 1)))
        return outs, inner_outs
