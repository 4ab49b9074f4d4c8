"""Model-size registry (n/s/m/l/x) for D-FINE det+seg.

Own copy of the JAX package's registry (the port imports nothing of it).
Architectural constants match the reference registry
(reference: src/d_fine/configs.py:1-213) — they define the published
D-FINE variants and are required for checkpoint parity.  Structure is
flattened relative to the reference: one dict per size with explicit
sub-dicts for backbone / encoder / decoder / loss / matcher.
"""

from __future__ import annotations

import copy
from typing import Any, Dict

BASE: Dict[str, Any] = {
    "backbone": {"freeze_stem_only": True},
    "encoder": {
        "num_encoder_layers": 1,
        "nhead": 8,
        "enc_act": "gelu",
        "act": "silu",
    },
    "decoder": {
        "eval_idx": -1,
        "num_queries": 300,
        "num_denoising": 100,
        "label_noise_ratio": 0.5,
        "box_noise_scale": 1.0,
        "reg_max": 32,
        "query_select_method": "default",
        # widen post-eval_idx decoder layers (reference dfine_decoder.py:574,
        # 684, 693); 1 = off for every shipped size, matching the reference
        "layer_scale": 1,
    },
    "criterion": {
        "weight_dict": {
            "loss_vfl": 1.0,
            "loss_bbox": 5.0,
            "loss_giou": 2.0,
            "loss_fgl": 0.15,
            "loss_ddf": 1.5,
            "loss_mask_bce": 10.0,
            "loss_mask_dice": 10.0,
        },
        "losses": ["vfl", "boxes", "local"],
        "alpha": 0.75,
        "gamma": 2.0,
        "reg_max": 32,
    },
    "matcher": {
        "cost_class": 2.0,
        "cost_bbox": 5.0,
        "cost_giou": 2.0,
        "alpha": 0.25,
        "gamma": 2.0,
        "use_focal_loss": True,
    },
}

SIZES: Dict[str, Any] = {
    "n": {
        "backbone": {"name": "B0", "return_idx": [2, 3], "freeze_at": -1,
                     "freeze_norm": False, "use_lab": True},
        "encoder": {"in_channels": [512, 1024], "feat_strides": [16, 32],
                    "hidden_dim": 128, "use_encoder_idx": [1],
                    "dim_feedforward": 512, "expansion": 0.34, "depth_mult": 0.5},
        "decoder": {"feat_channels": [128, 128], "feat_strides": [16, 32],
                    "hidden_dim": 128, "num_levels": 2, "num_layers": 3,
                    "reg_scale": 4, "num_points": [6, 6], "dim_feedforward": 512,
                    "mask_dim": 256},
    },
    "s": {
        "backbone": {"name": "B0", "return_idx": [1, 2, 3], "freeze_at": -1,
                     "freeze_norm": False, "use_lab": True},
        "encoder": {"in_channels": [256, 512, 1024], "feat_strides": [8, 16, 32],
                    "hidden_dim": 256, "use_encoder_idx": [2],
                    "dim_feedforward": 1024, "expansion": 0.5, "depth_mult": 0.34},
        "decoder": {"feat_channels": [256, 256, 256], "feat_strides": [8, 16, 32],
                    "hidden_dim": 256, "num_levels": 3, "num_layers": 3,
                    "reg_scale": 4, "num_points": [3, 6, 3],
                    "dim_feedforward": 1024, "mask_dim": 256},
    },
    "m": {
        "backbone": {"name": "B2", "return_idx": [1, 2, 3], "freeze_at": -1,
                     "freeze_norm": False, "use_lab": True},
        "encoder": {"in_channels": [384, 768, 1536], "feat_strides": [8, 16, 32],
                    "hidden_dim": 256, "use_encoder_idx": [2],
                    "dim_feedforward": 1024, "expansion": 1.0, "depth_mult": 0.67},
        "decoder": {"feat_channels": [256, 256, 256], "feat_strides": [8, 16, 32],
                    "hidden_dim": 256, "num_levels": 3, "num_layers": 4,
                    "reg_scale": 4, "num_points": [3, 6, 3],
                    "dim_feedforward": 1024, "mask_dim": 256},
    },
    "l": {
        "backbone": {"name": "B4", "return_idx": [1, 2, 3], "freeze_at": 0,
                     "freeze_norm": True, "use_lab": False},
        "encoder": {"in_channels": [512, 1024, 2048], "feat_strides": [8, 16, 32],
                    "hidden_dim": 256, "use_encoder_idx": [2],
                    "dim_feedforward": 1024, "expansion": 1.0, "depth_mult": 1.0},
        "decoder": {"feat_channels": [256, 256, 256], "feat_strides": [8, 16, 32],
                    "hidden_dim": 256, "num_levels": 3, "num_layers": 6,
                    "reg_scale": 4, "num_points": [3, 6, 3],
                    "dim_feedforward": 1024, "mask_dim": 256},
    },
    "x": {
        "backbone": {"name": "B5", "return_idx": [1, 2, 3], "freeze_at": 0,
                     "freeze_norm": True, "use_lab": False},
        "encoder": {"in_channels": [512, 1024, 2048], "feat_strides": [8, 16, 32],
                    "hidden_dim": 384, "use_encoder_idx": [2],
                    "dim_feedforward": 2048, "expansion": 1.0, "depth_mult": 1.0},
        "decoder": {"feat_channels": [384, 384, 384], "feat_strides": [8, 16, 32],
                    "hidden_dim": 256, "num_levels": 3, "num_layers": 6,
                    "reg_scale": 8, "num_points": [3, 6, 3],
                    "dim_feedforward": 1024, "mask_dim": 256},
    },
}


def _merge(base: dict, extra: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in extra.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = _merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def model_config(size: str) -> Dict[str, Any]:
    if size not in SIZES:
        raise KeyError(f"unknown model size {size!r}; choose from {sorted(SIZES)}")
    return _merge(BASE, SIZES[size])
