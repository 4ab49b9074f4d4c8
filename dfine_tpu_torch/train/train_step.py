"""The train step (port of ``dfine_tpu/train/train_step.py``).

``make_train_step`` returns ``step(state, batch, generator=None,
dn_noise=None) -> (state, metrics)``: forward in train mode with the CDN
queries, the criterion (matching on the host), backward, clip + AdamW, and
the EMA update. Unlike the JAX step it updates in place: the model's
parameters and BatchNorm statistics, the optimizer's moments and the EMA
copy live in ``TrainState`` and change under it.

Mixed precision is what flax's ``dtype=bf16`` does: fp32 parameters, bf16
compute under ``torch.autocast``, the norms and softmaxes in fp32 (the
model's norm modules and the criterion cast up), and the backward and the
optimizer outside autocast. Gradient accumulation, freeze masks and data
parallelism are not ported yet and raise.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch
import torch.nn as nn

from ..models.denoising import CdnNoise
from .criterion import CriterionConfig, criterion_forward
from .optim import Optimizer, ema_update

METRIC_TERMS = ("loss_vfl", "loss_bbox", "loss_giou", "loss_fgl", "loss_ddf",
                "loss_mask_bce", "loss_mask_dice")


@dataclass
class TrainState:
    step: int
    model: nn.Module
    optimizer: Optimizer
    ema: nn.Module  # a copy of the model: EMA of parameters and buffers

    @classmethod
    def create(cls, model: nn.Module, optimizer: Optimizer):
        ema = copy.deepcopy(model).eval().requires_grad_(False)
        return cls(step=0, model=model.train(), optimizer=optimizer, ema=ema)


def make_train_step(crit_cfg: CriterionConfig, compute_dtype: torch.dtype = torch.bfloat16,
                    axis_name: Optional[str] = None, update_mask: Any = None,
                    b_accum_steps: int = 1):
    """The step function. ``compute_dtype`` bf16 runs the forward under
    autocast; float32 runs it in full precision."""
    if axis_name is not None:
        raise NotImplementedError("data parallelism (axis_name) is not ported yet")
    if update_mask is not None:
        raise NotImplementedError("freeze masks (update_mask) are not ported yet")
    if b_accum_steps > 1:
        raise NotImplementedError("gradient accumulation (b_accum_steps > 1) is not ported yet")

    def step(state: TrainState, batch: Dict[str, Any],
             generator: Optional[torch.Generator] = None,
             dn_noise: Optional[CdnNoise] = None):
        """``batch``: images [B, 3, H, W] and targets {labels [B, G], boxes
        [B, G, 4] cxcywh, valid [B, G]} on the model's device. The CDN noise
        is ``dn_noise`` or drawn from ``generator``."""
        model, opt = state.model, state.optimizer
        model.train()
        opt.zero_grad()
        dev = batch["images"].device
        with torch.autocast(dev.type, dtype=compute_dtype,
                            enabled=compute_dtype != torch.float32):
            out = model(batch["images"], batch["targets"], dn_noise, generator)
        losses = criterion_forward(out, batch["targets"], crit_cfg)
        losses["total"].backward()
        grad_norm = opt.step()
        state.step += 1
        ema_update(state.ema, model, state.step)
        metrics = {"loss": losses["total"].detach(), "grad_norm": grad_norm.detach()}
        metrics.update({k: v.detach() for k, v in losses.items()
                        if "_" not in k or k in METRIC_TERMS})
        return state, metrics

    return step


def make_eval_step():
    """Inference with the EMA model, as the JAX package evaluates."""
    @torch.no_grad()
    def step(state: TrainState, images: torch.Tensor):
        return state.ema.eval()(images)

    return step
