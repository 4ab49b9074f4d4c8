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
optimizer outside autocast. The JAX step's options: ``update_mask``
(``optim.freeze_mask``; a frozen parameter takes ``requires_grad_(False)``,
so it has no gradient, is outside the clip's norm and ``grad_norm``, and
takes no update and no weight decay, while its BatchNorm still updates its
statistics), ``ema_base``, and gradient accumulation, which the step reads
from its optimizer (``OptimConfig.b_accum_steps``: it steps on the mean of
k micro-steps, and the EMA follows only the optimizer steps). Data
parallelism (``axis_name``) is not ported and raises.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch
import torch.nn as nn

from ..models.denoising import CdnNoise
from .criterion import CriterionConfig, criterion_forward
from .optim import EMA_BASE, Optimizer, ema_update

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
                    axis_name: Optional[str] = None, ema_base: float = EMA_BASE,
                    update_mask: Optional[Dict[str, bool]] = None):
    """The step function. ``compute_dtype`` bf16 runs the forward under
    autocast; float32 runs it in full precision. ``update_mask``: {parameter
    name: trainable}, as ``optim.freeze_mask`` gives it. The number of
    micro-steps an optimizer step takes is the optimizer's own."""
    if axis_name is not None:
        raise NotImplementedError("data parallelism (axis_name) is not ported yet")
    frozen = [name for name, keep in (update_mask or {}).items() if not keep]

    def step(state: TrainState, batch: Dict[str, Any],
             generator: Optional[torch.Generator] = None,
             dn_noise: Optional[CdnNoise] = None):
        """``batch``: images [B, 3, H, W] and targets {labels [B, G], boxes
        [B, G, 4] cxcywh, valid [B, G] and, for the ``masks`` loss, masks
        [B, G, Hm, Wm] and mask_valid [B, G]} on the model's device. The CDN
        noise is ``dn_noise`` or drawn from ``generator``."""
        model, opt = state.model, state.optimizer
        for name in frozen:
            model.get_parameter(name).requires_grad_(False)
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
        if opt.mini_step == 0:  # an optimizer step: its count drives the warm-up
            ema_update(state.ema, model, opt.count, ema_base)
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
