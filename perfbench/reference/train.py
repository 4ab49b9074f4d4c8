"""The reference train step, run from the seeded weights over the same
batches and CDN noise as the program's first steps: forward in train mode,
the criterion with the host solver, backward, the global-norm clip and
AdamW over the four groups, the EMA update; and the readings
``judge.train_numbers`` compares."""

from __future__ import annotations

import copy
from typing import Any, Dict, List

import torch

from . import precision
from .criterion import CriterionConfig, criterion_forward, default_weight_dict
from .denoising import CdnNoise
from .model import build
from .optim import Optimizer, OptimConfig, ema_update, freeze_mask


def criterion_config(cfg: Dict[str, Any]) -> CriterionConfig:
    losses = tuple(cfg["criterion"]["losses"]) + (("masks",) if cfg["mask_head"] else ())
    return CriterionConfig(num_classes=cfg["num_classes"], losses=losses,
                           weight_dict=default_weight_dict(),
                           reg_max=cfg["decoder"]["reg_max"], reg_scale=cfg["decoder"]["reg_scale"])


def optim_config(cfg: Dict[str, Any]) -> OptimConfig:
    o = dict(cfg["optim"])
    o["betas"] = tuple(o["betas"])
    return OptimConfig(**o)


def readings(cfg: Dict[str, Any], weights: Dict[str, torch.Tensor], batches: List[Dict],
             noises: List[tuple], mode: str = "fp32", device="cuda") -> Dict[str, Any]:
    """Steps 1..len(batches) of the reference from ``weights``: each
    step's loss, each leaf's first clipped gradient norm, and each leaf's
    change and its EMA copy's change after the last step."""
    model = build(cfg, device)
    model.load_state_dict(weights, strict=True)
    fz = cfg["freeze"]
    mask = freeze_mask(model, fz["backbone_norm"], fz["stem"])
    frozen = [k for k, keep in mask.items() if not keep]
    ema = copy.deepcopy(model).eval().requires_grad_(False)
    opt = Optimizer(model, optim_config(cfg))
    crit = criterion_config(cfg)
    names = {p: k for k, p in model.named_parameters()}
    beta1 = opt.adamw.defaults["betas"][0]
    losses, grad = [], {}
    for i, (batch, noise) in enumerate(zip(batches, noises)):
        for k in frozen:
            model.get_parameter(k).requires_grad_(False)
        model.train()
        opt.zero_grad()
        with precision.mode(mode, torch.device(device).type):
            out = model(batch["images"], batch["targets"], CdnNoise(*noise))
            loss = criterion_forward(out, batch["targets"], crit)["total"]
            loss.backward()
        opt.step()
        ema_update(ema, model, opt.count, cfg["ema_base"])
        losses.append(float(loss.detach()))
        if i == 0:
            grad = {names[p]: float(s["exp_avg"].norm()) / (1 - beta1)
                    for p, s in opt.adamw.state.items()}
    change = {k: float((p.detach() - weights[k]).norm()) for k, p in model.named_parameters()}
    emas = {k: float((p - weights[k]).norm()) for k, p in ema.named_parameters()}
    return {"losses": losses, "grad": grad, "change": change, "ema": emas}


@torch.no_grad()
def sampling_calls(cfg: Dict[str, Any], weights, batches, noises, device="cuda") -> list:
    """The deformable core's calls (``deform.recorded``) of a train-mode
    forward of each batch, for the byte counts."""
    from . import deform

    model = build(cfg, device)
    model.load_state_dict(weights, strict=True)
    model.train()
    deform.recorded = []
    try:
        with precision.fp32():
            for batch, noise in zip(batches, noises):
                model(batch["images"], batch["targets"], CdnNoise(*noise))
        return deform.recorded
    finally:
        deform.recorded = None
