"""Optimizer, learning-rate schedule and EMA (port of
``dfine_tpu/train/optim.py``).

- Four parameter groups (reference src/d_fine/dfine.py:87-124): backbone,
  backbone norms (no weight decay), encoder/decoder norms and biases (no
  weight decay), the rest. A parameter's group is decided on its JAX path,
  found through the weight bridge's name map, so both frameworks group
  alike.
- ``onecycle``: the formula of ``optax.cosine_onecycle_schedule``, copied,
  with the guard of at least one warm-up step.
- ``Optimizer``: global-norm clip in optax's form, ``g * c / max(norm, c)``,
  then ``torch.optim.AdamW`` over the groups, the learning rate set from
  the schedule before every step. The l/x per-group peaks are not ported.
- EMA with the warm-up momentum ``m * (1 - exp(-it / 2000))`` over the
  parameters and the BatchNorm statistics.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Tuple

import torch
import torch.nn as nn

from ..utils.checkpoint import flax_key

GROUPS = ("backbone", "backbone_norm", "encdec_norm_bias", "rest")


@dataclass(frozen=True)
class OptimConfig:
    base_lr: float = 2.5e-4
    betas: Tuple[float, float] = (0.9, 0.999)
    weight_decay: float = 1.25e-4
    clip_max_norm: float = 0.1
    epochs: int = 100
    steps_per_epoch: int = 100
    pct_start: float = 0.1


def param_group_label(name: str, ndim: int) -> str:
    """The group of the port parameter ``name`` (reference key layout),
    decided on its JAX path as ``dfine_tpu/train/optim.py:44-52`` does."""
    path = flax_key(name, ndim)[0].split("/")[1:]  # drop "params"
    joined = "/".join(path).lower()
    is_norm = any(t in joined for t in ("bn", "norm", "batchnorm", "layernorm"))
    if joined.startswith("backbone"):
        return "backbone_norm" if is_norm else "backbone"
    if joined.startswith(("encoder", "decoder")) and (is_norm or path[-1] == "bias"):
        return "encdec_norm_bias"
    return "rest"


def onecycle(peak: float, cfg: OptimConfig) -> Callable[[int], float]:
    """``optax.cosine_onecycle_schedule(total, peak, pct, 25, 1e4)``: cosine
    from peak/25 up to peak over the first ``int(pct * total)`` steps, then
    down to peak/25/1e4 at ``total``, constant after."""
    total = max(2, cfg.epochs * max(1, cfg.steps_per_epoch))
    pct = min(max(cfg.pct_start, 1.0 / total), 1.0 - 1.0 / total)  # >= 1 warm-up step
    div, final_div = 25.0, 1e4
    bounds = (0, int(pct * total), int(total))
    v0 = peak / div
    values = (v0, v0 * div, v0 * div * (1.0 / (div * final_div)))  # optax's cumprod

    def schedule(count: int) -> float:
        for i in range(2):
            if bounds[i] <= count < bounds[i + 1]:
                frac = (count - bounds[i]) / (bounds[i + 1] - bounds[i])
                start, end = values[i], values[i + 1]
                return end + (start - end) / 2.0 * (math.cos(math.pi * frac) + 1)
        return values[2]

    return schedule


class Optimizer:
    """Clip by global norm, then AdamW over the four groups, all on one
    schedule (n/s/m: torch OneCycleLR's scalar ``max_lr = 2 * base_lr``
    overrides every group); ``count`` optimizer steps taken so far."""

    def __init__(self, model: nn.Module, cfg: OptimConfig):
        groups: Dict[str, List[nn.Parameter]] = {g: [] for g in GROUPS}
        for name, p in model.named_parameters():
            if p.requires_grad:
                groups[param_group_label(name, p.dim())].append(p)
        self.schedule = onecycle(2 * cfg.base_lr, cfg)
        wd = {"backbone": cfg.weight_decay, "backbone_norm": 0.0, "encdec_norm_bias": 0.0,
              "rest": cfg.weight_decay}
        self.adamw = torch.optim.AdamW(
            [{"params": groups[g], "weight_decay": wd[g], "lr": self.schedule(0)}
             for g in GROUPS if groups[g]], betas=cfg.betas, eps=1e-8)
        self.params = [p for g in GROUPS for p in groups[g]]
        self.clip = cfg.clip_max_norm
        self.count = 0

    def step(self) -> torch.Tensor:
        """Clip the gradients and step; returns their global norm before the
        clip. A parameter without a gradient counts as a zero gradient."""
        grads = [p.grad for p in self.params if p.grad is not None]
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        torch._foreach_mul_(grads, self.clip / torch.maximum(norm, torch.tensor(
            self.clip, device=norm.device)))
        for group in self.adamw.param_groups:
            group["lr"] = self.schedule(self.count)
        self.adamw.step()
        self.count += 1
        return norm

    def zero_grad(self) -> None:
        self.adamw.zero_grad(set_to_none=True)


def build_optimizer(model: nn.Module, cfg: OptimConfig) -> Optimizer:
    return Optimizer(model, cfg)


EMA_BASE = 0.9999


def ema_momentum(iteration: int) -> float:
    """Warm-up EMA momentum (reference src/dl/train.py:59)."""
    return EMA_BASE * (1.0 - math.exp(-float(iteration) / 2000.0))


@torch.no_grad()
def ema_update(ema: nn.Module, model: nn.Module, iteration: int) -> None:
    """ema = ema * m + (1 - m) * model over every floating parameter and
    buffer; other buffers (BatchNorm's batch counter) are copied."""
    m = ema_momentum(iteration)
    src = dict(model.named_parameters())
    src.update(model.named_buffers())
    dst = dict(ema.named_parameters())
    dst.update(ema.named_buffers())
    floats = [k for k, t in dst.items() if t.is_floating_point()]
    e = [dst[k] for k in floats]
    torch._foreach_mul_(e, m)
    torch._foreach_add_(e, [src[k].to(dst[k].dtype) for k in floats], alpha=1.0 - m)
    for k, t in dst.items():
        if not t.is_floating_point():
            t.copy_(src[k])
