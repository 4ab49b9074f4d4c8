"""Optimizer, learning-rate schedule, freeze masks and EMA (port of
``dfine_tpu/train/optim.py``).

- Four parameter groups (reference src/d_fine/dfine.py:87-124): backbone,
  backbone norms (no weight decay), encoder/decoder norms and biases (no
  weight decay), the rest. A parameter's group is decided on its JAX path,
  found through the weight bridge's name map, so both frameworks group
  alike; so is ``freeze_mask``.
- ``onecycle``: the formula of ``optax.cosine_onecycle_schedule``, copied,
  with the guard of at least one warm-up step, over ``epochs *
  steps_per_epoch // b_accum_steps`` optimizer steps.
- ``Optimizer``: global-norm clip in optax's form, ``g * c / max(norm, c)``,
  then ``torch.optim.AdamW`` over the groups, each group's learning rate set
  from its schedule before every step: every group on ``onecycle(2 *
  base_lr)`` (n/s/m), or with ``per_group_max_lr`` (l/x) the two backbone
  groups on ``onecycle(2 * backbone_lr)``. With ``b_accum_steps = k`` it
  steps as ``optax.MultiSteps``: on the mean of k micro-steps' gradients.
  Each group's learning rate is a 0-d fp32 tensor on the parameters' device
  that the host writes from the schedule (``write_lr``) before the update
  (on the card AdamW is the fused, ``capturable`` one: a kernel a chunk of
  parameters, the step counts on the device), so that a CUDA graph of the
  step reads the schedule's value at each replay.
- EMA with the warm-up momentum ``base * (1 - exp(-it / 2000))`` over the
  parameters and the BatchNorm statistics, read from a device tensor that
  the host writes before the update, as the learning rates.
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
    backbone_lr: float = 1.25e-4
    betas: Tuple[float, float] = (0.9, 0.999)
    weight_decay: float = 1.25e-4
    clip_max_norm: float = 0.1
    epochs: int = 100
    steps_per_epoch: int = 100
    pct_start: float = 0.1
    per_group_max_lr: bool = False  # True for model sizes l/x
    b_accum_steps: int = 1


def _jax_path(name: str, ndim: int) -> str:
    """The flax path of port parameter ``name``, without "params/"."""
    return flax_key(name, ndim)[0].split("/", 1)[1]


def param_group_label(name: str, ndim: int) -> str:
    """The group of the port parameter ``name`` (reference key layout),
    decided on its JAX path as ``dfine_tpu/train/optim.py:44-52`` does."""
    path = _jax_path(name, ndim).split("/")
    joined = "/".join(path).lower()
    is_norm = any(t in joined for t in ("bn", "norm", "batchnorm", "layernorm"))
    if joined.startswith("backbone"):
        return "backbone_norm" if is_norm else "backbone"
    if joined.startswith(("encoder", "decoder")) and (is_norm or path[-1] == "bias"):
        return "encdec_norm_bias"
    return "rest"


def freeze_mask(model: nn.Module, freeze_backbone_norm: bool = False,
                freeze_stem: bool = False) -> Dict[str, bool]:
    """{parameter name: trainable} for FrozenBatchNorm / freeze_at
    (``dfine_tpu/train/optim.py:138-152``), decided on each parameter's JAX
    path: the backbone's norms, and everything of the backbone's stem."""

    def frozen(path: str) -> bool:
        j = path.lower()
        if freeze_backbone_norm and j.startswith("backbone") and ("bn" in j or "norm" in j):
            return True
        return freeze_stem and j.startswith("backbone/stem")

    return {name: not frozen(_jax_path(name, p.dim())) for name, p in model.named_parameters()}


def onecycle(peak: float, cfg: OptimConfig) -> Callable[[int], float]:
    """``optax.cosine_onecycle_schedule(total, peak, pct, 25, 1e4)``: cosine
    from peak/25 up to peak over the first ``int(pct * total)`` steps, then
    down to peak/25/1e4 at ``total``, constant after."""
    total = max(2, cfg.epochs * max(1, cfg.steps_per_epoch) // max(1, cfg.b_accum_steps))
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


def _global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))


class Optimizer:
    """Clip by global norm, then AdamW over the four groups. The schedules:
    n/s/m, torch OneCycleLR's scalar ``max_lr = 2 * base_lr`` overrides
    every group; l/x (``per_group_max_lr``), the backbone groups peak at
    ``2 * backbone_lr``. ``count``: optimizer steps taken so far;
    ``mini_step``: micro-steps into the current one (0 after a step)."""

    def __init__(self, model: nn.Module, cfg: OptimConfig):
        groups: Dict[str, List[nn.Parameter]] = {g: [] for g in GROUPS}
        for name, p in model.named_parameters():
            if p.requires_grad:
                groups[param_group_label(name, p.dim())].append(p)
        base = onecycle(2 * cfg.base_lr, cfg)
        backbone = onecycle(2 * cfg.backbone_lr, cfg) if cfg.per_group_max_lr else base
        self.schedules = {"backbone": backbone, "backbone_norm": backbone,
                          "encdec_norm_bias": base, "rest": base}
        wd = {"backbone": cfg.weight_decay, "backbone_norm": 0.0, "encdec_norm_bias": 0.0,
              "rest": cfg.weight_decay}
        self.params = [p for g in GROUPS for p in groups[g]]
        self.device = self.params[0].device if self.params else torch.device("cpu")
        # AdamW reads a tensor learning rate on the card only when capturable;
        # fused, its update is one kernel a chunk of parameters
        self.capturable = self.device.type == "cuda"
        self.lrs = [torch.tensor(self.schedules[g](0), dtype=torch.float32, device=self.device)
                    for g in GROUPS if groups[g]]
        self.adamw = torch.optim.AdamW(
            [{"params": groups[g], "weight_decay": wd[g], "lr": lr, "group": g}
             for g, lr in zip([g for g in GROUPS if groups[g]], self.lrs)],
            betas=cfg.betas, eps=1e-8, capturable=self.capturable, fused=self.capturable or None)
        self.clip = cfg.clip_max_norm
        self.accum_steps = max(1, cfg.b_accum_steps)
        self.count = 0
        self.mini_step = 0
        # bumped when load_state_dict replaces AdamW's state tensors, whose
        # addresses a captured step holds
        self.version = 0
        self._mean: Dict[nn.Parameter, torch.Tensor] = {}

    def write_lr(self) -> None:
        """Write each group's learning rate at ``count`` into its tensor (a
        fill each, no copy from the host's memory): the rates ``step``
        reads."""
        for group, lr in zip(self.adamw.param_groups, self.lrs):
            lr.fill_(self.schedules[group["group"]](self.count))

    def step(self) -> torch.Tensor:
        """One micro-step on this backward's gradients; returns their global
        norm. With ``b_accum_steps = k`` (``optax.MultiSteps``) it folds them
        into the running mean of the optimizer step's micro-steps, as optax
        does (``acc + (g - acc) / (n + 1)``), and only on the k-th clips that
        mean by its global norm and steps AdamW; on the others the
        parameters stay as they are. A parameter without a gradient (frozen
        by ``requires_grad_(False)``, or unused) takes no update and no
        weight decay. AdamW reads the learning rates ``write_lr`` wrote last:
        call it before each step."""
        grads = [p.grad for p in self.params if p.grad is not None]
        norm = _global_norm(grads)
        if self.accum_steps > 1:
            self._accumulate()
            self.mini_step = (self.mini_step + 1) % self.accum_steps
            if self.mini_step:
                self.zero_grad()
                return norm
            for p, mean in self._mean.items():
                p.grad = mean
            self._mean = {}
            grads = [p.grad for p in self.params if p.grad is not None]
            clip_norm = _global_norm(grads)
        else:
            clip_norm = norm
        torch._foreach_mul_(grads, self.clip / clip_norm.clamp_min(self.clip))
        self.adamw.step()
        self.count += 1
        return norm

    def _accumulate(self) -> None:
        """mean <- mean + (g - mean) / (n + 1) over the parameters with a
        gradient now or earlier in this optimizer step (a missing one is 0)."""
        n = self.mini_step
        if n == 0:
            self._mean = {p: p.grad for p in self.params if p.grad is not None}
            return
        for p in self.params:
            if p.grad is not None and p not in self._mean:
                self._mean[p] = torch.zeros_like(p.grad)
        keys = list(self._mean)
        mean = [self._mean[p] for p in keys]
        grads = [p.grad if p.grad is not None else torch.zeros_like(m) for p, m in zip(keys, mean)]
        delta = torch._foreach_sub(grads, mean)
        torch._foreach_div_(delta, float(n + 1))
        torch._foreach_add_(mean, delta)

    def zero_grad(self) -> None:
        self.adamw.zero_grad(set_to_none=True)

    def state_dict(self) -> Dict:
        """What a trainer checkpoint keeps: AdamW's state, the counts, and
        the running mean of an unfinished accumulation by parameter index."""
        index = {p: i for i, p in enumerate(self.params)}
        return {"adamw": self.adamw.state_dict(), "count": self.count,
                "mini_step": self.mini_step,
                "accum_mean": {index[p]: m for p, m in self._mean.items()}}

    def load_state_dict(self, sd: Dict) -> None:
        """Load ``state_dict``'s output (float or tensor learning rates, from
        any device): the groups keep this optimizer's rate tensors, which
        ``step`` rewrites from the schedule, and on the card each AdamW
        ``step`` count moves to the device, as ``capturable`` needs."""
        self.adamw.load_state_dict(sd["adamw"])
        for group, lr in zip(self.adamw.param_groups, self.lrs):
            group["lr"], group["capturable"] = lr, self.capturable
            group["fused"] = self.capturable or None
        if self.capturable:
            for p, s in self.adamw.state.items():
                s["step"] = s["step"].to(p.device, torch.float32)
        self.count, self.mini_step = sd["count"], sd["mini_step"]
        self._mean = {self.params[i]: m.to(self.params[i].device)
                      for i, m in sd["accum_mean"].items()}
        self.version += 1


def build_optimizer(model: nn.Module, cfg: OptimConfig, flat: bool = False):
    """``Optimizer``, or with ``flat`` the ``flat_optim.FlatOptimizer``
    (``dfine_tpu/train/optim.py:76-97``): the same groups, schedules, clip,
    accumulation and freezing over one flat buffer."""
    if flat:
        from .flat_optim import FlatOptimizer

        return FlatOptimizer(model, cfg)
    return Optimizer(model, cfg)


EMA_BASE = 0.9999


def ema_momentum(iteration: int, base: float = EMA_BASE) -> float:
    """Warm-up EMA momentum (reference src/dl/train.py:59)."""
    return base * (1.0 - math.exp(-float(iteration) / 2000.0))


def write_ema_momentum(momentum: torch.Tensor, iteration: int, base: float = EMA_BASE) -> None:
    """Write m = ``ema_momentum(iteration, base)`` and 1 - m into
    ``momentum`` [2] (fills, no copy from the host's memory)."""
    m = ema_momentum(iteration, base)
    momentum[0].fill_(m)
    momentum[1].fill_(1.0 - m)


@torch.no_grad()
def ema_update(ema: nn.Module, model: nn.Module, momentum: torch.Tensor) -> None:
    """ema = ema * m + (1 - m) * model over every floating parameter and
    buffer; other buffers (BatchNorm's batch counter) are copied.
    ``momentum``: m and 1 - m as an fp32 tensor [2] on the EMA's device
    (``write_ema_momentum``)."""
    src = dict(model.named_parameters())
    src.update(model.named_buffers())
    dst = dict(ema.named_parameters())
    dst.update(ema.named_buffers())
    floats = [k for k, t in dst.items() if t.is_floating_point()]
    e = [dst[k] for k in floats]
    torch._foreach_mul_(e, momentum[0])
    torch._foreach_add_(e, torch._foreach_mul([src[k].to(dst[k].dtype) for k in floats],
                                              momentum[1]))
    for k, t in dst.items():
        if not t.is_floating_point():
            t.copy_(src[k])
