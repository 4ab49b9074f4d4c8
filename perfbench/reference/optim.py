"""Optimizer, learning-rate schedule, freeze masks and EMA of the reference
train step: a frozen copy of the program's ``train/optim.py`` (and of the
parameter-name map of its ``utils/checkpoint.py`` that the groups are
decided on), without accumulation.

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
  groups on ``onecycle(2 * backbone_lr)``.
- EMA with the warm-up momentum ``base * (1 - exp(-it / 2000))`` over the
  parameters and the BatchNorm statistics.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn as nn


_REWRITES = [
    (re.compile(r"decoder\.decoder\.layers_(\d+)"), r"decoder.decoder_layers_\1"),
    (re.compile(r"decoder\.decoder\.lqe_layers_(\d+)"), r"decoder.lqe_layers_\1"),
    (re.compile(r"decoder\.decoder\.pre_bbox_head\."), "decoder.pre_bbox_head."),
    (re.compile(r"(encoder\.encoder_\d+)\.layers_(\d+)"), r"\1_layers_\2"),
    (re.compile(r"enc_output\.proj"), "enc_output_proj"),
    (re.compile(r"enc_output\.norm"), "enc_output_norm"),
    (re.compile(r"\.cv2_0\."), ".cv2_csp."),
    (re.compile(r"\.cv2_1\."), ".cv2_conv."),
    (re.compile(r"\.cv3_0\."), ".cv3_csp."),
    (re.compile(r"\.cv3_1\."), ".cv3_conv."),
    (re.compile(r"downsample_convs_(\d+)_0\."), r"downsample_convs_\1."),
    (re.compile(r"input_proj_(\d+)_0\."), r"input_proj_\1.conv."),
    (re.compile(r"input_proj_(\d+)_1\."), r"input_proj_\1.norm."),
]


def flax_key(key: str, ndim: int) -> Tuple[str, Optional[str]]:
    """Port state_dict key -> (flat flax path, transform), transform one of
    None, "conv" (4-D weight) or "linear" (2-D weight)."""
    k = re.sub(r"\.(\d+)", r"_\1", key)  # list index -> flax name suffix
    for pat, rep in _REWRITES:
        k = pat.sub(rep, k)

    def path(stem: str) -> str:
        return stem.replace(".", "/")

    if k.endswith(".running_mean"):
        return "batch_stats/" + path(k[: -len(".running_mean")]) + "/mean", None
    if k.endswith(".running_var"):
        return "batch_stats/" + path(k[: -len(".running_var")]) + "/var", None
    if k.endswith(".in_proj_weight"):
        return "params/" + path(k[: -len(".in_proj_weight")]) + "/in_proj/kernel", "linear"
    if k.endswith(".in_proj_bias"):
        return "params/" + path(k[: -len(".in_proj_bias")]) + "/in_proj/bias", None
    if k.endswith("denoising_class_embed.weight"):
        return "params/" + path(k[: -len(".weight")]) + "/embedding", None
    if k.endswith(".weight"):
        stem = "params/" + path(k[: -len(".weight")])
        if ndim == 1:
            return stem + "/scale", None  # BatchNorm / LayerNorm weight
        return stem + "/kernel", "conv" if ndim == 4 else "linear"
    return "params/" + path(k), None

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
    ``2 * backbone_lr``. ``count``: optimizer steps taken so far."""

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
        self.adamw = torch.optim.AdamW(
            [{"params": groups[g], "weight_decay": wd[g], "lr": self.schedules[g](0), "group": g}
             for g in GROUPS if groups[g]], betas=cfg.betas, eps=1e-8)
        self.params = [p for g in GROUPS for p in groups[g]]
        self.clip = cfg.clip_max_norm
        self.count = 0

    def step(self) -> torch.Tensor:
        """Clip this backward's gradients by their global norm and step
        AdamW; returns the norm before the clip. A parameter without a
        gradient (frozen, or unused) takes no update and no weight decay."""
        grads = [p.grad for p in self.params if p.grad is not None]
        norm = _global_norm(grads)
        torch._foreach_mul_(grads, self.clip / torch.maximum(norm, torch.tensor(
            self.clip, device=norm.device)))
        for group in self.adamw.param_groups:
            group["lr"] = self.schedules[group["group"]](self.count)
        self.adamw.step()
        self.count += 1
        return norm

    def zero_grad(self) -> None:
        self.adamw.zero_grad(set_to_none=True)


EMA_BASE = 0.9999


def ema_momentum(iteration: int, base: float = EMA_BASE) -> float:
    """Warm-up EMA momentum (reference src/dl/train.py:59)."""
    return base * (1.0 - math.exp(-float(iteration) / 2000.0))


@torch.no_grad()
def ema_update(ema: nn.Module, model: nn.Module, iteration: int, base: float = EMA_BASE) -> None:
    """ema = ema * m + (1 - m) * model over every floating parameter and
    buffer; other buffers (BatchNorm's batch counter) are copied."""
    m = ema_momentum(iteration, base)
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
