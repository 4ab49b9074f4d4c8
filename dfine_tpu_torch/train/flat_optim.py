"""The flat optimizer tail (port of ``dfine_tpu/train/flat_optim.py`` and
``ema_update_flat``, ``dfine_tpu/train/optim.py:171-181``).

Every floating parameter and buffer of a module moves into one f32 buffer,
parameters first, each tensor's ``.data`` a view into it (``flat_storage``).
``FlatOptimizer`` gives each parameter's ``.grad`` a view into a second
buffer of the parameters' length, so that the backward accumulates into it
in place. Then the step is a dozen whole-vector ops over about 19 M
elements at size m, with no ``cat`` and nothing per leaf: the global-norm
clip, Adam's moments, the per-element learning rate (one gather of the
four groups' rates by a per-element group id), the weight decay (a
per-element vector) and the update. A frozen parameter (``requires_grad``
off, read at every step) takes the group id of a fifth, frozen group whose
rate is 0: no update and no weight decay, the JAX trainable vector folded
into the rate. The parameters themselves are the JAX ``p_flat`` mirror:
the weight decay reads them before the update. With ``b_accum_steps = k``
it steps as ``optax.MultiSteps`` on the running mean of k micro-steps'
gradients, a third flat buffer.

``ema_update_flat``: the EMA as one ``lerp_`` over the two modules' flat
buffers (parameters and floating buffers).

Semantics of the JAX flat optimizer, not of ``Optimizer``'s AdamW: a
parameter that takes no gradient in a step (an unused head) has a zero
gradient there, so it still takes its weight decay. These are XLA in JAX,
not Pallas: plain vector ops are the port. Under data parallelism the
train step averages the gradient buffer over the ranks in place before
each micro-step (``parallel.dp.all_reduce_flat_``), as JAX averages the
gradients before ``MultiSteps``.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn as nn

from .optim import EMA_BASE, GROUPS, OptimConfig, ema_momentum, onecycle, param_group_label

FROZEN = len(GROUPS)  # the group id of a frozen parameter: rate 0


def _members(module: nn.Module) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    return (list(module.parameters()),
            [b for b in module.buffers() if b.is_floating_point()])


def _is_flat(flat: torch.Tensor, tensors: List[torch.Tensor]) -> bool:
    off = 0
    for t in tensors:
        if t.data_ptr() != flat.data_ptr() + off * flat.element_size():
            return False
        off += t.numel()
    return True


@torch.no_grad()
def flat_storage(module: nn.Module) -> Tuple[torch.Tensor, int]:
    """(flat, n): one f32 buffer holding every floating parameter and buffer
    of ``module`` (parameters first, in ``parameters()`` order, then the
    floating buffers), each tensor's ``.data`` a view into it, and n the
    parameters' length. Made at the first call and kept on the module
    (``_flat_storage``), and made again where a tensor no longer lies in it
    (a ``.to`` that moved it)."""
    params, bufs = _members(module)
    tensors = params + bufs
    got = getattr(module, "_flat_storage", None)
    if got is not None and _is_flat(got[0], tensors) and got[0].numel() == sum(
            t.numel() for t in tensors):
        return got
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("flat_storage takes f32 parameters and buffers (training keeps fp32 "
                        "parameters; cast for serving after training)")
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"flat_storage takes a module on one device, got {devices}")
    flat = torch.empty(sum(t.numel() for t in tensors), dtype=torch.float32,
                       device=devices.pop())
    off = 0
    for t in tensors:
        view = flat[off: off + t.numel()].view_as(t)
        view.copy_(t)
        t.data = view
        off += t.numel()
    module._flat_storage = (flat, sum(p.numel() for p in params))
    return module._flat_storage


def _norm(x: torch.Tensor) -> torch.Tensor:
    """The 2-norm of a long vector: a dot product, whose blocked sums keep
    f32 accurate over millions of elements where the CPU's ``vector_norm``
    loses about 1e-4 of it."""
    return torch.dot(x, x).sqrt()


class FlatOptimizer:
    """``Optimizer``'s API (``step``, ``zero_grad``, ``count``,
    ``mini_step``, ``params``, ``state_dict``) over flat buffers. Build it
    after the model is on its device and before ``TrainState.create``
    copies it for the EMA."""

    def __init__(self, model: nn.Module, cfg: OptimConfig):
        buf, n = flat_storage(model)
        self.param_flat = buf[:n]
        self.params = list(model.parameters())
        names = {p: name for name, p in model.named_parameters()}
        labels = [GROUPS.index(param_group_label(names[p], p.dim())) for p in self.params]
        self._labels = torch.cat([torch.full((p.numel(),), g, dtype=torch.int32)
                                  for p, g in zip(self.params, labels)]).to(buf.device)
        wd_of = torch.tensor([cfg.weight_decay, 0.0, 0.0, cfg.weight_decay])
        self.wd = wd_of.to(buf.device)[self._labels]
        self.grad_flat = torch.zeros_like(self.param_flat)
        off = 0
        for p in self.params:
            p.grad = self.grad_flat[off: off + p.numel()].view_as(p)
            off += p.numel()
        self.m = torch.zeros_like(self.param_flat)
        self.v = torch.zeros_like(self.param_flat)
        base = onecycle(2 * cfg.base_lr, cfg)
        backbone = onecycle(2 * cfg.backbone_lr, cfg) if cfg.per_group_max_lr else base
        self.schedules = (backbone, backbone, base, base)
        self.betas, self.eps, self.clip = cfg.betas, 1e-8, cfg.clip_max_norm
        self.accum_steps = max(1, cfg.b_accum_steps)
        self.count = 0
        self.mini_step = 0
        self.mean = None  # the running mean of an unfinished accumulation
        self._frozen = None
        self._gid = self._labels

    def _group_ids(self) -> torch.Tensor:
        """The per-element group id, frozen parameters on ``FROZEN``."""
        frozen = tuple(not p.requires_grad for p in self.params)
        if frozen != self._frozen:
            self._frozen = frozen
            self._gid = self._labels.clone()
            off = 0
            for p, f in zip(self.params, frozen):
                if f:
                    self._gid[off: off + p.numel()] = FROZEN
                off += p.numel()
        return self._gid

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """One micro-step on the gradient buffer; returns its global norm.
        On the k-th micro-step (every one at k = 1) it clips the mean, takes
        Adam's moments and updates the parameters in place."""
        if self.params[0].data_ptr() != self.param_flat.data_ptr():
            raise RuntimeError("the model's parameters left the flat buffer (moved after "
                               "build_optimizer(flat=True)?)")
        g = self.grad_flat
        norm = _norm(g)
        if self.accum_steps > 1:
            n = self.mini_step
            if n == 0:
                self.mean = g.clone()
            else:  # optax.MultiSteps: acc + (g - acc) / (n + 1)
                self.mean.add_(torch.sub(g, self.mean).div_(n + 1))
            self.mini_step = (n + 1) % self.accum_steps
            if self.mini_step:
                self.zero_grad()
                return norm
            g, self.mean = self.mean, None
            clip_norm = _norm(g)
        else:
            clip_norm = norm
        b1, b2 = self.betas
        # the JAX flat clip: g * min(1, clip / max(norm, 1e-12))
        g = g * (self.clip / clip_norm.clamp_min(1e-12)).clamp_max(1.0)
        self.count += 1
        c = self.count
        self.m.mul_(b1).add_(g, alpha=1 - b1)
        self.v.mul_(b2).addcmul_(g, g, value=1 - b2)
        upd = torch.div(self.v, 1 - b2 ** c).sqrt_().add_(self.eps)
        upd = torch.div(self.m, 1 - b1 ** c).div_(upd)
        upd.addcmul_(self.wd, self.param_flat)  # the parameters before the update
        lrs = torch.tensor([s(c - 1) for s in self.schedules] + [0.0], dtype=torch.float32)
        upd.mul_(lrs.to(g.device).index_select(0, self._group_ids()))
        self.param_flat.sub_(upd)
        return norm

    def zero_grad(self) -> None:
        """Zero the gradient buffer in place (the views stay the grads)."""
        self.grad_flat.zero_()

    def state_dict(self) -> Dict:
        return {"flat_adamw": {"m": self.m, "v": self.v}, "count": self.count,
                "mini_step": self.mini_step, "accum_mean": self.mean}

    @torch.no_grad()
    def load_state_dict(self, sd: Dict) -> None:
        self.m.copy_(sd["flat_adamw"]["m"])
        self.v.copy_(sd["flat_adamw"]["v"])
        self.count, self.mini_step = sd["count"], sd["mini_step"]
        mean = sd["accum_mean"]
        self.mean = None if mean is None else mean.to(self.m.device).clone()


@torch.no_grad()
def ema_update_flat(ema: nn.Module, model: nn.Module, iteration: int,
                    base: float = EMA_BASE) -> None:
    """``ema_update`` as one ``lerp_`` over the two modules' flat buffers
    (every floating parameter and buffer): ema + (1 - m) (model - ema) with
    the warm-up momentum m of ``iteration``; the other buffers (BatchNorm's
    batch counter) are copied in one foreach copy."""
    e, _ = flat_storage(ema)
    p, _ = flat_storage(model)
    if e.shape != p.shape:
        raise ValueError("ema_update_flat takes two modules of one layout")
    e.lerp_(p, 1.0 - ema_momentum(iteration, base))
    pairs = [(d, s) for d, s in zip(ema.buffers(), model.buffers()) if not d.is_floating_point()]
    if pairs:
        torch._foreach_copy_([d for d, _ in pairs], [s for _, s in pairs])
