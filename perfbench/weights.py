"""Seeded weights for both sides, made on the device in a few large draws.

The rule (the one ``chip_smoke.py::randomize_`` applies, so that no layer
is trivial): every tensor of two or more dimensions U(+-1/sqrt(fan_in)),
fan_in the size of one output row; one-dimensional weights and scales (the
norms' and LAB's) U(0.8, 1.2); other one-dimensional tensors (biases)
U(-0.1, 0.1), BatchNorm biases U(``bn_bias``); BatchNorm means N(0, 0.1),
variances U(0.5, 1.5); the batch counters 0. A configuration's
``weights.scale`` ({glob of names: factor}) multiplies the tensors it
names after the draw.

The names and shapes are the reference model's ``state_dict``; the program
loads the same dict (``load_state_dict(strict=True)`` checks the names).
"""

from __future__ import annotations

import fnmatch
import math
from typing import Dict, Sequence, Tuple

import torch

SEED_MOD = 2**63


def generator(seed: int, device, stream: int = 0) -> torch.Generator:
    """A generator on ``device`` for draw ``stream`` of run seed ``seed``."""
    return torch.Generator(device=device).manual_seed((seed * 1000003 + stream) % SEED_MOD)


def draw(shapes: Dict[str, Tuple[Tuple[int, ...], torch.dtype]], seed: int, device,
         scale: Dict[str, float] = None,
         bn_bias: Sequence[float] = (-0.1, 0.1)) -> Dict[str, torch.Tensor]:
    """{name: tensor} for ``shapes`` ({name: (shape, dtype)}, in state_dict
    order), f32 on ``device`` (integer buffers zero), from two draws of one
    generator: one uniform over all floating elements, one normal over the
    BatchNorm means."""
    names = [k for k, (_, dt) in shapes.items() if dt.is_floating_point]
    means = [k for k in names if k.endswith("running_mean")]
    g = generator(seed, device)
    sizes = [math.prod(shapes[k][0]) for k in names]
    uni = torch.rand(sum(sizes), generator=g, device=device)
    nrm = torch.randn(sum(math.prod(shapes[k][0]) for k in means), generator=g, device=device)
    out, u0, n0 = {}, 0, 0
    for k, n in zip(names, sizes):
        shape = shapes[k][0]
        if k.endswith("running_mean"):
            out[k] = nrm[n0:n0 + n].view(shape) * 0.1
            n0 += n
            u0 += n
            continue
        u = uni[u0:u0 + n].view(shape)
        u0 += n
        if k.endswith("running_var"):
            lo, hi = 0.5, 1.5
        elif len(shape) == 1 and k.endswith((".weight", ".scale")):
            lo, hi = 0.8, 1.2
        elif k.endswith(".bias") and k[:-5] + ".running_mean" in shapes:
            lo, hi = bn_bias
        elif len(shape) >= 2:
            b = 1.0 / math.sqrt(math.prod(shape[1:]))
            lo, hi = -b, b
        else:
            lo, hi = -0.1, 0.1
        out[k] = u * (hi - lo) + lo
    for pattern, s in (scale or {}).items():
        hits = fnmatch.filter(names, pattern)
        if not hits:
            raise KeyError(f"weights.scale: no tensor matches {pattern!r}")
        for k in hits:
            out[k] = out[k] * s
    for k, (shape, dt) in shapes.items():
        if not dt.is_floating_point:
            out[k] = torch.zeros(shape, dtype=dt, device=device)
    return {k: out[k] for k in shapes}


def for_config(cfg, model_or_shapes, seed: int, device) -> Dict[str, torch.Tensor]:
    """``draw`` with a configuration's ``weights`` rule."""
    shapes = (model_or_shapes if isinstance(model_or_shapes, dict)
              else shapes_of(model_or_shapes))
    rule = cfg["weights"]
    return draw(shapes, seed, device, rule.get("scale"), tuple(rule.get("bn_bias", (-0.1, 0.1))))


def shapes_of(model: torch.nn.Module) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    return {k: (tuple(v.shape), v.dtype) for k, v in model.state_dict().items()}


def images(g: torch.Generator, n: int, hw, device) -> torch.Tensor:
    """[n, 3, H, W] in [0, 1]: a coarse random picture (one value an 80x80
    cell a channel, bicubic between them) plus pixel noise of +-0.15. Pure
    pixel noise would not do: a model with random weights answers every
    frame of it alike, so an answer for the wrong frame would pass."""
    h, w = hw
    coarse = torch.rand((n, 3, max(2, h // 80), max(2, w // 80)), generator=g, device=device)
    x = torch.nn.functional.interpolate(coarse, size=(h, w), mode="bicubic", align_corners=False)
    x = x + 0.3 * (torch.rand((n, 3, h, w), generator=g, device=device) - 0.5)
    return x.clamp(0.0, 1.0)
