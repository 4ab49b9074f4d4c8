"""Shared building blocks (the reference's frozen copy of ``dfine_tpu_torch/models/layers.py``), NCHW.

Submodule names give ``state_dict()`` the reference (uc-vision) key layout.
Norms are fp32 islands whatever the compute dtype, as in the JAX package:
``BatchNorm2d`` and ``LayerNorm`` below take their input in fp32 and return
the input's dtype; their parameters and statistics stay fp32.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

_ACTIVATIONS = {
    "relu": F.relu,
    "silu": F.silu,
    "swish": F.silu,
    # flax's gelu is the tanh approximation (jax.nn.gelu approximate=True)
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "leaky_relu": F.leaky_relu,
    "hardsigmoid": F.hardsigmoid,
    "sigmoid": torch.sigmoid,
}


def get_activation(name: Optional[str]) -> Callable[[torch.Tensor], torch.Tensor]:
    if name is None or name == "identity":
        return lambda x: x
    name = name.lower()
    if name not in _ACTIVATIONS:
        raise ValueError(f"unknown activation {name}")
    return _ACTIVATIONS[name]


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm computed in fp32 (layers.py:136-144), with flax's update of
    the running statistics in ``train()`` mode: momentum 0.9 in flax's sense
    (torch's ``momentum=0.1``) and the *biased* batch variance, where torch's
    own BatchNorm stores the unbiased one."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        if not self.training:
            return super().forward(x32).to(x.dtype)
        y = F.batch_norm(x32, None, None, self.weight, self.bias, True, 0.0, self.eps)
        with torch.no_grad():
            var, mean = torch.var_mean(x32, dim=(0, 2, 3), correction=0)
            self._update_running(mean, var)
        return y.to(x.dtype)

    def _update_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        self.running_mean.mul_(1.0 - self.momentum).add_(mean, alpha=self.momentum)
        self.running_var.mul_(1.0 - self.momentum).add_(var, alpha=self.momentum)
        self.num_batches_tracked.add_(1)


class LayerNorm(nn.LayerNorm):
    """LayerNorm computed in fp32 (decoder.py:219, :246)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.float()).to(x.dtype)


FP32_MODULES = (BatchNorm2d, LayerNorm)


class LearnableAffine(nn.Module):
    """y = scale * x + bias with scalar parameters."""

    def __init__(self):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(1))
        self.bias = nn.Parameter(torch.zeros(1))

    def forward(self, x):
        return self.scale.to(x.dtype) * x + self.bias.to(x.dtype)


def _padding(kernel: int, padding: Optional[int]) -> int:
    return (kernel - 1) // 2 if padding is None else padding


class ConvBN(nn.Module):
    """Conv (no bias) + BN + optional act + optional LAB (backbone ConvBNAct)."""

    def __init__(self, in_ch, out_ch, kernel=3, stride=1, groups=1, padding=None,
                 act: Optional[str] = "relu", use_lab=False):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, kernel, stride, _padding(kernel, padding),
                              groups=groups, bias=False)
        self.bn = BatchNorm2d(out_ch)
        self.has_act = act is not None
        self.act = get_activation(act)
        self.lab = LearnableAffine() if (act is not None and use_lab) else None

    def forward(self, x):
        x = self.bn(self.conv(x))
        if self.has_act:
            x = self.act(x)
            if self.lab is not None:
                x = self.lab(x)
        return x


class ConvBNA(nn.Module):
    """Conv (optional bias) + BN + act: the encoder's ConvNormLayer."""

    def __init__(self, in_ch, out_ch, kernel, stride, groups=1, padding=None,
                 bias=False, act: Optional[str] = None):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, kernel, stride, _padding(kernel, padding),
                              groups=groups, bias=bias)
        self.norm = BatchNorm2d(out_ch)
        self.act = get_activation(act)

    def forward(self, x):
        return self.act(self.norm(self.conv(x)))


class VGGBlock(nn.Module):
    """RepVGG-style block: 3x3 + 1x1 branches summed, then act."""

    def __init__(self, in_ch, out_ch, act="silu"):
        super().__init__()
        self.conv1 = ConvBNA(in_ch, out_ch, 3, 1)
        self.conv2 = ConvBNA(in_ch, out_ch, 1, 1)
        self.act = get_activation(act)

    def forward(self, x):
        return self.act(self.conv1(x) + self.conv2(x))


class CSPLayer(nn.Module):
    """Cross-stage partial layer with VGGBlock bottlenecks."""

    def __init__(self, in_ch, out_ch, num_blocks=3, expansion=1.0, act="silu"):
        super().__init__()
        hidden = int(out_ch * expansion)
        self.conv1 = ConvBNA(in_ch, hidden, 1, 1, act=act)
        self.conv2 = ConvBNA(in_ch, hidden, 1, 1, act=act)
        self.bottlenecks = nn.Sequential(*[VGGBlock(hidden, hidden, act) for _ in range(num_blocks)])
        self.conv3 = ConvBNA(hidden, out_ch, 1, 1, act=act) if hidden != out_ch else None

    def forward(self, x):
        y = self.bottlenecks(self.conv1(x)) + self.conv2(x)
        return y if self.conv3 is None else self.conv3(y)


class RepNCSPELAN4(nn.Module):
    """CSP-ELAN fusion block: c1 in, c2 out, c3 split, c4 branch channels."""

    def __init__(self, c1, c2, c3, c4, n=3, act="silu"):
        super().__init__()
        self.c = c3 // 2
        self.cv1 = ConvBNA(c1, c3, 1, 1, act=act)
        self.cv2 = nn.Sequential(CSPLayer(c3 - self.c, c4, n, 1.0, act), ConvBNA(c4, c4, 3, 1, act=act))
        self.cv3 = nn.Sequential(CSPLayer(c4, c4, n, 1.0, act), ConvBNA(c4, c4, 3, 1, act=act))
        self.cv4 = ConvBNA(c3 + 2 * c4, c2, 1, 1, act=act)

    def forward(self, x):
        y = self.cv1(x)
        y0, y1 = y[:, : self.c], y[:, self.c :]
        b2 = self.cv2(y1)
        b3 = self.cv3(b2)
        return self.cv4(torch.cat([y0, y1, b2, b3], 1))


class SCDown(nn.Module):
    """Separable downsample: 1x1, then depthwise kxk stride s."""

    def __init__(self, c1, c2, kernel=3, stride=2):
        super().__init__()
        self.cv1 = ConvBNA(c1, c2, 1, 1)
        self.cv2 = ConvBNA(c2, c2, kernel, stride, groups=c2)

    def forward(self, x):
        return self.cv2(self.cv1(x))


class MultiHeadSelfAttention(nn.Module):
    """Packed-QKV attention with ``nn.MultiheadAttention``'s parameters;
    matmul plus an fp32 softmax (layers.py:318-324)."""

    def __init__(self, embed_dim: int, num_heads: int):
        super().__init__()
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim, embed_dim))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * embed_dim))
        self.out_proj = nn.Linear(embed_dim, embed_dim)

    def forward(self, q, k, v, mask: Optional[torch.Tensor] = None):
        """q/k/v [B, L, C]; mask bool [.., L, L], True = may attend (the CDN
        keep-mask, denoising.py:30-45)."""
        c, h = self.embed_dim, self.num_heads
        d = c // h
        w, b = self.in_proj_weight, self.in_proj_bias

        def proj(x, i):
            y = F.linear(x, w[i * c : (i + 1) * c], b[i * c : (i + 1) * c])
            return y.reshape(y.shape[0], y.shape[1], h, d).transpose(1, 2)  # [B,h,L,d]

        wq, wk, wv = proj(q, 0), proj(k, 1), proj(v, 2)
        logits = torch.matmul(wq, wk.transpose(-1, -2)).float() * (1.0 / math.sqrt(d))
        if mask is not None:
            logits = logits.masked_fill(~mask, torch.finfo(torch.float32).min)
        attn = logits.softmax(-1).to(wv.dtype)
        out = torch.matmul(attn, wv).transpose(1, 2).reshape(q.shape[0], q.shape[1], c)
        return self.out_proj(out)


class MLP(nn.Module):
    """``num_layers`` Linear layers with act between them."""

    def __init__(self, in_dim, hidden_dim, out_dim, num_layers, act="relu"):
        super().__init__()
        dims = [in_dim] + [hidden_dim] * (num_layers - 1) + [out_dim]
        self.layers = nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))
        self.act = get_activation(act)

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = self.act(x)
        return x


def max_pool_2x2_s1(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-1 max pool without padding (the stem's (0,1,0,1) pre-pad
    makes the reference's ceil_mode exact)."""
    return F.max_pool2d(x, 2, 1)


def pad_rb(x: torch.Tensor) -> torch.Tensor:
    """Zero-pad right and bottom by one pixel."""
    return F.pad(x, (0, 1, 0, 1))
