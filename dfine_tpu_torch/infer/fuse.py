"""Deploy fusion (port of ``dfine_tpu/infer/fuse.py``) as a module rewrite,
the form of the reference's ``deploy()``:

1. ``fuse_conv_bn``: each BatchNorm that follows a conv named ``conv`` in
   its block (``ConvBN``'s ``bn``; ``ConvBNA``'s and the encoder
   ``input_proj``'s ``norm``: the pairs ``fuse_conv_bn`` folds, :24-69) is
   folded into the conv's weight and a conv bias, and becomes
   ``nn.Identity``;
2. ``fuse_repvgg_branch``: in each ``VGGBlock`` (3x3 + 1x1 of the same
   width, not ``CSPLayer``'s pair of 1x1 convs) the 1x1 branch is added
   into the centre tap of the 3x3 and the biases summed; the branch goes.

The fold is computed in fp32 before any bf16 cast, so the fp32 BatchNorm
islands and their casts leave the deployed graph. The pixel decoder's
norms follow convs of other names and stay, as in JAX.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..models.layers import BatchNorm2d, ConvBN, ConvBNA, VGGBlock


def _fold(conv: nn.Conv2d, bn: BatchNorm2d) -> None:
    w = conv.weight.float()
    scale = bn.weight.float() / torch.sqrt(bn.running_var.float() + bn.eps)
    b = conv.bias.float() if conv.bias is not None else torch.zeros_like(scale)
    conv.weight.copy_(w * scale[:, None, None, None])
    bias = (b - bn.running_mean.float()) * scale + bn.bias.float()
    if conv.bias is None:
        conv.bias = nn.Parameter(bias)
    else:
        conv.bias.copy_(bias)


@torch.no_grad()
def fuse_conv_bn(model: nn.Module) -> nn.Module:
    for m in list(model.modules()):
        bn_name = "bn" if isinstance(m, ConvBN) else "norm"
        bn = getattr(m, bn_name, None)
        if isinstance(getattr(m, "conv", None), nn.Conv2d) and isinstance(bn, BatchNorm2d):
            _fold(m.conv, bn)
            setattr(m, bn_name, nn.Identity())
    return model


@torch.no_grad()
def fuse_repvgg_branch(model: nn.Module) -> nn.Module:
    """After ``fuse_conv_bn``: VGGBlock(x) = act(conv1'(x))."""
    for m in model.modules():
        if not (isinstance(m, VGGBlock) and m.conv2 is not None):
            continue
        k3, k1 = m.conv1.conv, m.conv2.conv
        if not (isinstance(m.conv1.norm, nn.Identity) and isinstance(m.conv2.norm, nn.Identity)):
            raise ValueError("fuse_repvgg_branch runs after fuse_conv_bn")
        if k3.kernel_size != (3, 3) or k1.kernel_size != (1, 1) or k3.weight.shape[:2] != k1.weight.shape[:2]:
            continue
        k3.weight[:, :, 1, 1] += k1.weight[:, :, 0, 0]
        k3.bias += k1.bias
        m.conv2 = None
    return model


def convert_to_deploy(model: nn.Module) -> nn.Module:
    """The full deploy conversion, in place, of an fp32 model (before any
    bf16 cast). Returns the model."""
    if any(p.dtype != torch.float32 for p in model.parameters()):
        raise ValueError("convert_to_deploy folds fp32 weights: fuse before set_compute_dtype")
    return fuse_repvgg_branch(fuse_conv_bn(model))
