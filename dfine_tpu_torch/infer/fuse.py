"""BatchNorm folding (port of ``dfine_tpu/infer/fuse.py``), in two forms
that share one arithmetic (``fold``, ``merge_branch``), computed in fp32:

* **the serving fold** (``fold_for_serving``), which every serving backend
  applies to the model it serves: each eval conv + BatchNorm pair runs as
  one biased conv, and each ``VGGBlock``'s 1x1 branch runs inside its
  3x3's centre tap. The pairs are those each block declares by name
  (``bn_pairs``): those of the deploy rewrite plus the mask head's five
  (``MaskPixelDecoder``: each lateral conv, ``enc_proj`` and the
  ``ConvTranspose2d`` ``upconv``, whose weight takes the scale along its
  dim 1). No module changes its name, parameters or buffers:
  the modules take serving classes (``FoldedConv2d``, ...) whose forward
  reads the folded weight and bias, kept as buffers outside the state
  dict, so ``state_dict()`` and a strict ``load_state_dict`` are the
  unfused model's. The folded tensors are allocated once in the compute
  dtype and refolded in place (``copy_``) by a load-state-dict pre-hook
  at every ``load_state_dict``, from the incoming values in fp32, so a
  captured CUDA graph keeps reading them where they are. A write to a
  parameter other than through ``load_state_dict`` is not seen until the
  next load. A served model is for eval only. On the card a backbone
  ``ConvBN`` with a ReLU and ``groups`` 1 runs conv, bias and ReLU as one
  cuDNN call (``torch.cudnn_convolution_relu``), so that its bias takes no
  kernel of its own; a grouped conv keeps the plain conv and its bias add,
  since cuDNN's fused call takes a slow direct kernel for it.
* **the deploy rewrite** (``convert_to_deploy``, the form of the
  reference's ``deploy()``, which export uses): each BatchNorm of a
  declared pair outside the pixel decoder (``ConvBN``'s ``bn``;
  ``ConvBNA``'s and the ``input_proj``s' ``norm``: the pairs JAX's
  ``fuse_conv_bn`` folds, :24-69) goes into the conv's weight and a conv
  bias and becomes ``nn.Identity``; in each ``VGGBlock`` the 1x1 branch is
  added into the 3x3's centre tap and ``conv2`` goes. The state dict's
  keys change. The pixel decoder's norms stay, as in JAX.

Either way the fp32 BatchNorm islands and their casts leave the bf16 graph.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..models.decoder import MaskPixelDecoder
from ..models.layers import BatchNorm2d, ConvBN, VGGBlock
from ..utils.profiling import count


def fold(w: torch.Tensor, b: Optional[torch.Tensor], gamma: torch.Tensor, beta: torch.Tensor,
         mean: torch.Tensor, var: torch.Tensor, eps: float,
         dim: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """A conv (weight ``w``, bias ``b`` or None) then an eval BatchNorm, as
    one conv: its (weight, bias) in fp32. ``dim``: the weight's
    output-channel dim (1 for a ``ConvTranspose2d``)."""
    scale = gamma.float() / torch.sqrt(var.float() + eps)
    shape = [1] * w.dim()
    shape[dim] = -1
    shift = -mean.float() if b is None else b.float() - mean.float()
    return w.float() * scale.reshape(shape), shift * scale + beta.float()


def merge_branch(w3: torch.Tensor, b3: torch.Tensor, w1: torch.Tensor,
                 b1: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """A 3x3 conv plus a 1x1 conv of the same widths on the same input, as
    one 3x3 conv: the 1x1 kernel added into the centre tap."""
    return w3 + F.pad(w1, (1, 1, 1, 1)), b3 + b1


# ------------------------------------------------------------ serving --


class FoldedConv2d(nn.Conv2d):
    """A conv with its BatchNorm (and a ``VGGBlock``'s 1x1 branch) folded
    in: it runs ``folded_weight`` and ``folded_bias``."""

    def forward(self, x):
        return self._conv_forward(x, self.folded_weight, self.folded_bias)


class FoldedConvTranspose2d(nn.ConvTranspose2d):
    """``FoldedConv2d`` for the mask head's ``upconv``."""

    def forward(self, x):
        return F.conv_transpose2d(x, self.folded_weight, self.folded_bias, self.stride,
                                  self.padding, self.output_padding, self.groups, self.dilation)


class FoldedConvBNReLU(ConvBN):
    """A ``ConvBN`` with a ReLU and ``groups`` 1, folded: on the card conv,
    bias and ReLU in one cuDNN call."""

    def forward(self, x):
        c = self.conv
        if x.is_cuda:
            x = torch.cudnn_convolution_relu(x, c.folded_weight, c.folded_bias, c.stride,
                                             c.padding, c.dilation, c.groups)
        else:
            x = F.relu(c(x))
        return x if self.lab is None else self.lab(x)


class FoldedBatchNorm2d(BatchNorm2d):
    """An eval BatchNorm folded into the conv before it: the identity."""

    def forward(self, x):
        return x


class FoldedVGGBlock(VGGBlock):
    """A ``VGGBlock`` whose 1x1 branch is folded into ``conv1``."""

    def forward(self, x):
        return self.act(self.conv1(x))


def _bn_pairs(m: nn.Module) -> tuple:
    """The (conv, BatchNorm) pairs that block ``m`` declares
    (``bn_pairs``: ``ConvBN``, ``ConvBNA``, ``ConvNorm``,
    ``MaskPixelDecoder``), by submodule name."""
    return m.bn_pairs() if hasattr(m, "bn_pairs") else ()


def _serving_units(m: nn.Module) -> tuple:
    """What the serving fold folds in block ``m``: units, each a tuple of
    (conv, BatchNorm) names run as the first conv (a second pair is a
    ``VGGBlock``'s 1x1 branch)."""
    if isinstance(m, VGGBlock):
        return ((("conv1.conv", "conv1.norm"), ("conv2.conv", "conv2.norm")),)
    return tuple((pair,) for pair in _bn_pairs(m))


@torch.no_grad()
def _refold(units: tuple, owner: nn.Module, state: dict, prefix: str, *_) -> None:
    """Fold ``owner``'s units into their folded tensors, in place."""
    dev = owner.get_submodule(units[0][0][0]).folded_weight.device

    def value(name, attr):
        """In fp32: a load's incoming tensor (``state``, under ``prefix``)
        where it has the module's shape, else the module's own (a mismatch
        is the load's own error to raise); None for a conv without bias."""
        own = getattr(owner.get_submodule(name), attr)
        if own is None:
            return None
        t = state.get(f"{prefix}{name}.{attr}")
        return (own if t is None or t.shape != own.shape else t).to(dev, torch.float32)

    for parts in units:
        target = owner.get_submodule(parts[0][0])
        dim = 1 if isinstance(target, nn.ConvTranspose2d) else 0
        w = b = None
        for conv, bn in parts:
            stats = (value(bn, a) for a in ("weight", "bias", "running_mean", "running_var"))
            fw, fb = fold(value(conv, "weight"), value(conv, "bias"), *stats,
                          owner.get_submodule(bn).eps, dim)
            w, b = (fw, fb) if w is None else merge_branch(w, b, fw, fb)
        target.folded_weight.copy_(w)
        target.folded_bias.copy_(b)
    count("serve.folds", sum(2 * len(parts) - 1 for parts in units))


@torch.no_grad()
def fold_for_serving(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """The serving fold (module doc), in place, of a model whose weights
    are still fp32; the folded tensors in ``dtype``, each rounded once
    from the fp32 fold. Counts ``serve.folds``: the pairs and branches
    folded, at the build and at each load. Returns the model."""
    inner = {id(c) for m in model.modules() if isinstance(m, VGGBlock) for c in (m.conv1, m.conv2)}
    for owner in list(model.modules()):
        units = () if id(owner) in inner else _serving_units(owner)
        if not units:
            continue
        for parts in units:
            target = owner.get_submodule(parts[0][0])
            transpose = isinstance(target, nn.ConvTranspose2d)
            target.__class__ = FoldedConvTranspose2d if transpose else FoldedConv2d
            w = target.weight
            target.register_buffer("folded_weight", torch.empty_like(w, dtype=dtype),
                                   persistent=False)
            target.register_buffer("folded_bias", w.new_empty(w.shape[int(transpose)], dtype=dtype),
                                   persistent=False)
            for _, bn in parts:
                owner.get_submodule(bn).__class__ = FoldedBatchNorm2d
        if isinstance(owner, VGGBlock):
            owner.__class__ = FoldedVGGBlock
        elif isinstance(owner, ConvBN) and owner.act is F.relu and owner.conv.groups == 1:
            owner.__class__ = FoldedConvBNReLU
        hook = functools.partial(_refold, units)
        owner.register_load_state_dict_pre_hook(hook)
        hook(owner, {}, "")
    return model


# ------------------------------------------------------------- deploy --


def _fold(conv: nn.Conv2d, bn: BatchNorm2d) -> None:
    w, b = fold(conv.weight, conv.bias, bn.weight, bn.bias, bn.running_mean, bn.running_var,
                bn.eps)
    conv.weight.copy_(w)
    if conv.bias is None:
        conv.bias = nn.Parameter(b)
    else:
        conv.bias.copy_(b)


@torch.no_grad()
def fuse_conv_bn(model: nn.Module) -> nn.Module:
    for m in list(model.modules()):
        if isinstance(m, MaskPixelDecoder):  # its norms stay, as in JAX
            continue
        for conv, bn in _bn_pairs(m):
            if isinstance(getattr(m, bn), BatchNorm2d):
                _fold(getattr(m, conv), getattr(m, bn))
                setattr(m, bn, nn.Identity())
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
        w, b = merge_branch(k3.weight, k3.bias, k1.weight, k1.bias)
        k3.weight.copy_(w)
        k3.bias.copy_(b)
        m.conv2 = None
    return model


def convert_to_deploy(model: nn.Module) -> nn.Module:
    """The full deploy conversion, in place, of an fp32 model (before any
    bf16 cast). Returns the model."""
    if any(p.dtype != torch.float32 for p in model.parameters()):
        raise ValueError("convert_to_deploy folds fp32 weights: fuse before set_compute_dtype")
    return fuse_repvgg_branch(fuse_conv_bn(model))
