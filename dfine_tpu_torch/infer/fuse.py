"""BatchNorm folding for serving (port of ``dfine_tpu/infer/fuse.py``),
computed in fp32.

``fold_for_serving``, which every serving backend and export apply to the
model they serve (``infer/torch_model.py::serving_model``): each eval
conv + BatchNorm pair runs as one biased conv (``fold``), and each
``VGGBlock``'s 1x1 branch runs inside its 3x3's centre tap
(``merge_branch``). The pairs are those each block declares by name
(``bn_pairs``; a ``VGGBlock`` its summed branches, ``bn_branches``): those
the JAX package folds plus the mask head's five
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
since cuDNN's fused call takes a slow direct kernel for it. The fp32
BatchNorm islands and their casts leave the bf16 graph.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..models.layers import BatchNorm2d, ConvBN, VGGBlock, get_activation
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
    bias and ReLU in one cuDNN call. The call has no meta kernel, so a trace
    runs it only where every size is concrete (``torch.export`` runs the
    kernel itself for the output's shape); at a symbolic size (an export's
    dynamic batch) it takes the conv, then the ReLU."""

    def forward(self, x):
        c = self.conv
        if x.is_cuda and not any(isinstance(d, torch.SymInt) for d in x.shape):
            x = torch.cudnn_convolution_relu(x, c.folded_weight, c.folded_bias, c.stride,
                                             c.padding, c.dilation, c.groups)
        else:
            x = F.relu(c(x))
        return x if self.lab is None else self.lab(x)


class FoldedBatchNorm2d(BatchNorm2d):
    """An eval BatchNorm folded into the conv before it: the identity, then
    the activation its caller passes."""

    def forward(self, x, act=None):
        return get_activation(act)(x)


class FoldedVGGBlock(VGGBlock):
    """A ``VGGBlock`` whose 1x1 branch is folded into ``conv1``."""

    def forward(self, x):
        return self.act(self.conv1(x))


def _serving_units(m: nn.Module) -> tuple:
    """What the serving fold folds in block ``m``: units, each a tuple of
    (conv, BatchNorm) names run as the first conv. The branches a block
    sums (``bn_branches``: ``VGGBlock``) are one unit; each pair a block
    declares (``bn_pairs``: ``ConvBN``, ``ConvBNA``, ``ConvNorm``,
    ``MaskPixelDecoder``) is one."""
    if hasattr(m, "bn_branches"):
        return (m.bn_branches(),)
    return tuple((pair,) for pair in (m.bn_pairs() if hasattr(m, "bn_pairs") else ()))


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
    for owner in list(model.modules()):
        # a block comes before its children: a pair whose BatchNorm an
        # enclosing block's unit folded (a VGGBlock's branch) is not folded again
        units = tuple(parts for parts in _serving_units(owner)
                      if not isinstance(owner.get_submodule(parts[0][1]), FoldedBatchNorm2d))
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
        elif isinstance(owner, ConvBN) and owner.act == "relu" and owner.conv.groups == 1:
            owner.__class__ = FoldedConvBNReLU
        hook = functools.partial(_refold, units)
        owner.register_load_state_dict_pre_hook(hook)
        hook(owner, {}, "")
    return model
