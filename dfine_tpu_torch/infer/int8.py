"""INT8 serving (port of ``dfine_tpu/infer/int8.py``).

``convert_int8`` quantizes every weight the JAX package quantizes, each 2-D
Dense / DenseGeneral kernel: every ``nn.Linear`` and each attention's
packed ``in_proj_weight`` (a 2-D ``DenseGeneral`` in JAX). Symmetric absmax
per output channel, ``/ 127``, zero scales set to 1, from the fp32 weights
(so the integers equal JAX's bit for bit: the JAX kernel is [in, out] and
its ``axis=0`` max is the max over each row of the port's [out, in]).
Convolutions (the backbone) stay in the compute dtype, as in JAX.

The mode is read at forward time (``set_int8_mode``):

- ``w8a8``: each row of the activation quantized by ``max(|x|, 1e-6) /
  127``, the int8 x int8 product summed in int32, then ``* s_x * s_w`` and
  the fp32 bias. On the card the product is ``torch._int_mm`` (a library
  product, as JAX leaves it to ``lax.dot_general``), which needs more than
  16 rows and K, N divisible by 8: the weights are stored padded to
  multiples of 8 with zeros, and short activations get zero rows. On the
  CPU the product is the exact integer sum, taken in float64.
- ``w8a16`` (the JAX default): the weights dequantized to bf16 before the
  product (``q.bf16 * s.bf16``); fp32 sums of the bf16 products.

``w8a16_packed`` (uint32 packing) worked around a TPU runtime and is not
ported: ``set_int8_mode`` raises for it.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..models.layers import MultiHeadSelfAttention

_INT8_MODE = "w8a16"
_PAD = 8  # torch._int_mm: K and N divisible by 8
_MIN_ROWS = 17  # torch._int_mm: more than 16 rows


def set_int8_mode(mode: str) -> None:
    global _INT8_MODE
    if mode == "w8a16_packed":
        raise ValueError("w8a16_packed (uint32-packed int8 weights) worked around a TPU "
                         "runtime and is not ported: use 'w8a8' or 'w8a16'")
    if mode not in ("w8a8", "w8a16"):
        raise ValueError(f"unknown int8 mode {mode!r}: use 'w8a8' or 'w8a16'")
    _INT8_MODE = mode


def int8_mode() -> str:
    return _INT8_MODE


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[out, in] fp32 -> (int8 [out, in], fp32 scale [out])."""
    s = w.abs().amax(1) / 127.0
    s = torch.where(s == 0, torch.ones_like(s), s)
    q = torch.clamp(torch.round(w / s[:, None]), -127, 127).to(torch.int8)
    return q, s


def _int_product(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """[M, K] int8 @ [N, K]^T int8 -> [M, N] int32."""
    if xq.device.type == "cpu":
        return (xq.double() @ wq.double().T).to(torch.int32)  # exact: |sum| < 2^53
    m = xq.shape[0]
    if m < _MIN_ROWS:
        xq = F.pad(xq, (0, 0, 0, _MIN_ROWS - m))
    return torch._int_mm(xq, wq.T)[:m]


class Int8Linear(nn.Module):
    """A quantized ``nn.Linear``: buffers only (int8 weight padded to
    multiples of 8, fp32 scale, fp32 bias), so ``set_compute_dtype`` leaves
    them as they are."""

    def __init__(self, weight: torch.Tensor, bias: torch.Tensor):
        super().__init__()
        n, k = weight.shape
        self.in_features, self.out_features = k, n
        q, s = quantize_weight(weight.detach().float())
        pn, pk = -n % _PAD, -k % _PAD
        self.register_buffer("qweight", F.pad(q, (0, pk, 0, pn)))
        self.register_buffer("scale", F.pad(s, (0, pn), value=1.0))
        self.register_buffer("bias", F.pad(bias.detach().float(), (0, pn)))

    def forward(self, x: torch.Tensor, lo: int = 0, hi: int = -1) -> torch.Tensor:
        """y = x @ dequant(W)[lo:hi].T + b[lo:hi] (all rows by default), in
        ``x``'s dtype."""
        hi = self.out_features if hi < 0 else hi
        lead, k = x.shape[:-1], x.shape[-1]
        x2 = x.reshape(-1, k)
        if _INT8_MODE == "w8a8":
            xf = x2.float()
            sx = xf.abs().amax(-1, keepdim=True).clamp_min(1e-6) / 127.0
            xq = torch.clamp(torch.round(xf / sx), -127, 127).to(torch.int8)
            xq = F.pad(xq, (0, self.qweight.shape[1] - k))
            n = hi - lo  # rows lo:hi, up to a multiple of 8 (the padding's zero rows)
            acc = _int_product(xq, self.qweight[lo : lo + n + (-n % _PAD)])[:, :n]
            y = acc.float() * sx * self.scale[lo:hi]
        else:
            w = (self.qweight[lo:hi, :k].to(torch.bfloat16)
                 * self.scale[lo:hi, None].to(torch.bfloat16))
            if x2.dtype == torch.bfloat16:  # bf16 product on the card's tensor cores
                y = F.linear(x2, w).float()
            else:  # fp32 sums of the bf16 products, as JAX's preferred f32 dot
                y = F.linear(x2.to(torch.bfloat16).float(), w.float())
        y = y + self.bias[lo:hi]
        return y.to(x.dtype).reshape(*lead, hi - lo)


@torch.no_grad()
def convert_int8(model: nn.Module) -> nn.Module:
    """Replace, in place, every ``nn.Linear`` by an ``Int8Linear`` and each
    attention's packed in-projection by one. Call on the fp32 model, before
    ``set_compute_dtype``. Returns the model."""
    if any(p.dtype != torch.float32 for p in model.parameters()):
        raise ValueError("convert_int8 quantizes fp32 weights: convert before set_compute_dtype")
    for m in list(model.modules()):
        for name, child in list(m.named_children()):
            if isinstance(child, nn.Linear):
                setattr(m, name, Int8Linear(child.weight, child.bias))
        if isinstance(m, MultiHeadSelfAttention) and m.in_proj is None:
            if m.embed_dim % _PAD:  # w8a8 multiplies the q, k or v rows alone
                raise ValueError(f"int8 in-projection needs embed_dim % {_PAD} == 0, "
                                 f"got {m.embed_dim}")
            m.in_proj = Int8Linear(m.in_proj_weight, m.in_proj_bias)
            m.in_proj_weight = m.in_proj_bias = None
    return model


def count_int8(model: nn.Module) -> Tuple[int, int]:
    """(quantized kernels, all kernels), the JAX ``count_int8``: a kernel is
    a conv, transposed conv, linear or in-projection weight."""
    q = sum(isinstance(m, Int8Linear) for m in model.modules())
    rest = sum(isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)) for m in model.modules())
    rest += sum(isinstance(m, MultiHeadSelfAttention) and m.in_proj is None
                for m in model.modules())
    return q, q + rest
