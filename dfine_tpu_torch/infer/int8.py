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

The artifact of ``apps.quant`` (``export_int8.npz``) is in the JAX layout
of ``dfine_tpu/apps/quant.py``: the flat variables with each quantized
kernel as int8 [in, out] beside ``quant/<path>/scale`` [out], and the
kernels reverted to fp as fp32. ``int8_variables`` writes it and
``load_int8_variables`` serves it: the quantized kernels become
``Int8Linear`` modules with exactly those integers and scales, the others
stay ``nn.Linear`` / fp in-projections. ``kernel_key`` names a kernel by
its JAX path (the bridge's key map), one to one with the ``Int8Linear``
modules (JAX's in-projection is one 2-D kernel, as the port's). A file
is an int8 artifact by its ``quant`` scales: with every kernel reverted it
would have none and read as fp weights, so ``apps.quant`` writes none then.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
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
        self._store(*quantize_weight(weight.detach().float()), bias)

    @classmethod
    def from_quantized(cls, q: torch.Tensor, scale: torch.Tensor,
                       bias: torch.Tensor) -> "Int8Linear":
        """The module holding the int8 [out, in] ``q`` and fp32 [out]
        ``scale`` as they are (an int8 artifact's values)."""
        m = cls.__new__(cls)
        nn.Module.__init__(m)
        m._store(q.to(torch.int8), scale.float(), bias)
        return m

    def _store(self, q: torch.Tensor, s: torch.Tensor, bias: torch.Tensor) -> None:
        n, k = q.shape
        self.in_features, self.out_features = k, n
        pn, pk = -n % _PAD, -k % _PAD
        self.register_buffer("qweight", F.pad(q, (0, pk, 0, pn)))
        self.register_buffer("scale", F.pad(s, (0, pn), value=1.0))
        self.register_buffer("bias", F.pad(bias.detach().float(), (0, pn)))

    def int8_weight(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(int8 [out, in], fp32 scale [out], fp32 bias [out]) without the padding."""
        n, k = self.out_features, self.in_features
        return self.qweight[:n, :k], self.scale[:n], self.bias[:n]

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


def int8_kernels(model: nn.Module) -> Dict[str, Tuple[nn.Module, str]]:
    """Every kernel the JAX package quantizes, by its port path: each
    ``nn.Linear`` or ``Int8Linear`` (``<parent>.<name>``: (parent, name))
    and each attention's in-projection, fp or int8 (``<attention>.in_proj``:
    (attention, "in_proj"))."""
    out = {}
    for path, m in model.named_modules():
        prefix = f"{path}." if path else ""
        for name, child in m.named_children():
            if isinstance(child, (nn.Linear, Int8Linear)):
                out[prefix + name] = (m, name)
        if isinstance(m, MultiHeadSelfAttention) and m.in_proj is None:
            out[prefix + "in_proj"] = (m, "in_proj")
    return out


def kernel_key(path: str) -> str:
    """The JAX params path of the kernel at port path ``path`` (``int8_kernels``
    keys), e.g. ``decoder/dec_bbox_head_0/layers_0/kernel``."""
    from ..utils.checkpoint import flax_key

    return flax_key(path + ".weight", 2)[0][len("params/"):]


def fp_kernel(owner: nn.Module, attr: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """(weight [out, in], bias) of the fp kernel ``attr`` of ``owner``."""
    if attr == "in_proj":
        return owner.in_proj_weight, owner.in_proj_bias
    lin = getattr(owner, attr)
    return lin.weight, lin.bias


def set_int8(owner: nn.Module, attr: str, layer: "Int8Linear") -> None:
    """Put ``layer`` in place of the fp kernel ``attr`` of ``owner``."""
    if attr == "in_proj":
        owner.in_proj = layer
        owner.in_proj_weight = owner.in_proj_bias = None
    else:
        setattr(owner, attr, layer)


def set_fp(owner: nn.Module, attr: str, weight: torch.Tensor, bias: torch.Tensor) -> None:
    """Put an fp kernel with ``weight`` [out, in] and ``bias`` back in place
    of the ``Int8Linear`` at ``attr`` of ``owner``."""
    if attr == "in_proj":
        owner.in_proj = None
        owner.in_proj_weight = nn.Parameter(weight.detach().clone())
        owner.in_proj_bias = nn.Parameter(bias.detach().clone())
        return
    n, k = weight.shape
    lin = nn.Linear(k, n, device=weight.device, dtype=weight.dtype)
    with torch.no_grad():
        lin.weight.copy_(weight)
        lin.bias.copy_(bias)
    setattr(owner, attr, lin)


@torch.no_grad()
def convert_int8(model: nn.Module) -> nn.Module:
    """Replace, in place, every ``nn.Linear`` by an ``Int8Linear`` and each
    attention's packed in-projection by one. Call on the fp32 model, before
    ``set_compute_dtype``. Returns the model."""
    if any(p.dtype != torch.float32 for p in model.parameters()):
        raise ValueError("convert_int8 quantizes fp32 weights: convert before set_compute_dtype")
    for owner, attr in int8_kernels(model).values():
        if isinstance(getattr(owner, attr), Int8Linear):
            continue
        if attr == "in_proj" and owner.embed_dim % _PAD:  # w8a8 multiplies q, k or v alone
            raise ValueError(f"int8 in-projection needs embed_dim % {_PAD} == 0, "
                             f"got {owner.embed_dim}")
        set_int8(owner, attr, Int8Linear(*fp_kernel(owner, attr)))
    return model


@torch.no_grad()
def int8_variables(model: nn.Module) -> Dict[str, np.ndarray]:
    """The model's weights as the flat JAX int8 variables (the module doc):
    ``port_variables`` for all but the ``Int8Linear`` modules, each of those
    as ``params/<path>/kernel`` int8 [in, out], its fp32 bias, and
    ``quant/<path>/scale`` fp32 [out]."""
    from ..utils.checkpoint import port_variables

    int8 = {path: m for path, m in model.named_modules() if isinstance(m, Int8Linear)}
    flat = port_variables(model, skip=tuple(int8))
    for path, m in int8.items():
        q, s, b = (t.cpu().numpy() for t in m.int8_weight())
        stem = kernel_key(path)[: -len("/kernel")]
        flat[f"params/{stem}/kernel"] = np.ascontiguousarray(q.T)
        flat[f"params/{stem}/bias"] = b
        flat[f"quant/{stem}/scale"] = s
    return flat


@torch.no_grad()
def load_int8_variables(model: nn.Module, flat: Dict[str, np.ndarray]) -> nn.Module:
    """Fill the fp32 ``model`` in place from flat JAX int8 variables: every
    kernel with a ``quant`` scale becomes an ``Int8Linear`` of exactly its
    int8 values and scale, the rest loads through the strict bridge
    (``load_jax_variables``). Returns the model."""
    from ..utils.checkpoint import load_jax_variables, unflatten

    scales = {k[len("quant/"):-len("/scale")]: v for k, v in flat.items()
              if k.startswith("quant/") and k.endswith("/scale")}
    fp = {k: v for k, v in flat.items() if not k.startswith("quant/")}
    for stem, s in scales.items():  # the bridge fills fp32; the int8 modules come after
        q = fp[f"params/{stem}/kernel"]
        if q.dtype != np.int8:
            raise ValueError(f"params/{stem}/kernel has a quant scale but dtype {q.dtype}")
        fp[f"params/{stem}/kernel"] = q.astype(np.float32) * s[None, :]
    load_jax_variables(model, unflatten(fp))
    for path, (owner, attr) in int8_kernels(model).items():
        stem = kernel_key(path)[: -len("/kernel")]
        if stem in scales:
            q = torch.from_numpy(np.ascontiguousarray(flat[f"params/{stem}/kernel"].T))
            set_int8(owner, attr, Int8Linear.from_quantized(
                q, torch.from_numpy(np.asarray(scales[stem], np.float32)),
                fp_kernel(owner, attr)[1]))
    unused = sorted(set(scales) - {kernel_key(p)[: -len("/kernel")] for p in int8_kernels(model)})
    if unused:
        raise ValueError(f"quant scales without a kernel of the model: {unused[:5]}")
    return model


def count_int8(model: nn.Module) -> Tuple[int, int]:
    """(quantized kernels, all kernels), the JAX ``count_int8``: a kernel is
    a conv, transposed conv, linear or in-projection weight."""
    q = sum(isinstance(m, Int8Linear) for m in model.modules())
    rest = sum(isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)) for m in model.modules())
    rest += sum(isinstance(m, MultiHeadSelfAttention) and m.in_proj is None
                for m in model.modules())
    return q, q + rest
