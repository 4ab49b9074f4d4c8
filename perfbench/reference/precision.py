"""The precision the reference computes in.

``fp32()``: float32 with TF32 off for matrix products and convolutions
(torch's and cuDNN's flags, restored on exit), the reference proper.

``fp8(device_type)``: the control, the reference one precision step below
the bf16 that the configurations state, in every place bf16 takes: the
reference runs under bf16 autocast (so its float32 islands, the norms,
the softmaxes and the losses, stay float32 as the program keeps them), and
every bf16 result of any operation, forward and backward, is rounded to
float8 e4m3 with one scale a tensor (its largest magnitude to e4m3's
largest finite value).
"""

from __future__ import annotations

import contextlib

import torch
from torch.utils._python_dispatch import TorchDispatchMode

E4M3_MAX = 448.0


def to_e4m3(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under one scale, back in its dtype."""
    amax = t.detach().abs().amax().float().clamp_min(1e-30)
    scale = E4M3_MAX / amax
    return ((t.float() * scale).to(torch.float8_e4m3fn).float() / scale).to(t.dtype)


def _round(t):
    if isinstance(t, torch.Tensor) and t.dtype == torch.bfloat16 and t.numel():
        return to_e4m3(t)
    return t


class _Bf16ToFp8(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if isinstance(out, (tuple, list)):
            return type(out)(_round(o) for o in out)
        return _round(out)


@contextlib.contextmanager
def fp32():
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


@contextlib.contextmanager
def fp8(device_type: str = "cuda"):
    with fp32(), torch.autocast(device_type, dtype=torch.bfloat16), _Bf16ToFp8():
        yield


def mode(name: str, device_type: str = "cuda"):
    """``fp32`` (the reference) or ``fp8`` (the control)."""
    return fp32() if name == "fp32" else fp8(device_type)
