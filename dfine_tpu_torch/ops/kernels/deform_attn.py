"""The deformable-attention sampling kernel (``csrc/ms_deform_attn_fwd.cu``)
and its plain PyTorch version.

``ms_deform_attn_fwd`` launches the CUDA kernel for tensors on the card and
takes the plain version only for tensors on the CPU. The plain version is
the gather formulation of ``dfine_tpu/ops/deform_attn.py:30-101``, step for
step; the CPU tests hold it against JAX and ``chip_smoke.py`` holds the
kernel against it on the card.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from . import _build

_CORNERS = ((0, 0), (0, 1), (1, 0), (1, 1))  # (dy, dx)
MAX_POINTS, MAX_LEVELS = 16, 4  # what the kernel takes (csrc: kMaxPoints, kMaxLevels)
HEAD_DIMS = (16, 32, 64)  # the head dims it is specialized on (64: two 32-channel slices)


def _bilinear_gather_level(v: torch.Tensor, h: int, w: int, loc: torch.Tensor) -> torch.Tensor:
    """v [B, nhead, H*W, d] f32, loc [B, Q, nhead, P, 2] -> [B, Q, nhead, P, d]."""
    b, nhead, _, d = v.shape
    q, p = loc.shape[1], loc.shape[3]
    x = loc[..., 0].float() * w - 0.5
    y = loc[..., 1].float() * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    x0i = x0.long()
    y0i = y0.long()
    weights = ((1 - fx) * (1 - fy), fx * (1 - fy), (1 - fx) * fy, fx * fy)
    out = None
    for (dy, dx), wgt in zip(_CORNERS, weights):
        xi = x0i + dx
        yi = y0i + dy
        valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        idx = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)  # [B,Q,nhead,P]
        idx_t = idx.permute(0, 2, 1, 3).reshape(b, nhead, q * p, 1).expand(-1, -1, -1, d)
        g = torch.gather(v, 2, idx_t).reshape(b, nhead, q, p, d).permute(0, 2, 1, 3, 4)
        g = g * (wgt * valid)[..., None]
        out = g if out is None else out + g
    return out


def ms_deform_attn_fwd_plain(
    value: torch.Tensor,  # [B, sum(HW), nhead, d]
    spatial_shapes: Sequence[Tuple[int, int]],
    loc: torch.Tensor,  # [B, Q, nhead, sum(P), 2] in [0, 1]
    att: torch.Tensor,  # [B, Q, nhead, sum(P)] softmaxed
    num_points: Sequence[int],
) -> torch.Tensor:
    """Weighted sum of bilinear samples in fp32. Returns [B, Q, nhead*d] f32."""
    b, q = loc.shape[:2]
    nhead, d = value.shape[2], value.shape[3]
    out = value.new_zeros((b, q, nhead, d), dtype=torch.float32)
    hw_start = p_start = 0
    for (h, w), p in zip(spatial_shapes, num_points):
        v = value[:, hw_start : hw_start + h * w].float().permute(0, 2, 1, 3)
        l = loc[:, :, :, p_start : p_start + p]
        a = att[:, :, :, p_start : p_start + p].float()
        sampled = _bilinear_gather_level(v, h, w, l)
        out = out + torch.einsum("bqnpd,bqnp->bqnd", sampled, a)
        hw_start += h * w
        p_start += p
    return out.reshape(b, q, nhead * d)


def _lib():
    lib = _build.load("ms_deform_attn_fwd")
    fn = lib.ms_deform_attn_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                       + [ctypes.c_void_p, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def ms_deform_attn_fwd(
    value: torch.Tensor,
    spatial_shapes: Sequence[Tuple[int, int]],
    loc: torch.Tensor,
    att: torch.Tensor,
    num_points: Sequence[int],
) -> torch.Tensor:
    """The sampling core: value [B, S, nhead, d] (bf16 or f32, d in HEAD_DIMS),
    loc [B, Q, nhead, P, 2] f32, att [B, Q, nhead, P] f32 -> [B, Q, nhead*d]
    f32, with P <= 16 over at most 4 levels. CPU tensors take the plain
    version; CUDA tensors launch the kernel or raise."""
    if value.device.type == "cpu":
        return ms_deform_attn_fwd_plain(value, spatial_shapes, loc, att, num_points)
    if value.device.type != "cuda":
        raise ValueError(f"ms_deform_attn_fwd: unsupported device {value.device}")
    b, s, nhead, d = value.shape
    q, p = loc.shape[1], loc.shape[3]
    if value.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"value must be bf16 or f32, got {value.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} unsupported {HEAD_DIMS}")
    if loc.dtype != torch.float32 or att.dtype != torch.float32:
        raise TypeError("loc and att must be f32")
    if tuple(loc.shape) != (b, q, nhead, p, 2) or tuple(att.shape) != (b, q, nhead, p):
        raise ValueError(f"shape mismatch: value {tuple(value.shape)}, loc "
                         f"{tuple(loc.shape)}, att {tuple(att.shape)}")
    if sum(num_points) != p or len(num_points) != len(spatial_shapes):
        raise ValueError("num_points must give one count per level summing to P")
    if p > MAX_POINTS or len(spatial_shapes) > MAX_LEVELS:
        raise ValueError(f"at most {MAX_POINTS} points and {MAX_LEVELS} levels, got {p} and "
                         f"{len(spatial_shapes)}")
    if sum(h * w for h, w in spatial_shapes) != s:
        raise ValueError("spatial_shapes must cover the value rows")
    if not (value.is_contiguous() and loc.is_contiguous() and att.is_contiguous()):
        raise ValueError("ms_deform_attn_fwd takes contiguous tensors")
    if value.data_ptr() % 16 or loc.data_ptr() % 8:
        raise ValueError("ms_deform_attn_fwd takes value 16-byte and loc 8-byte aligned")
    if loc.device != value.device or att.device != value.device:
        raise ValueError("value, loc and att must be on one device")
    info, start = [], 0
    for (h, w), n in zip(spatial_shapes, num_points):
        info += [h, w, start, n]
        start += h * w
    info_c = (ctypes.c_int * len(info))(*info)
    out = torch.empty((b, q, nhead * d), dtype=torch.float32, device=value.device)
    with torch.cuda.device(value.device):
        stream = torch.cuda.current_stream(value.device).cuda_stream
        rc = _lib()(value.data_ptr(), loc.data_ptr(), att.data_ptr(), out.data_ptr(),
                    b, s, q, nhead, d, p, int(value.dtype == torch.bfloat16),
                    len(spatial_shapes), ctypes.cast(info_c, ctypes.c_void_p), stream)
    if rc != 0:
        raise RuntimeError(f"ms_deform_attn_fwd kernel launch failed: CUDA error {rc}")
    ms_deform_attn_fwd.launches += 1
    return out


ms_deform_attn_fwd.launches = 0


def _pairs(flat: Sequence[int]) -> Tuple[Tuple[int, int], ...]:
    return tuple((int(flat[i]), int(flat[i + 1])) for i in range(0, len(flat), 2))


# The sampling core as a custom op, so that torch.export traces it (with the
# fake below: the wrapper reads data_ptr(), which a fake tensor has not) and
# a CUDA graph captures it. spatial_shapes go in flat: [h0, w0, h1, w1, ...].
# Registered when this module is imported, so importing dfine_tpu_torch is
# what a process needs to load an exported program that calls it.
@torch.library.custom_op(
    "dfine_tpu_torch::ms_deform_attn_fwd", mutates_args=(), device_types="cuda",
    schema="(Tensor value, int[] spatial_shapes, Tensor loc, Tensor att, int[] num_points) -> Tensor")
def ms_deform_attn_op(value, spatial_shapes, loc, att, num_points):
    """The CUDA implementation: the hand-written kernel."""
    return ms_deform_attn_fwd(value, _pairs(spatial_shapes), loc, att, num_points)


@ms_deform_attn_op.register_kernel("cpu")
def _op_cpu(value, spatial_shapes, loc, att, num_points):
    return ms_deform_attn_fwd_plain(value, _pairs(spatial_shapes), loc, att, num_points)


@ms_deform_attn_op.register_fake
def _op_fake(value, spatial_shapes, loc, att, num_points):
    b, _, nhead, d = value.shape
    return value.new_empty((b, loc.shape[1], nhead * d), dtype=torch.float32)
