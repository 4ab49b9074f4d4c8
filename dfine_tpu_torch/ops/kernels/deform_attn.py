"""The deformable-attention kernels and their plain PyTorch versions:

- ``ms_deform_attn_fwd`` (``csrc/ms_deform_attn_fwd.cu``), the sampling
  core; its plain version is the gather formulation of
  ``dfine_tpu/ops/deform_attn.py:30-101``, step for step;
- ``ms_deform_attn_bwd`` (``csrc/ms_deform_attn_bwd.cu``), the closed-form
  backward of ``ms_deform_attn_core_fused``
  (``dfine_tpu/ops/deform_attn.py:306-434``, the corner tables at
  :235-241) for every level in one launch: the attention and location
  gradients, and each level's ``(idx, contrib)`` for the value-gradient
  scatter; its plain version is that closed form, step for step.

Each wrapper launches its CUDA kernel for tensors on the card and takes the
plain version only for tensors on the CPU. The CPU tests hold the plain
versions against JAX and ``chip_smoke.py`` holds the kernels against them
on the card.
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


# (dy, dx, weight, d weight / d fx, d weight / d fy) per bilinear corner
_CORNER_TABLE = (
    (0, 0, lambda fx, fy: (1 - fx) * (1 - fy), lambda fx, fy: -(1 - fy), lambda fx, fy: -(1 - fx)),
    (0, 1, lambda fx, fy: fx * (1 - fy), lambda fx, fy: (1 - fy), lambda fx, fy: -fx),
    (1, 0, lambda fx, fy: (1 - fx) * fy, lambda fx, fy: -fy, lambda fx, fy: (1 - fx)),
    (1, 1, lambda fx, fy: fx * fy, lambda fx, fy: fy, lambda fx, fy: fx),
)


def ms_deform_attn_bwd_plain(
    value: torch.Tensor,  # [B, sum(HW), nhead, d]
    spatial_shapes: Sequence[Tuple[int, int]],
    loc: torch.Tensor,  # [B, Q, nhead, sum(P), 2]
    att: torch.Tensor,  # [B, Q, nhead, sum(P)]
    g_out: torch.Tensor,  # [B, Q, nhead*d]
    num_points: Sequence[int],
    payload: torch.dtype = torch.float32,
    need_value: bool = True,
):
    """The closed-form backward of the sampling core. Returns (grad_att [B,
    Q, nhead, P] f32, grad_loc [B, Q, nhead, P, 2] f32, idx, contrib): with
    ``need_value``, one tensor a level in each, idx [B*nhead, 4*Q*P_l]
    int32 (-1 where the corner is off the map) and contrib [B*nhead,
    4*Q*P_l, d] in ``payload`` (f32, or each f32 product rounded once to
    bf16), entries corner-major, then query, then point; without, None and
    None. An out-of-map corner takes the clamped row's value in the
    location and attention gradients, times a weight of 0."""
    b, q = loc.shape[:2]
    nhead, d = value.shape[2], value.shape[3]
    f32 = torch.float32
    g = g_out.reshape(b, q, nhead, d).to(f32)
    att32 = att.to(f32)
    grad_loc = torch.zeros(loc.shape, dtype=f32, device=loc.device)
    grad_att = torch.zeros(att.shape, dtype=f32, device=att.device)
    idx_levels, contrib_levels = [], []
    hw_start = p_start = 0
    for (h, w), p in zip(spatial_shapes, num_points):
        hw = h * w
        v_t = value[:, hw_start : hw_start + hw].to(f32).permute(0, 2, 1, 3)  # [B,H,HW,D]
        l = loc[:, :, :, p_start : p_start + p].to(f32)
        a = att32[:, :, :, p_start : p_start + p]  # [B,Q,H,P]
        x = l[..., 0] * w - 0.5
        y = l[..., 1] * h - 0.5
        x0 = torch.floor(x)
        y0 = torch.floor(y)
        fx = x - x0
        fy = y - y0
        x0i = x0.long()
        y0i = y0.long()

        ga_l = torch.zeros_like(a)
        gfx = torch.zeros_like(a)
        gfy = torch.zeros_like(a)
        idx_parts, contrib_parts = [], []
        for dy, dx, w_fn, dwdx_fn, dwdy_fn in _CORNER_TABLE:
            xi = x0i + dx
            yi = y0i + dy
            valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
            idx = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)  # [B,Q,H,P]
            idx_t = idx.permute(0, 2, 1, 3).reshape(b, nhead, q * p, 1)
            vc = torch.gather(v_t, 2, idx_t.expand(-1, -1, -1, d))
            vc = vc.reshape(b, nhead, q, p, d).permute(0, 2, 1, 3, 4)  # [B,Q,H,P,D]
            g_dot_v = torch.einsum("bqhd,bqhpd->bqhp", g, vc)
            m = valid.to(f32)
            wgt = w_fn(fx, fy) * m
            ga_l = ga_l + wgt * g_dot_v
            gfx = gfx + m * dwdx_fn(fx, fy) * g_dot_v
            gfy = gfy + m * dwdy_fn(fx, fy) * g_dot_v
            if need_value:
                contrib = (a * wgt)[..., None] * g[:, :, :, None, :]  # [B,Q,H,P,D]
                idx_eff = torch.where(valid, idx, -1)
                idx_parts.append(idx_eff.permute(0, 2, 1, 3).reshape(b * nhead, q * p))
                contrib_parts.append(
                    contrib.permute(0, 2, 1, 3, 4).reshape(b * nhead, q * p, d).to(payload))
        grad_att[:, :, :, p_start : p_start + p] = ga_l
        grad_loc[:, :, :, p_start : p_start + p, 0] = a * gfx * w  # dx/du = W
        grad_loc[:, :, :, p_start : p_start + p, 1] = a * gfy * h
        if need_value:
            idx_levels.append(torch.cat(idx_parts, 1).to(torch.int32).contiguous())
            contrib_levels.append(torch.cat(contrib_parts, 1).contiguous())
        hw_start += hw
        p_start += p
    if not need_value:
        return grad_att, grad_loc, None, None
    return grad_att, grad_loc, idx_levels, contrib_levels


def _bwd_lib():
    fn = _build.load("ms_deform_attn_bwd").ms_deform_attn_bwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 9
                       + [ctypes.c_void_p, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def ms_deform_attn_bwd(
    value: torch.Tensor,
    spatial_shapes: Sequence[Tuple[int, int]],
    loc: torch.Tensor,
    att: torch.Tensor,
    g_out: torch.Tensor,
    num_points: Sequence[int],
    payload: torch.dtype = torch.float32,
    need_value: bool = True,
):
    """``ms_deform_attn_bwd_plain``'s function in one launch for every
    level: value [B, S, nhead, d] (bf16 or f32, d in HEAD_DIMS), loc [B, Q,
    nhead, P, 2] f32, att [B, Q, nhead, P] f32, g_out [B, Q, nhead*d] f32,
    all contiguous (value 16-byte and loc 8-byte aligned, as the forward
    takes them), P <= 16 over at most 4 levels; payload f32 or bf16.
    Returns the same tuple: the levels' idx and contrib are views into one
    allocation each, each level's block contiguous. idx equals the plain
    version's and contrib is bit-equal to it (every rounding of the
    contribution taken as its own op); the two gradients sum g.v over d in
    another order. CPU tensors take the plain version; CUDA tensors launch
    the kernel or raise."""
    if value.device.type == "cpu":
        return ms_deform_attn_bwd_plain(value, spatial_shapes, loc, att, g_out, num_points,
                                        payload, need_value)
    if value.device.type != "cuda":
        raise ValueError(f"ms_deform_attn_bwd: unsupported device {value.device}")
    b, s, nhead, d = value.shape
    q, p = loc.shape[1], loc.shape[3]
    if value.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"ms_deform_attn_bwd: value must be bf16 or f32, got {value.dtype}")
    if payload not in (torch.bfloat16, torch.float32):
        raise TypeError(f"ms_deform_attn_bwd: payload must be bf16 or f32, got {payload}")
    if d not in HEAD_DIMS:
        raise ValueError(f"ms_deform_attn_bwd: head dim {d} unsupported {HEAD_DIMS}")
    if loc.dtype != torch.float32 or att.dtype != torch.float32 or g_out.dtype != torch.float32:
        raise TypeError("ms_deform_attn_bwd: loc, att and g_out must be f32")
    if (tuple(loc.shape) != (b, q, nhead, p, 2) or tuple(att.shape) != (b, q, nhead, p)
            or tuple(g_out.shape) != (b, q, nhead * d)):
        raise ValueError(f"ms_deform_attn_bwd: shape mismatch: value {tuple(value.shape)}, loc "
                         f"{tuple(loc.shape)}, att {tuple(att.shape)}, g_out "
                         f"{tuple(g_out.shape)}")
    if sum(num_points) != p or len(num_points) != len(spatial_shapes):
        raise ValueError("ms_deform_attn_bwd: num_points must give one count per level "
                         "summing to P")
    if p > MAX_POINTS or len(spatial_shapes) > MAX_LEVELS:
        raise ValueError(f"ms_deform_attn_bwd: at most {MAX_POINTS} points and {MAX_LEVELS} "
                         f"levels, got {p} and {len(spatial_shapes)}")
    if sum(h * w for h, w in spatial_shapes) != s:
        raise ValueError("ms_deform_attn_bwd: spatial_shapes must cover the value rows")
    if not all(t.is_contiguous() for t in (value, loc, att, g_out)):
        raise ValueError("ms_deform_attn_bwd takes contiguous tensors")
    if value.data_ptr() % 16 or loc.data_ptr() % 8:
        raise ValueError("ms_deform_attn_bwd takes value 16-byte and loc 8-byte aligned")
    if any(t.device != value.device for t in (loc, att, g_out)):
        raise ValueError("ms_deform_attn_bwd: value, loc, att and g_out must be on one device")
    dev = value.device
    grad_att = torch.empty((b, q, nhead, p), dtype=torch.float32, device=dev)
    grad_loc = torch.empty((b, q, nhead, p, 2), dtype=torch.float32, device=dev)
    info, start = [], 0
    for (h, w), n in zip(spatial_shapes, num_points):
        info += [h, w, start, n]
        start += h * w
    info_c = (ctypes.c_int * len(info))(*info)
    idx_levels = contrib_levels = None
    idx_ptr = contrib_ptr = None
    if need_value:
        rows = b * nhead
        idx_all = torch.empty(rows * 4 * q * p, dtype=torch.int32, device=dev)
        contrib_all = torch.empty((rows * 4 * q * p, d), dtype=payload, device=dev)
        idx_levels, contrib_levels, first = [], [], 0
        for n in num_points:  # level l's block: rows x 4 Q P_l entries, after the levels before
            size = rows * 4 * q * n
            idx_levels.append(idx_all[first:first + size].view(rows, 4 * q * n))
            contrib_levels.append(contrib_all[first:first + size].view(rows, 4 * q * n, d))
            first += size
        idx_ptr, contrib_ptr = idx_all.data_ptr(), contrib_all.data_ptr()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _bwd_lib()(value.data_ptr(), loc.data_ptr(), att.data_ptr(), g_out.data_ptr(),
                        grad_att.data_ptr(), grad_loc.data_ptr(), idx_ptr, contrib_ptr,
                        b, s, q, nhead, d, p, int(value.dtype == torch.bfloat16),
                        int(payload == torch.bfloat16), len(spatial_shapes),
                        ctypes.cast(info_c, ctypes.c_void_p), stream)
    if rc != 0:
        raise RuntimeError(f"ms_deform_attn_bwd kernel launch failed: CUDA error {rc}")
    ms_deform_attn_bwd.launches += 1
    return grad_att, grad_loc, idx_levels, contrib_levels


ms_deform_attn_bwd.launches = 0


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
