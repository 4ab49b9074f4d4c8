"""The Hopper port of ``rows_scatter_add`` (``csrc/rows_scatter_add.cu``)
and its plain PyTorch version.

Replaces ``dfine_tpu/ops/pallas/scatter_rows.py::rows_scatter_add``
(:64-97): out[r, idx[r, n], :] += contrib[r, n, :] with an f32 payload and
f32 accumulation; ``idx < 0`` is dropped. CPU tensors take the plain
version (``index_add_`` onto a padded row that absorbs the dropped
entries); CUDA tensors launch the kernel or raise.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build


def rows_scatter_add_plain(idx: torch.Tensor, contrib: torch.Tensor, hw: int) -> torch.Tensor:
    """idx [R, N] int, contrib [R, N, D] -> out [R, hw, D] f32."""
    r, n = idx.shape
    d = contrib.shape[-1]
    safe = torch.where((idx >= 0) & (idx < hw), idx, hw).long()  # pad row hw
    rows = torch.arange(r, device=idx.device)[:, None] * (hw + 1)
    out = torch.zeros((r * (hw + 1), d), dtype=torch.float32, device=idx.device)
    out.index_add_(0, (rows + safe).reshape(-1), contrib.reshape(r * n, d).float())
    return out.view(r, hw + 1, d)[:, :hw].contiguous()


def _lib():
    fn = _build.load("rows_scatter_add").rows_scatter_add
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def rows_scatter_add(idx: torch.Tensor, contrib: torch.Tensor, hw: int) -> torch.Tensor:
    """Returns out [R, hw, D] f32 with out[r, idx[r, n]] += contrib[r, n];
    entries with idx outside [0, hw) are dropped."""
    if idx.device.type == "cpu":
        return rows_scatter_add_plain(idx, contrib, hw)
    if idx.device.type != "cuda":
        raise ValueError(f"rows_scatter_add: unsupported device {idx.device}")
    if idx.dtype != torch.int32 or contrib.dtype != torch.float32:
        raise TypeError(f"idx must be int32 and contrib f32, got {idx.dtype}, {contrib.dtype}")
    if idx.dim() != 2 or contrib.dim() != 3 or tuple(contrib.shape[:2]) != tuple(idx.shape):
        raise ValueError(f"shape mismatch: idx {tuple(idx.shape)}, contrib {tuple(contrib.shape)}")
    if not (idx.is_contiguous() and contrib.is_contiguous()):
        raise ValueError("rows_scatter_add takes contiguous tensors")
    if contrib.device != idx.device:
        raise ValueError("idx and contrib must be on one device")
    r, n = idx.shape
    d = contrib.shape[-1]
    out = torch.zeros((r, hw, d), dtype=torch.float32, device=idx.device)
    with torch.cuda.device(idx.device):
        stream = torch.cuda.current_stream(idx.device).cuda_stream
        rc = _lib()(idx.data_ptr(), contrib.data_ptr(), out.data_ptr(), r, n, hw, d, stream)
    if rc != 0:
        raise RuntimeError(f"rows_scatter_add kernel launch failed: CUDA error {rc}")
    rows_scatter_add.launches += 1
    return out


rows_scatter_add.launches = 0
