"""The Hopper ports of the three row scatter-adds of
``dfine_tpu/ops/pallas/scatter_rows.py``, each beside its plain PyTorch
version. All compute out[r, idx[r, n], :] += contrib[r, n, :] with f32
accumulation, dropping entries with idx outside [0, hw):

- ``rows_scatter_add`` (replaces :64-97): f32 payload, summed per
  destination tile in shared memory (``csrc/rows_scatter_add_tile.cu``);
- ``rows_scatter_add_mxu`` (replaces :137-185): each contribution rounded
  once to bf16, the one-hot product of each destination tile's entries
  summed in f32 on the tensor cores (``csrc/rows_scatter_add_tile.cu``);
- ``rows_scatter_add_tiled`` (replaces :226-283): the same bf16 payload,
  counting-sorted by destination inside each tile and summed in increasing
  n (``csrc/rows_scatter_add_tile.cu``): bit-equal from run to run and to
  the CPU's plain version.

CPU tensors take the plain versions (``index_add_`` onto a padded row that
absorbs the dropped entries, the bf16 forms on the rounded payload); CUDA
tensors launch the kernel or raise.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

TILE_WIDTHS = (16, 32, 64)  # head dims the kernels take (n: 16, s/m/l/x: 32, wide tail: 64)


def rows_scatter_add_plain(idx: torch.Tensor, contrib: torch.Tensor, hw: int) -> torch.Tensor:
    """idx [R, N] int, contrib [R, N, D] -> out [R, hw, D] f32."""
    r, n = idx.shape
    d = contrib.shape[-1]
    safe = torch.where((idx >= 0) & (idx < hw), idx, hw).long()  # pad row hw
    rows = torch.arange(r, device=idx.device)[:, None] * (hw + 1)
    out = torch.zeros((r * (hw + 1), d), dtype=torch.float32, device=idx.device)
    out.index_add_(0, (rows + safe).reshape(-1), contrib.reshape(r * n, d).float())
    return out.view(r, hw + 1, d)[:, :hw].contiguous()


def rows_scatter_add_bf16_plain(idx: torch.Tensor, contrib: torch.Tensor,
                                hw: int) -> torch.Tensor:
    """The plain version of ``rows_scatter_add_mxu`` and ``_tiled``: the
    f32 sum of the contributions rounded once to bf16."""
    return rows_scatter_add_plain(idx, contrib.to(torch.bfloat16).float(), hw)


def _fn(source: str, name: str):
    fn = getattr(_build.load(source), name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check(name: str, idx: torch.Tensor, contrib: torch.Tensor, dtypes) -> None:
    if idx.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {idx.device}")
    if idx.dtype != torch.int32 or contrib.dtype not in dtypes:
        raise TypeError(f"{name}: idx must be int32 and contrib one of {dtypes}, "
                        f"got {idx.dtype}, {contrib.dtype}")
    if idx.dim() != 2 or contrib.dim() != 3 or tuple(contrib.shape[:2]) != tuple(idx.shape):
        raise ValueError(f"{name}: shape mismatch: idx {tuple(idx.shape)}, "
                         f"contrib {tuple(contrib.shape)}")
    if not (idx.is_contiguous() and contrib.is_contiguous()):
        raise ValueError(f"{name} takes contiguous tensors")
    if contrib.device != idx.device:
        raise ValueError(f"{name}: idx and contrib must be on one device")
    if contrib.shape[-1] not in TILE_WIDTHS:
        raise ValueError(f"{name}: D = {contrib.shape[-1]} not supported, only {TILE_WIDTHS}")
    if contrib.data_ptr() % 16:
        raise ValueError(f"{name}: contrib must be 16-byte aligned")


def _launch(name: str, source: str, entry: str, args, device) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = _fn(source, entry)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def rows_scatter_add(idx: torch.Tensor, contrib: torch.Tensor, hw: int) -> torch.Tensor:
    """Returns out [R, hw, D] f32 with out[r, idx[r, n]] += contrib[r, n]
    (f32 payload); entries with idx outside [0, hw) are dropped."""
    if idx.device.type == "cpu":
        return rows_scatter_add_plain(idx, contrib, hw)
    _check("rows_scatter_add", idx, contrib, (torch.float32,))
    r, n = idx.shape
    d = contrib.shape[-1]
    out = torch.empty((r, hw, d), dtype=torch.float32, device=idx.device)
    _launch("rows_scatter_add", "rows_scatter_add_tile", "rows_scatter_add",
            (idx.data_ptr(), contrib.data_ptr(), out.data_ptr(), r, n, hw, d), idx.device)
    rows_scatter_add.launches += 1
    return out


def rows_scatter_add_mxu(idx: torch.Tensor, contrib: torch.Tensor, hw: int) -> torch.Tensor:
    """As ``rows_scatter_add`` with each contribution rounded once to bf16
    (``contrib`` may come in f32 or already in bf16) and f32 accumulation:
    the one-hot products on the tensor cores, no atomics, so the sums come
    in one order for given inputs (not the CPU's). A non-finite payload
    element is not kept to its own destination: since 0 x inf is NaN, it
    turns its column NaN in all 16 destination rows of its tile that one
    warp owns (rows [16 k, 16 k + 16) of each 128-row tile); rows outside
    that slice stay as finite as their own entries."""
    if idx.device.type == "cpu":
        return rows_scatter_add_bf16_plain(idx, contrib, hw)
    _check("rows_scatter_add_mxu", idx, contrib, (torch.float32, torch.bfloat16))
    payload = contrib.to(torch.bfloat16)
    r, n = idx.shape
    d = contrib.shape[-1]
    out = torch.empty((r, hw, d), dtype=torch.float32, device=idx.device)
    _launch("rows_scatter_add_mxu", "rows_scatter_add_tile", "rows_scatter_add_mxu",
            (idx.data_ptr(), payload.data_ptr(), out.data_ptr(), r, n, hw, d), idx.device)
    rows_scatter_add_mxu.launches += 1
    return out


def rows_scatter_add_tiled(idx: torch.Tensor, contrib: torch.Tensor, hw: int) -> torch.Tensor:
    """As ``rows_scatter_add_mxu`` (bf16 payload, f32 accumulation) but
    deterministic: each output element is the sum of its entries in
    increasing n, with no atomics. Two runs give bit-equal output, equal to
    the CPU's ``rows_scatter_add_bf16_plain``."""
    if idx.device.type == "cpu":
        return rows_scatter_add_bf16_plain(idx, contrib, hw)
    _check("rows_scatter_add_tiled", idx, contrib, (torch.float32, torch.bfloat16))
    payload = contrib.to(torch.bfloat16)
    r, n = idx.shape
    d = contrib.shape[-1]
    out = torch.empty((r, hw, d), dtype=torch.float32, device=idx.device)
    _launch("rows_scatter_add_tiled", "rows_scatter_add_tile", "rows_scatter_add_tiled",
            (idx.data_ptr(), payload.data_ptr(), out.data_ptr(), r, n, hw, d), idx.device)
    rows_scatter_add_tiled.launches += 1
    return out


rows_scatter_add.launches = 0
rows_scatter_add_mxu.launches = 0
rows_scatter_add_tiled.launches = 0
