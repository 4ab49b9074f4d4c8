"""The Hopper ports of the three row scatter-adds of
``dfine_tpu/ops/pallas/scatter_rows.py``, each beside its plain PyTorch
version. All compute out[r, idx[r, n], :] += contrib[r, n, :] with f32
accumulation, dropping entries with idx outside [0, hw):

- ``rows_scatter_add`` (replaces :64-97): f32 payload, fp32 atomics
  (``csrc/rows_scatter_add.cu``);
- ``rows_scatter_add_mxu`` (replaces :137-185): each contribution rounded
  once to bf16, fp32 atomics (``csrc/rows_scatter_add.cu``, bf16 entry);
- ``rows_scatter_add_tiled`` (replaces :226-283): the same bf16 payload,
  sorted by destination with a stable sort, then a segmented reduction with
  no atomics (``csrc/rows_scatter_add_sorted.cu``): deterministic.

CPU tensors take the plain versions (``index_add_`` onto a padded row that
absorbs the dropped entries, the bf16 forms on the rounded payload); CUDA
tensors launch the kernel or raise.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

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
    out = torch.zeros((r, hw, d), dtype=torch.float32, device=idx.device)
    _launch("rows_scatter_add", "rows_scatter_add", "rows_scatter_add",
            (idx.data_ptr(), contrib.data_ptr(), out.data_ptr(), r, n, hw, d), idx.device)
    rows_scatter_add.launches += 1
    return out


def rows_scatter_add_mxu(idx: torch.Tensor, contrib: torch.Tensor, hw: int) -> torch.Tensor:
    """As ``rows_scatter_add`` with each contribution rounded once to bf16
    (``contrib`` may come in f32 or already in bf16) and f32 accumulation."""
    if idx.device.type == "cpu":
        return rows_scatter_add_bf16_plain(idx, contrib, hw)
    _check("rows_scatter_add_mxu", idx, contrib, (torch.float32, torch.bfloat16))
    payload = contrib.to(torch.bfloat16)
    r, n = idx.shape
    d = contrib.shape[-1]
    out = torch.zeros((r, hw, d), dtype=torch.float32, device=idx.device)
    _launch("rows_scatter_add_mxu", "rows_scatter_add", "rows_scatter_add_bf16",
            (idx.data_ptr(), payload.data_ptr(), out.data_ptr(), r, n, hw, d), idx.device)
    rows_scatter_add_mxu.launches += 1
    return out


def sort_by_destination(idx: torch.Tensor, contrib: torch.Tensor,
                        hw: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The wrapper's half of ``rows_scatter_add_tiled``: the bf16 payload
    in destination order (a *stable* sort, dropped entries keyed ``hw`` so
    they sort last and fall in no run) and the run start of every
    destination row, start [R, hw + 1] int32."""
    r = idx.shape[0]
    key = torch.where((idx >= 0) & (idx < hw), idx, hw)
    # torch.sort is not stable by default on CUDA: equal keys in a varying
    # order would make the sums vary in their low bits from run to run
    key_s, order = torch.sort(key, dim=1, stable=True)
    payload = torch.gather(contrib.to(torch.bfloat16), 1,
                           order[..., None].expand(-1, -1, contrib.shape[-1]))
    rows = torch.arange(hw + 1, dtype=key_s.dtype, device=idx.device).expand(r, hw + 1)
    start = torch.searchsorted(key_s.contiguous(), rows.contiguous(), side="left")
    return payload, start.to(torch.int32)


def segment_sum_sorted(payload: torch.Tensor, start: torch.Tensor, hw: int) -> torch.Tensor:
    """The kernel's half of ``rows_scatter_add_tiled``: out[r, j] = the f32
    sum of payload[r, start[r, j]:start[r, j + 1]] in order."""
    r, n, d = payload.shape
    if payload.dtype != torch.bfloat16 or start.dtype != torch.int32:
        raise TypeError("segment_sum_sorted takes a bf16 payload and int32 starts")
    if tuple(start.shape) != (r, hw + 1) or not (payload.is_contiguous() and start.is_contiguous()):
        raise ValueError(f"segment_sum_sorted: start {tuple(start.shape)} for payload "
                         f"{tuple(payload.shape)}, hw {hw}, both contiguous")
    out = torch.empty((r, hw, d), dtype=torch.float32, device=payload.device)
    _launch("rows_scatter_add_tiled", "rows_scatter_add_sorted", "rows_scatter_add_sorted",
            (payload.data_ptr(), start.data_ptr(), out.data_ptr(), r, n, hw, d),
            payload.device)
    return out


def rows_scatter_add_tiled(idx: torch.Tensor, contrib: torch.Tensor, hw: int) -> torch.Tensor:
    """As ``rows_scatter_add_mxu`` (bf16 payload, f32 accumulation) but
    deterministic: sort by destination, then sum each destination row's run
    in order, with no atomics. Two runs give bit-equal output."""
    if idx.device.type == "cpu":
        return rows_scatter_add_bf16_plain(idx, contrib, hw)
    _check("rows_scatter_add_tiled", idx, contrib, (torch.float32, torch.bfloat16))
    out = segment_sum_sorted(*sort_by_destination(idx, contrib, hw), hw)
    rows_scatter_add_tiled.launches += 1
    return out


rows_scatter_add.launches = 0
rows_scatter_add_mxu.launches = 0
rows_scatter_add_tiled.launches = 0
