"""The exact Hungarian solver of the train step (``csrc/hungarian_lap.cu``),
the Hopper port of ``dfine_tpu/ops/hungarian.py::_solve_one`` (XLA, no
Pallas counterpart), beside its plain PyTorch version
(``ops/hungarian.py``).

``hungarian_lap`` launches the kernel for costs on the card, one CTA per
problem and every problem in one launch (each problem's valid cost rows
staged in shared memory, one warp walking its augmenting paths), and takes
the plain version only for costs on the CPU. Both return JAX's assignment,
element for element, and count the same path steps.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..hungarian import check_steps, hungarian
from . import _build

MAX_Q = 1024  # the columns the kernel takes (csrc: kMaxQ)
_ready = set()  # the devices on which the kernel's shared-memory limit is raised


def _fn(device: torch.device):
    """The launch function, with the kernel's dynamic shared-memory limit
    raised on ``device`` the first time it is asked for there (never at a
    launch, so that a launch can be captured in a CUDA graph)."""
    lib = _build.load("hungarian_lap")
    fn = lib.hungarian_lap
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 2
                       + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.hungarian_lap_init.restype = ctypes.c_int
    index = torch.cuda.current_device() if device.index is None else device.index
    if index not in _ready:
        with torch.cuda.device(index):
            rc = lib.hungarian_lap_init()
        if rc != 0:
            raise RuntimeError(f"hungarian_lap: raising its shared-memory limit failed: CUDA "
                               f"error {rc}")
        _ready.add(index)
    return fn


def _valid_rows(row_valid: Optional[torch.Tensor], lead, g: int):
    """row_valid as the kernel reads it: None (every row valid), or a
    contiguous bool [V, G] whose row p % V is problem p's. A mask whose
    shape is a suffix of [*lead, G] (the matcher's [B, G] over [S, B, G, Q])
    goes as it is; any other broadcast is made whole."""
    if row_valid is None:
        return None, 1
    rv = row_valid.to(torch.bool)
    full = (*lead, g)
    if not (rv.dim() <= len(full) and tuple(rv.shape) == full[len(full) - rv.dim():]
            and rv.is_contiguous()):
        rv = rv.broadcast_to(full).contiguous()
    return rv, max(1, rv.numel() // max(g, 1))


def hungarian_lap(cost: torch.Tensor, row_valid: Optional[torch.Tensor] = None,
                  steps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Batched exact min-cost assignment: cost [..., G, Q] with G <= Q,
    row_valid [..., G] bool (broadcast; None: every row). Returns col4row
    [..., G] int32, the column of each row, -1 on rows that are not valid.
    ``steps``, a contiguous int32 tensor of the costs' leading shape on
    their device, gets each problem's path steps (None on the train path).
    On a CUDA device it launches the kernel (Q up to ``MAX_Q``; f32
    row-major costs and a mask whose shape ends the costs' leading shape
    are read in place, so a call is the kernel alone), on the CPU the plain
    version runs. Nothing here reads the device: the call does not
    synchronise."""
    if cost.device.type == "cpu":
        return hungarian(cost, row_valid, steps)
    if cost.device.type != "cuda":
        raise ValueError(f"hungarian_lap: unsupported device {cost.device}")
    g, q = cost.shape[-2:]
    if g > q:
        raise ValueError(f"hungarian_lap takes G <= Q (rows no more than columns), got "
                         f"G = {g}, Q = {q}")
    if q > MAX_Q:
        raise ValueError(f"hungarian_lap: Q = {q} columns (the queries matched) is more than "
                         f"the kernel takes ({MAX_Q})")
    lead = tuple(cost.shape[:-2])
    flat = cost.detach().float().reshape(-1, g, q).contiguous()
    rv, period = _valid_rows(row_valid, lead, g)
    if rv is not None and rv.device != flat.device:
        raise ValueError("hungarian_lap: cost and row_valid must be on one device")
    check_steps(steps, lead, flat.device)
    p = flat.shape[0]
    out = torch.empty((p, g), dtype=torch.int32, device=flat.device)
    with torch.cuda.device(flat.device):
        stream = torch.cuda.current_stream(flat.device).cuda_stream
        rc = _fn(flat.device)(flat.data_ptr(), None if rv is None else rv.data_ptr(), period,
                              out.data_ptr(), None if steps is None else steps.data_ptr(),
                              p, g, q, stream)
    if rc != 0:
        raise RuntimeError(f"hungarian_lap kernel launch failed: CUDA error {rc}")
    if steps is not None and not g:
        steps.zero_()  # no row: no launch, no step
    if p and g:
        hungarian_lap.launches += 1
    return out.reshape(*lead, g)


hungarian_lap.launches = 0
