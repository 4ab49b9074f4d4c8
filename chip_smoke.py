#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (``dfine_tpu_torch``) on one NVIDIA card.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each printed as one JSON line:

1. build: every hand-written kernel from ``dfine_tpu_torch/csrc`` (one nvcc
   per source, started together), with each kernel's registers and spills
   and the atomic opcodes in its SASS (none in the tensor-core scatter);
2. kernels: each kernel against its plain PyTorch version on the card at the
   shapes of D-FINE-m at 640 px (TF32 off), with its time, the plain
   version's, one PyTorch call's where one computes the same function, and
   the least time the card could take (bound); the deformable-attention
   kernel also beside the time of a launch of it with no work. The three
   row scatter-adds
   (the value gradient of the deformable attention: ``rows_scatter_add``,
   ``_mxu`` and ``_tiled``) run at the train step's shapes and at head dim
   16, ``_tiled`` also bit for bit against its plain version on the CPU;
3. model: the m det+seg model on the card, fp32, against the same weights
   on the CPU through the plain path;
4. serving: ``TorchModel`` (m det+seg, bf16) answers 720p BGR frames, with
   the deformable-attention kernel's launch count read around the run;
5. gradient: one backward of the m det+seg model at batch 8, through the
   ``MSDeformAttnCore`` backward and its scatter kernel, counts read around it;
6. train: the m detect train step (``make_train_step``: CDN queries,
   Hungarian matching, criterion, AdamW, EMA) at 640 px, batch 8, bf16
   autocast over fp32 parameters, with its kernel launches counted per step;
7. scatter_in_situ: the three row scatter-adds and ``index_add_`` on the
   inputs that one more train step gives the default backward, with how
   their destinations cluster;
8. train_bwd_variants: one step each with ``set_deform_bwd("mxu")`` and
   ``("tiled")`` against the default on the same weights, batch and noise,
   each parameter's gradient against its own default, beside two more
   default steps as the controls;
9. train_parity: one fp32 step on the card against the same step on the CPU:
   losses, grad norm, the updated parameters and AdamW's first moment;
10. train_seg: the m det+seg train step (the ``masks`` loss on GT ellipses
    [8, 100, 160, 160]) at 640 px, batch 8, bf16, with its launches per
    step, every mask term of every set, the mask head's parameters and EMA
    moved, and a profile with the device ms of the mask-logit products;
11. train_seg_parity: ``train_parity`` for the det+seg step, at two batch
    seeds;
12. train_l_frozen: the l detect step with the trainer's l options (freeze
    mask, per-group learning-rate peaks, ``b_accum_steps = 2``), batch 4,
    bf16: frozen parameters, micro-steps, EMA and learning rates checked
    over 4 micro-steps, then 8 timed and a profile.

Then one ``{"kernels": [...]}`` line, the card's name and power limit as
nvidia-smi gives them, and, if every phase passed, the last line
``{"ok": true, "device": {...}}``. Without a CUDA device, or outside a
checkout of the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import copy
import json
import math
import os
import re
import subprocess
import sys
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

import numpy as np

DEV = "cuda"
SIZE, IMG, NUM_CLASSES = "m", 640, 80
M_SHAPES, M_POINTS = ((80, 80), (40, 40), (20, 20)), (3, 6, 3)  # m@640: levels, points
N_SHAPES, N_POINTS = ((40, 40), (20, 20)), (6, 6)  # n@640 (head dim 16)
QUERIES, HEADS, HEAD_DIM = 300, 8, 32
GRAD_BATCH = 8
# the train step (tools/profile_train.py:212): G = 100 GT slots give one CDN
# group of 200 queries beside the 300 matching ones
TRAIN_BATCH, TRAIN_G, TRAIN_BOXES = 8, 100, (5, 40)
TRAIN_QUERIES = 2 * TRAIN_G + QUERIES
TRAIN_WARMUP, TRAIN_STEPS = 2, 10
MASK_HW = (IMG // 4, IMG // 4)  # the mask head's stride 4 at m
# the l detect step with the trainer's l options: 4 micro-steps checked, 8 timed
L_SIZE, L_BATCH, L_ACCUM, L_CHECKED, L_TIMED, L_DECODER_LAYERS = "l", 4, 2, 4, 8, 6
PARITY_BATCH, PARITY_SEEDS = 2, range(5)
SERVE_WARMUP, SERVE_FRAMES, SERVE_KEEP = 5, 30, 20
DECODER_LAYERS = 4  # m: num_layers, eval_idx = -1
# one H100 SXM (NVIDIA data sheet, dense rates): HBM bytes/s, fp32 FLOP/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
FWD_TOL = 1e-5
SCATTER_ATOL, SCATTER_RTOL = 1e-4, 1e-5
BF16_SCATTER_ATOL, BF16_SCATTER_RTOL = 1e-5, 1e-6  # test_pallas_scatter.py:48, :165
# mxu/tiled train step against the default, per parameter tensor: the norm
# of the gradient difference within VARIANT_GRAD_REL of the norm of the
# tensor's default gradient, plus twice the larger of two controls, each the
# same share for a second and a third default step (test_pallas_scatter.py
# :139-141 allows rtol 5e-2, atol 2e-2 elementwise). The default itself is
# not deterministic: atomics and cuDNN's backward reorder sums, and under
# bf16 autocast a reordered sum may round to another bf16 value, which the
# rest of the bf16 backward carries on (on the H100, two bf16 default steps
# differ in the median tensor by 1.5 % of that tensor's norm).
VARIANT_GRAD_REL = {"fp32": 3e-2, "bf16": 5e-2}
# A tensor is exempt when (a) its fp32 default gradient is nought: its RMS
# under ROUNDING_SHARE of the RMS over all parameters. These are the LAB and
# norm parameters whose effect a following train-mode BatchNorm removes (the
# gradient cancels to rounding), and the layers ahead of the
# zero-initialized last layer of a box or quality head (zero at the start);
# NOUGHT_PARTS names these kinds, and any other tensor the rule finds fails
# the run. Or (c) when it has one element (the LAB scales and biases, and
# the output biases of the quality heads): its gradient is one sum over a
# whole feature map or over all queries, so that two controls do not bound
# its noise (on the H100, these moved by up to 8.6 % in two fp32 controls
# and by 21 % in the fp32 mxu step; under bf16 by up to 6 times their norm
# in the controls). Their readings are printed; they are held against JAX
# by tests/test_torch_port_train_step.py and card against CPU by
# train_parity and train_seg_parity.
ROUNDING_SHARE, CONTROLS = 5e-4, 2
NOUGHT_PARTS = (".lab.", "norm", ".bn.", "bbox_head", "reg_conf")
# fp32 train step, card against CPU: loss terms, grad norm, updated parameters
PARITY_LOSS_RTOL, PARITY_LOSS_ATOL, PARITY_GNORM_RTOL = 2e-4, 1e-6, 2e-3
# AdamW's first step moves an element by lr * g / (|g| + 1e-8), so the two
# sides' updates differ beyond PARITY_STEP_ATOL only where the first moments
# differ in sign or one is within FLIP_MU_FLOOR of 0; any other such element
# fails the run. The share of such sign changes: detect 0.25 % on the H100;
# det+seg 0.49 % and 0.58 % at two batch seeds, where the backbone's first
# moments, fed by the mask losses, differ more (1.9 % at most).
PARITY_STEP_ATOL, FLIP_MU_FLOOR = 2e-6, 1e-7
PARITY_FAR_SHARE = {"detect": 0.005, "det+seg": 0.01}
# AdamW's first moment (0.1 x the clipped gradient) card against CPU, per
# parameter outside rule (a): the share of the norm of the CPU's. The
# location gradient of the deformable attention is piecewise constant and
# jumps at pixel edges, and the two devices place a few sampling points on
# either side of one, so the ``sampling_offsets`` get their own limit (6.4 %
# at most on the H100; the other leaves 1.9 %, the one-element output biases
# of the quality heads 0.04 %).
PARITY_MU_REL = {"tensor": 3e-2, "sampling_offsets": 0.1}
# A LAB parameter's gradient is one sum over a whole feature map whose terms
# cancel: on the H100 the stride-4 LAB scale that the mask losses reach kept
# 1/129663 of its terms' magnitude, and its sum came 1.90 times the CPU's
# apart while its terms agreed within 1.1 %. So each LAB parameter is held by
# its terms (``lab_terms``): within the "tensor" limit, the gap of their sums
# within that limit of their magnitude, and each side's sum its first moment
# within TERMS_SUM_RTOL plus a float32 sum's rounding bound.
TERMS_SUM_RTOL = 1e-2
SEG_PARITY_SEEDS = 2  # the det+seg parity runs at two batch seeds
GRAD_REL_TOL = 2e-4  # test_pallas_scatter.py:69-78
TILE_ROWS = 128  # destination rows a CTA of csrc/rows_scatter_add_tile.cu (kTile)
BOX_ATOL, MIN_MATCHED = 1e-3, 0.98
MODEL_ATOL = 1e-4  # logits and masks of matched queries, fp32 card vs CPU


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def sync() -> None:
    import torch

    torch.cuda.synchronize()


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean time of ``fn`` on the card, by CUDA events around ``iters`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_ms(prof, iters: int) -> float:
    """Device time per iteration in a profiler window: the sum of the CUDA
    activities (kernels, memsets, copies) it recorded, over ``iters``."""
    us = sum(e.self_device_time_total for e in _device_rows(prof))
    return us / 1e3 / iters


def _device_rows(prof):
    """The CUDA activities of a profiler window (kernels, memsets, copies),
    without the spans of user annotations such as ``Optimizer.step``, which
    cover kernels already counted."""
    import torch

    return [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def device_ms(fn, iters: int = 50, warmup: int = 5):
    """Mean device time of one call of ``fn`` (torch.profiler's CUDA
    activities), or None when the profiler saw no device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    ms = _device_ms(prof, iters)
    return ms if ms > 0 else None


def profile_window(fn, n: int, top: int = 8) -> dict:
    """``n`` calls of ``fn`` under torch.profiler: wall time per call (the
    profiler's own cost included), device busy time per call (the sum of the
    CUDA activities: one stream, so they do not overlap), the idle share, and
    the ``top`` device activities by time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    rows = sorted(_device_rows(prof), key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in rows) / 1e3 / n
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "idle_share": 1.0 - busy_ms / wall_ms,
            "device_activities_per_call": sum(e.count for e in rows) / n,
            "top": [{"name": e.key[:90], "ms_per_call": e.self_device_time_total / 1e3 / n,
                     "count_per_call": e.count / n} for e in rows[:top]],
            "ours": {e.key: {"ms_per_launch": e.self_device_time_total / 1e3 / e.count,
                             "count_per_call": e.count / n}
                     for e in rows
                     if "ms_deform_attn_fwd_kernel" in e.key or "rows_scatter_add" in e.key}}


def timings(prefix: str, fn, iters: int) -> dict:
    """``<prefix>ms``: device time per call (profiler; CUDA events when the
    profiler sees no device time, as ``<prefix>ms_by`` says);
    ``<prefix>call_ms``: CUDA events around back-to-back calls, so the host
    side of the call is in it wherever it is the slower side."""
    call = cuda_ms(fn, iters=iters)
    dev = device_ms(fn, iters=iters)
    return {f"{prefix}ms": call if dev is None else dev,
            f"{prefix}ms_by": "events" if dev is None else "profiler",
            f"{prefix}call_ms": call}


def bound(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def percentiles(times_s):
    ms = np.asarray(times_s) * 1e3
    return float(np.percentile(ms, 50)), float(np.percentile(ms, 90))


def align_by_box(ref_boxes: np.ndarray, our_boxes: np.ndarray) -> np.ndarray:
    """A 1:1 assignment of the rows of ``ref`` to rows of ``ours`` by box
    identity, greedy on the L1 box distance: top-k may permute near-tied
    queries, and queries drawn from equal memory rows have equal boxes.
    Returns ``match``: ref row i <-> our row match[i]."""
    cost = np.abs(ref_boxes[:, None, :] - our_boxes[None, :, :]).sum(-1)
    match = np.full(len(ref_boxes), -1)
    used = np.zeros(len(our_boxes), bool)
    left = len(ref_boxes)
    for flat in np.argsort(cost, axis=None, kind="stable"):
        i, j = divmod(int(flat), cost.shape[1])
        if match[i] < 0 and not used[j]:
            match[i], used[j] = j, True
            left -= 1
            if not left:
                break
    return match


def randomize_(model, seed: int) -> None:
    """Re-draw every weight from ``seed`` so no layer is trivial: weights
    U(+-1/sqrt(fan_in)), biases U(+-0.1), norm scales U(0.8, 1.2), BN means
    N(0, 0.1), variances U(0.5, 1.5)."""
    import torch

    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if name.endswith("num_batches_tracked"):
                continue
            if name.endswith("running_mean"):
                t.normal_(0.0, 0.1, generator=g)
            elif name.endswith("running_var"):
                t.uniform_(0.5, 1.5, generator=g)
            elif t.dim() == 1 and name.endswith((".weight", ".scale")):
                t.uniform_(0.8, 1.2, generator=g)
            elif t.dim() >= 2:
                b = 1.0 / math.sqrt(t[0].numel())
                t.uniform_(-b, b, generator=g)
            else:
                t.uniform_(-0.1, 0.1, generator=g)


# ------------------------------------------------------------------ phases --


def ptxas_by_kernel(log: str) -> dict:
    """nvcc's -Xptxas -v lines (registers, spills, shared memory) by kernel,
    under its mangled name."""
    out, cur = {}, None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            cur = out.setdefault(entry.group(1), [])
        elif cur is not None and ("registers" in line or "spill" in line):
            cur.append(line.split("ptxas info    :")[-1].strip())
    return {k: "; ".join(v) for k, v in out.items()}


def phase_build(res):
    from dfine_tpu_torch.ops.kernels import _build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(_build.SOURCES)) as pool:  # one nvcc per source, together
        list(pool.map(_build.load, _build.SOURCES))
    ptxas = {n: ptxas_by_kernel(log) for n, log in _build.build_logs.items()}
    atomics = sass_atomics()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "built": sorted(_build.build_logs), "ptxas": ptxas, "sass_atomics": atomics})
    # the mma scatter sums on the tensor cores: no atomic in its own functions
    mma = {f: o for f, o in atomics["rows_scatter_add_tile"].items()
           if "rows_scatter_add_mma_kernel" in f}
    if not mma or any(mma.values()):
        raise AssertionError(f"rows_scatter_add_mma_kernel SASS atomics: {mma or 'not found'}")


def sass_atomics() -> dict:
    """The atomic opcodes in the SASS (cuobjdump) of each kernel function of
    each built library, e.g. a native shared-memory add or a compare-and-swap
    loop: {library: {mangled kernel name: [opcodes]}}. Raises where the
    toolkit has no cuobjdump: the mma scatter's lack of atomics is then not
    checked."""
    import shutil

    from dfine_tpu_torch.ops.kernels import _build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        raise FileNotFoundError(f"cuobjdump not found ({tool}): SASS atomics cannot be checked")
    out = {}
    for name in _build.SOURCES:
        sass = subprocess.run([tool, "-sass", str(_build.BUILD_DIR / f"lib{name}.so")],
                              capture_output=True, text=True, timeout=120, check=True).stdout
        funcs, ops = {}, None
        for line in sass.splitlines():
            if "Function :" in line:
                ops = funcs.setdefault(line.split("Function :", 1)[1].strip(), set())
            elif ops is not None:
                ops.update(w for w in line.split() if w.startswith(("ATOM", "RED.")))
        out[name] = {f: sorted(o) for f, o in funcs.items()}
    return out


def _deform_inputs(dev, b, d, shapes, pts, value_dtype, seed, lo=-0.15, hi=1.15, q=QUERIES):
    import torch

    rng = np.random.default_rng(seed)
    s, p = sum(h * w for h, w in shapes), sum(pts)
    value = torch.from_numpy(rng.normal(size=(b, s, HEADS, d)).astype(np.float32))
    loc = torch.from_numpy(rng.uniform(lo, hi, (b, q, HEADS, p, 2)).astype(np.float32))
    att = torch.from_numpy(rng.normal(size=(b, q, HEADS, p)).astype(np.float32))
    return value.to(dev, value_dtype), loc.to(dev), att.softmax(-1).to(dev)


def _deform_bound(v, l, a, shapes=M_SHAPES, pts=M_POINTS):
    """The least time for this run's data: loc, att and the output once, and
    of the value only the distinct (b, row, head) rows that a valid corner
    of ``l`` reads (found as the plain version finds its corners); an FMA a
    channel for each valid corner and each point's att."""
    import torch

    b, q, heads = l.shape[:3]
    s, d = v.shape[1], v.shape[3]
    keys, corners, start, p0 = [], 0, 0, 0
    for (h, w), p in zip(shapes, pts):
        lv = l[:, :, :, p0:p0 + p].float()
        x0 = torch.floor(lv[..., 0] * w - 0.5).long()
        y0 = torch.floor(lv[..., 1] * h - 0.5).long()
        head = torch.arange(heads, device=l.device)[None, None, :, None]
        batch = torch.arange(b, device=l.device)[:, None, None, None]
        for dy in (0, 1):
            for dx in (0, 1):
                xi, yi = x0 + dx, y0 + dy
                valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
                key = (batch * s + start + yi * w + xi) * heads + head
                keys.append(key[valid])
                corners += int(valid.sum().item())
        start += h * w
        p0 += p
    rows = torch.unique(torch.cat(keys)).numel()
    nbytes = (rows * d * v.element_size() + l.numel() * 4 + a.numel() * 4
              + b * q * heads * d * 4)
    flops = corners * 2 * d + a.numel() * 2 * d
    return bound(nbytes, flops)


def _empty_deform_launch():
    """A call that launches ``ms_deform_attn_fwd_kernel`` with no items."""
    import ctypes

    import torch

    from dfine_tpu_torch.ops.kernels import _build

    fn = _build.load("ms_deform_attn_fwd").ms_deform_attn_fwd_empty
    fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_int

    def call():
        if fn(torch.cuda.current_stream().cuda_stream):
            raise RuntimeError("empty launch of ms_deform_attn_fwd_kernel failed")
    return call


def phase_deform_fwd(res):
    import torch

    from dfine_tpu_torch.ops.kernels.deform_attn import ms_deform_attn_fwd, ms_deform_attn_fwd_plain

    dev = torch.device(DEV)
    checks, max_err = [], 0.0
    for d, shapes, pts in ((HEAD_DIM, M_SHAPES, M_POINTS), (16, N_SHAPES, N_POINTS)):
        for dtype in (torch.float32, torch.bfloat16):
            v, l, a = _deform_inputs(dev, 2, d, shapes, pts, dtype, seed=d)
            err = (ms_deform_attn_fwd(v, shapes, l, a, pts)
                   - ms_deform_attn_fwd_plain(v, shapes, l, a, pts)).abs().max().item()
            checks.append({"d": d, "value": str(dtype).split(".")[1], "max_abs_err": err})
            max_err = max(max_err, err)
            if not err <= FWD_TOL:
                raise AssertionError(f"deform fwd d={d} {dtype}: max err {err} > {FWD_TOL}")
    v, l, a = _deform_inputs(dev, 1, HEAD_DIM, M_SHAPES, M_POINTS, torch.bfloat16, seed=3)
    far = torch.tensor([-0.6, 1.7, -1e9, 1e9], device=dev)
    l_far = far[torch.randint(0, 4, l.shape, device=dev)]
    nonzero = torch.count_nonzero(ms_deform_attn_fwd(v, M_SHAPES, l_far, a, M_POINTS)).item()
    checks.append({"case": "out_of_range", "nonzero": nonzero})
    if nonzero:
        raise AssertionError(f"out-of-range locations gave {nonzero} nonzero outputs")

    # timing at the serving shape: m@640, B=1, bf16 value, locations in the map;
    # beside it the floor of any launch: the same kernel launched with no items
    v, l, a = _deform_inputs(dev, 1, HEAD_DIM, M_SHAPES, M_POINTS, torch.bfloat16, 4, 0.0, 1.0)
    t = {**timings("", lambda: ms_deform_attn_fwd(v, M_SHAPES, l, a, M_POINTS), 200),
         **timings("plain_", lambda: ms_deform_attn_fwd_plain(v, M_SHAPES, l, a, M_POINTS), 20),
         **timings("empty_launch_", _empty_deform_launch(), 200)}
    bound_ms, bound_by = _deform_bound(v, l, a)
    res["deform"] = {"max_abs_err": max_err, **t, "bound_ms": bound_ms, "bound_by": bound_by,
                     "checks": checks}
    emit({"phase": "kernel_ms_deform_attn_fwd", "shape": "m@640 B=1 bf16 value",
          **res["deform"]})

    # the train step's shape: B = 8, 500 queries (200 CDN + 300), bf16 value
    v, l, a = _deform_inputs(dev, TRAIN_BATCH, HEAD_DIM, M_SHAPES, M_POINTS, torch.bfloat16, 6,
                             0.0, 1.0, q=TRAIN_QUERIES)
    err = (ms_deform_attn_fwd(v, M_SHAPES, l, a, M_POINTS)
           - ms_deform_attn_fwd_plain(v, M_SHAPES, l, a, M_POINTS)).abs().max().item()
    if not err <= FWD_TOL:
        raise AssertionError(f"deform fwd at the train shape: max err {err} > {FWD_TOL}")
    bound_ms, bound_by = _deform_bound(v, l, a)
    res["deform_train"] = {
        "max_abs_err": err,
        **timings("", lambda: ms_deform_attn_fwd(v, M_SHAPES, l, a, M_POINTS), 100),
        **timings("plain_", lambda: ms_deform_attn_fwd_plain(v, M_SHAPES, l, a, M_POINTS), 10),
        "bound_ms": bound_ms, "bound_by": bound_by}
    emit({"phase": "kernel_ms_deform_attn_fwd_train",
          "shape": f"m@640 B={TRAIN_BATCH} Q={TRAIN_QUERIES} bf16 value", **res["deform_train"]})


def _kernels_of(fn) -> list:
    """The device activities of one call of ``fn`` (torch.profiler), by name.
    A profiler window in which CUPTI recorded no device activity at all (it
    can drop a whole window when windows follow each other closely) is taken
    again, up to three windows, as ``tests/test_torch_port_cuda.py`` does."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = sorted(e.key for e in _device_rows(prof) for _ in range(e.count))
        if names:
            break
    return names


def _scatter(res, name):
    """A row scatter-add kernel against its plain version at the train
    step's shapes (f32 payload for ``rows_scatter_add``, bf16 for ``_mxu``
    and ``_tiled``), with the edge cases, the device activities of one call
    and the times of one backward. ``_tiled`` is also held bit for bit
    against the plain version on the CPU and against its own second run;
    for ``_mxu`` the script reports whether two runs are bit-equal."""
    import torch

    from dfine_tpu_torch.ops.kernels import scatter_rows as sr

    fn = getattr(sr, name)
    f32 = name == "rows_scatter_add"
    tiled = name == "rows_scatter_add_tiled"
    plain = sr.rows_scatter_add_plain if f32 else sr.rows_scatter_add_bf16_plain
    atol, rtol = (SCATTER_ATOL, SCATTER_RTOL) if f32 else (BF16_SCATTER_ATOL, BF16_SCATTER_RTOL)
    dev = torch.device(DEV)
    g = torch.Generator(device=dev).manual_seed(1)
    r = TRAIN_BATCH * HEADS

    def inputs(hw, n, d):
        idx = torch.randint(-1, hw, (r, n), device=dev, generator=g, dtype=torch.int32)
        contrib = torch.randn((r, n, d), device=dev, generator=g)
        return idx, contrib if f32 else contrib.bfloat16()

    def on_cpu(idx, contrib, hw):  # the plain version on the CPU, bit for bit
        return torch.equal(fn(idx, contrib, hw).cpu(), plain(idx.cpu(), contrib.cpu(), hw))

    tot = {"bytes": 0.0, "flops": 0.0}
    max_err, levels = 0.0, []
    for (h, w), p in zip(M_SHAPES, M_POINTS):
        hw, n = h * w, TRAIN_QUERIES * p * 4
        idx, contrib = inputs(hw, n, HEAD_DIM)
        out = fn(idx, contrib, hw)
        ref = plain(idx, contrib, hw)
        torch.testing.assert_close(out, ref, atol=atol, rtol=rtol)
        err = (out - ref).abs().max().item()
        max_err = max(max_err, err)
        level = {"hw": hw, "n": n, "max_abs_err": err}
        if torch.count_nonzero(fn(torch.full_like(idx, -1), contrib, hw)).item():
            raise AssertionError(f"{name}: all-dropped scatter wrote nonzero rows")
        one_row = torch.full_like(idx, hw // 2)
        one = fn(one_row, contrib, hw)
        # one row sums 6000-12000 entries: f32 rounding of sums of size ~100
        torch.testing.assert_close(one, plain(one_row, contrib, hw), atol=1e-3, rtol=1e-4)
        if not f32:  # no atomics: reported for mxu, the contract of tiled
            level["bit_equal_two_runs"] = bool(torch.equal(out, fn(idx, contrib, hw))
                                               and torch.equal(one, fn(one_row, contrib, hw)))
        if tiled:
            level["bit_equal_cpu"] = on_cpu(idx, contrib, hw) and on_cpu(one_row, contrib, hw)
            if not (level["bit_equal_two_runs"] and level["bit_equal_cpu"]):
                raise AssertionError(f"rows_scatter_add_tiled at hw {hw}: not bit-equal {level}")
        # library yardstick: index_add_ of the f32(-upcast) payload onto a
        # padded flat output whose pad row absorbs the dropped entries
        safe = torch.where(idx >= 0, idx, hw).long()
        flat = (torch.arange(r, device=dev)[:, None] * (hw + 1) + safe).reshape(-1)
        src = contrib.float().reshape(-1, HEAD_DIM)
        parts = {
            **timings("", lambda: fn(idx, contrib, hw), 50),
            **timings("plain_", lambda: plain(idx, contrib, hw), 20),
            **timings("library_", lambda: torch.zeros(
                (r * (hw + 1), HEAD_DIM), device=dev).index_add_(0, flat, src), 50)}
        level["ms"] = parts["ms"]
        for key_, val in parts.items():
            if key_.endswith("ms") and val is not None:
                tot[key_] = tot.get(key_, 0.0) + val
            elif not key_.endswith("ms"):
                tot[key_] = val
        tot["bytes"] += (idx.numel() * 4 + contrib.numel() * contrib.element_size()
                         + r * hw * HEAD_DIM * 4)
        tot["flops"] += int((idx >= 0).sum().item()) * HEAD_DIM
        levels.append(level)
    # one call is one kernel: no fill of the output, no sort or gather around it
    activities = _kernels_of(lambda: fn(idx, contrib, hw))
    if len(activities) != 1 or "rows_scatter_add" not in activities[0]:
        raise AssertionError(f"{name}: one call ran {activities}, want its kernel alone")
    # head dim 16 (the n model): the first level of n@640, and an unsupported D raises
    (h, w), p = N_SHAPES[0], N_POINTS[0]
    idx, contrib = inputs(h * w, TRAIN_QUERIES * p * 4, 16)
    torch.testing.assert_close(fn(idx, contrib, h * w), plain(idx, contrib, h * w),
                               atol=atol, rtol=rtol)
    if tiled and not on_cpu(idx, contrib, h * w):
        raise AssertionError("rows_scatter_add_tiled at D = 16: not bit-equal to the CPU")
    try:
        fn(idx, contrib[..., :8].contiguous(), h * w)
    except ValueError:
        pass
    else:
        raise AssertionError(f"{name} took D = 8")
    bound_ms, bound_by = bound(tot["bytes"], tot["flops"])
    res[name] = {"max_abs_err": max_err, **{k: v for k, v in tot.items() if "ms" in k},
                 "bound_ms": bound_ms, "bound_by": bound_by, "levels": levels,
                 "atol": atol, "rtol": rtol, "activities_per_call": activities}
    emit({"phase": f"kernel_{name}",
          "shape": f"m@640 train step, B={TRAIN_BATCH}, Q={TRAIN_QUERIES}, "
                   f"{'f32' if f32 else 'bf16'} payload: one backward = 3 calls, times summed",
          **res[name]})


def phase_scatter(res):
    _scatter(res, "rows_scatter_add")


def phase_scatter_mxu(res):
    _scatter(res, "rows_scatter_add_mxu")


def phase_scatter_tiled(res):
    _scatter(res, "rows_scatter_add_tiled")


def phase_core_backward(res):
    import torch

    from dfine_tpu_torch.ops.deform_attn import ms_deform_attn, ms_deform_attn_core

    dev = torch.device(DEV)
    value, loc, att = _deform_inputs(dev, GRAD_BATCH, HEAD_DIM, M_SHAPES, M_POINTS,
                                     torch.float32, seed=5)
    g_out = torch.randn((GRAD_BATCH, QUERIES, HEADS * HEAD_DIM), device=dev)
    grads = []
    for fn in (ms_deform_attn, ms_deform_attn_core):
        v, l, a = (t.clone().requires_grad_() for t in (value, loc, att))
        (fn(v, M_SHAPES, l, a, M_POINTS) * g_out).sum().backward()
        grads.append((v.grad, l.grad, a.grad))
    errs = {}
    for name, ours, ref in zip(("value", "loc", "att"), *grads):
        scale = ref.abs().max().item() + 1e-9
        errs[name] = (ours - ref).abs().max().item() / scale
        if not errs[name] <= GRAD_REL_TOL:
            raise AssertionError(f"core backward grad {name}: rel err {errs[name]}")
    emit({"phase": "core_backward", "batch": GRAD_BATCH, "max_rel_err": errs,
          "tol_rel": GRAD_REL_TOL})


def phase_model(res):
    import torch

    from dfine_tpu_torch.models.dfine import build_model

    cpu = build_model(SIZE, NUM_CLASSES, True, device="cpu")
    randomize_(cpu, seed=1)
    gpu = copy.deepcopy(cpu).to(DEV)
    x = torch.from_numpy(np.random.default_rng(2).uniform(size=(1, 3, IMG, IMG)).astype(np.float32))
    enc = {}  # encoder class logits, from which the decoder's queries are selected
    for tag, m in (("cpu", cpu), ("gpu", gpu)):
        m.decoder.enc_score_head.register_forward_hook(
            lambda mod, inp, out, tag=tag: enc.__setitem__(tag, out))
    t0 = time.perf_counter()
    with torch.no_grad():
        ref = {k: v.numpy() for k, v in cpu(x).items()}
        t_cpu = time.perf_counter() - t0
        ours = {k: v.cpu().numpy() for k, v in gpu(x.to(DEV)).items()}
    for k, v in ours.items():
        if not np.isfinite(v).all() or v.shape != ref[k].shape:
            raise AssertionError(f"model output {k}: not finite or shape {v.shape}")
    match = align_by_box(ref["pred_boxes"][0], ours["pred_boxes"][0])
    box_diff = np.abs(ours["pred_boxes"][0][match] - ref["pred_boxes"][0]).max(-1)
    keep = box_diff <= BOX_ATOL  # a query is matched when its partner's box agrees

    def err(k):
        return float(np.abs(ours[k][0][match[keep]] - ref[k][0][keep]).max())

    n_q = ours["pred_boxes"].shape[1]
    # each side's selection as the decoder makes it (the same op on its own device:
    # scores tied at the boundary may be broken differently by the two topk kernels)
    chosen = {t: set(e.max(-1).values.topk(n_q, dim=1).indices[0].tolist()) for t, e in enc.items()}
    score_cpu = enc["cpu"][0].max(-1).values
    srt = score_cpu.sort(descending=True).values
    one_side = len(chosen["cpu"] - chosen["gpu"])  # such a query has no partner on the other side
    unmatched = int((~keep).sum())
    errs = {"box": err("pred_boxes"), "logit": err("pred_logits"), "mask": err("pred_masks")}
    emit({"phase": "model_fp32_card_vs_cpu", "size": SIZE, "img": IMG,
          "enc_logit_max_abs_err": float((enc["cpu"] - enc["gpu"].cpu()).abs().max()),
          "queries_selected_on_one_side_only": one_side, "unmatched_queries": unmatched,
          "score_gap_at_selection_boundary": float(srt[n_q - 1] - srt[n_q]),
          "scores_tied_at_boundary": int((score_cpu == srt[n_q - 1]).sum()),
          "matched_frac": float(keep.mean()), "min_matched": MIN_MATCHED,
          "box_max_abs_err": errs["box"], "box_atol": BOX_ATOL,
          "box_max_abs_err_all_queries": float(box_diff.max()),
          "logit_max_abs_err": errs["logit"], "mask_max_abs_err": errs["mask"],
          "logit_mask_atol": MODEL_ATOL,
          "cpu_seconds": t_cpu, "masks_shape": list(ours["pred_masks"].shape)})
    if keep.mean() < MIN_MATCHED:
        raise AssertionError(f"card vs CPU: {keep.mean():.3f} of queries matched 1:1 within "
                             f"{BOX_ATOL}, want >= {MIN_MATCHED}")
    if unmatched > one_side:
        raise AssertionError(f"card vs CPU: {unmatched} queries unmatched, but only {one_side} "
                             "were selected on one side only")
    if not max(errs["logit"], errs["mask"]) <= MODEL_ATOL:
        raise AssertionError(f"card vs CPU, matched queries: {errs} beyond {MODEL_ATOL}")


def _frames(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (720, 1280, 3), dtype=np.uint8) for _ in range(n)]


def phase_serving(res):
    import torch

    from dfine_tpu_torch import TorchModel
    from dfine_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    t0 = time.perf_counter()
    model = TorchModel(SIZE, None, NUM_CLASSES, IMG, IMG, conf_thresh=0.5, half=True,
                       enable_mask_head=True, device=DEV)
    load_s = time.perf_counter() - t0
    frames = _frames(4)
    for i in range(SERVE_WARMUP):
        (out,) = model(frames[i % len(frames)])
    # random weights score every query alike: keep about SERVE_KEEP per frame,
    # so that the mask path (resize to 720p, binarize, box cleanup) runs
    model.conf_thresh = float(np.sort(out["all_scores"])[-SERVE_KEEP])

    reset_launch_counts()  # the main path: TorchModel.__call__ on 720p BGR frames
    times, kept = [], []
    for i in range(SERVE_FRAMES):
        t = time.perf_counter()
        (out,) = model(frames[i % len(frames)])
        times.append(time.perf_counter() - t)
        kept.append(len(out["scores"]))
        b = out["boxes"]
        if not (np.isfinite(b).all() and (b[:, [0, 2]] <= 1280).all() and (b[:, [1, 3]] <= 720).all()):
            raise AssertionError("served boxes not finite or outside the frame")
        if out["masks"].shape != (len(out["scores"]), 720, 1280):
            raise AssertionError(f"served masks shape {out['masks'].shape}")
    counts = launch_counts()
    res["serving_counts"] = counts
    res["serving_model"] = model

    def predict(frame):  # the call without the host postprocess: frame in, top-k decode out
        with torch.inference_mode():
            model._predict(model._prepare_inputs(frame)[0])
        sync()

    pred_times = []
    for i in range(SERVE_FRAMES):
        t = time.perf_counter()
        predict(frames[i % len(frames)])
        pred_times.append(time.perf_counter() - t)

    p50, p90 = percentiles(times)
    q50, q90 = percentiles(pred_times)
    emit({"phase": "serving", "model": f"{SIZE} det+seg bf16 {IMG}px, 720p BGR frames",
          "load_seconds": load_s, "frames": SERVE_FRAMES, "call_p50_ms": p50,
          "call_p90_ms": p90, "predict_p50_ms": q50, "predict_p90_ms": q90,
          "kept_per_frame": float(np.mean(kept)), "launches": counts})
    prof = profile_window(lambda: model(frames[0]), 5)
    emit({"phase": "serving_profile", "what": "TorchModel.__call__, per frame", **prof,
          "idle_share_at_p50": 1.0 - prof["device_busy_ms"] / p50})
    want = DECODER_LAYERS * SERVE_FRAMES
    if counts["ms_deform_attn_fwd"] != want:
        raise AssertionError(f"deform kernel launched {counts['ms_deform_attn_fwd']}x, want {want}")


def phase_gradient(res):
    import torch

    from dfine_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from dfine_tpu_torch.ops.preprocess import preprocess_plain

    model = res["serving_model"].model
    raw = torch.from_numpy(np.stack(_frames(GRAD_BATCH, seed=3))).to(DEV)
    x = preprocess_plain(raw.flip(-1), (IMG, IMG))

    def step():
        model.zero_grad(set_to_none=True)
        out = model(x)
        loss = (out["pred_logits"].float().sigmoid().mean() + out["pred_boxes"].mean()
                + out["pred_masks"].float().mean())
        loss.backward()
        sync()
        return loss

    step()  # warm-up
    reset_launch_counts()  # the gradient path: one backward of the model at batch 8
    t0 = time.perf_counter()
    loss = step()
    step_s = time.perf_counter() - t0
    counts = launch_counts()
    res["gradient_counts"] = counts
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    finite = all(torch.isfinite(g).all().item() for g in grads)
    stem_grad = model.backbone.stem.stem1.conv.weight.grad
    emit({"phase": "gradient", "batch": GRAD_BATCH, "loss": loss.item(), "step_ms": step_s * 1e3,
          "params_with_grad": len(grads), "grads_finite": finite, "launches": counts})
    emit({"phase": "gradient_profile", "what": "forward + backward, per step",
          **profile_window(step, 2)})
    want = {"ms_deform_attn_fwd": DECODER_LAYERS,
            "rows_scatter_add": DECODER_LAYERS * len(M_SHAPES),
            "rows_scatter_add_mxu": 0, "rows_scatter_add_tiled": 0}
    if counts != want or not finite or stem_grad is None or not stem_grad.abs().sum().item() > 0:
        raise AssertionError(f"gradient path: counts {counts} (want {want}), finite {finite}")


def ellipse_masks(boxes: np.ndarray, valid: np.ndarray, hw) -> np.ndarray:
    """[B, G, H, W] f32: the ellipse inscribed in each valid cxcywh box."""
    h, w = hw
    y = ((np.arange(h) + 0.5) / h).astype(np.float32)[:, None]
    x = ((np.arange(w) + 0.5) / w).astype(np.float32)[None, :]
    cx, cy, bw, bh = (boxes[..., i][..., None, None].astype(np.float32) for i in range(4))
    inside = ((x - cx) / (bw / 2)) ** 2 + ((y - cy) / (bh / 2)) ** 2 <= 1.0
    return (inside & valid[..., None, None]).astype(np.float32)


def make_train_batch(batch: int, seed: int, device, masks: bool = False):
    """Images of uniform noise and ``TRAIN_G`` target slots of which 5-40 per
    image are valid boxes (cxcywh inside the frame), drawn from ``seed``;
    with ``masks``, the segment targets: the ellipse inscribed in each valid
    box at the mask head's size (stride 4), and mask_valid = valid."""
    import torch

    rng = np.random.default_rng(seed)
    n_valid = rng.integers(TRAIN_BOXES[0], TRAIN_BOXES[1] + 1, batch)
    wh = rng.uniform(0.03, 0.4, (batch, TRAIN_G, 2))
    cxcy = rng.uniform(wh / 2, 1 - wh / 2)
    boxes = np.concatenate([cxcy, wh], -1).astype(np.float32)
    valid = np.arange(TRAIN_G)[None] < n_valid[:, None]
    targets = {
        "labels": torch.from_numpy(rng.integers(0, NUM_CLASSES, (batch, TRAIN_G))),
        "boxes": torch.from_numpy(boxes), "valid": torch.from_numpy(valid)}
    images = torch.from_numpy(rng.uniform(size=(batch, 3, IMG, IMG)).astype(np.float32))
    if masks:
        targets["masks"] = torch.from_numpy(ellipse_masks(boxes, valid, MASK_HW))
        targets["mask_valid"] = targets["valid"]
    return {"images": images.to(device), "targets": {k: v.to(device) for k, v in targets.items()}}


def _train_setup(compute_dtype, model=None, seg=False, optim=None, update_mask=None):
    """A TrainState (fp32 parameters) and its step: the m detect model, or
    ``model``; ``seg`` adds the ``masks`` loss (and builds the mask head)."""
    from dfine_tpu_torch.models.dfine import build_model
    from dfine_tpu_torch.train.criterion import CriterionConfig
    from dfine_tpu_torch.train.optim import OptimConfig, build_optimizer
    from dfine_tpu_torch.train.train_step import TrainState, make_train_step

    if model is None:
        model = build_model(SIZE, NUM_CLASSES, seg, device=DEV)
    losses = ("vfl", "boxes", "local") + (("masks",) if seg else ())
    state = TrainState.create(model, build_optimizer(model, optim or OptimConfig()))
    step = make_train_step(CriterionConfig(num_classes=NUM_CLASSES, losses=losses),
                           compute_dtype=compute_dtype, update_mask=update_mask)
    return state, step


@contextlib.contextmanager
def captured_losses(out: list):
    """Keep, in ``out``, every loss term (detached) of each train step run
    while the context is open: the step's metrics hold the final set's only."""
    from dfine_tpu_torch.train import train_step as ts

    crit = ts.criterion_forward

    def keep(*args, **kw):
        losses = crit(*args, **kw)
        out.append({k: v.detach() for k, v in losses.items()})
        return losses

    ts.criterion_forward = keep
    try:
        yield out
    finally:
        ts.criterion_forward = crit


def _noise(batch: int, seed: int):
    import torch

    from dfine_tpu_torch.models.denoising import draw_cdn_noise

    return draw_cdn_noise(batch, TRAIN_G, NUM_CLASSES, 100, 0.5,
                          torch.Generator().manual_seed(seed))


@contextlib.contextmanager
def timed_matching(acc: dict):
    """Add up, in ``acc``, the host seconds of the train step's Hungarian
    matching: the wait for the device to finish the forward (the costs'
    copy to the host has to wait for it anyway), the copy and the solves,
    and scipy's solves alone."""
    from dfine_tpu_torch import matcher

    orig_h, orig_lsa = matcher.hungarian, matcher.linear_sum_assignment

    def hungarian(*args, **kw):
        t0 = time.perf_counter()
        sync()
        t1 = time.perf_counter()
        out = orig_h(*args, **kw)
        acc["wait_s"] += t1 - t0
        acc["copy_solve_s"] += time.perf_counter() - t1
        return out

    def lsa(*args, **kw):
        t0 = time.perf_counter()
        out = orig_lsa(*args, **kw)
        acc["scipy_s"] += time.perf_counter() - t0
        acc["problems"] += 1
        return out

    matcher.hungarian, matcher.linear_sum_assignment = hungarian, lsa
    try:
        yield acc
    finally:
        matcher.hungarian, matcher.linear_sum_assignment = orig_h, orig_lsa


def phase_train(res):
    """The m detect train step on the card: bf16 autocast, fp32 parameters,
    the default (``"pallas"``) deformable-attention backward."""
    import torch

    from dfine_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    state, step = _train_setup(torch.bfloat16)
    res["train_init"] = {k: v.detach().cpu().clone() for k, v in state.model.state_dict().items()}
    batch = make_train_batch(TRAIN_BATCH, seed=7, device=DEV)
    gen = torch.Generator(device=DEV).manual_seed(0)
    for _ in range(TRAIN_WARMUP):
        step(state, batch, gen)
    sync()
    p0 = {k: v.detach().clone() for k, v in state.model.named_parameters()}
    e0 = {k: v.detach().clone() for k, v in state.ema.named_parameters()}
    want = {"ms_deform_attn_fwd": DECODER_LAYERS,
            "rows_scatter_add": DECODER_LAYERS * len(M_SHAPES),
            "rows_scatter_add_mxu": 0, "rows_scatter_add_tiled": 0}
    times, per_step, metrics, total = [], [], [], {k: 0 for k in want}
    match = {"wait_s": 0.0, "copy_solve_s": 0.0, "scipy_s": 0.0, "problems": 0}
    with timed_matching(match):
        for _ in range(TRAIN_STEPS):
            reset_launch_counts()  # the main path of this slice: one train step
            t = time.perf_counter()
            _, m = step(state, batch, gen)
            sync()
            times.append(time.perf_counter() - t)
            counts = launch_counts()
            per_step.append(counts)
            for k in total:
                total[k] += counts[k]
            metrics.append({k: float(v) for k, v in m.items()})
    res["train_counts"] = total
    matching = {"wait_for_device_ms": match["wait_s"] * 1e3 / TRAIN_STEPS,
                "copy_and_solve_ms": match["copy_solve_s"] * 1e3 / TRAIN_STEPS,
                "scipy_ms": match["scipy_s"] * 1e3 / TRAIN_STEPS,
                "problems_per_step": match["problems"] / TRAIN_STEPS}
    p50, p90 = percentiles(times)
    finite = all(np.isfinite(list(m_.values())).all() for m_ in metrics)
    grads_finite = all(torch.isfinite(p.grad).all().item() for p in state.model.parameters()
                       if p.grad is not None)
    moved = sum(int(not torch.equal(p0[k], v)) for k, v in state.model.named_parameters())
    ema_moved = sum(int(not torch.equal(e0[k], v)) for k, v in state.ema.named_parameters())
    emit({"phase": "train", "model": f"{SIZE} detect {IMG}px, bf16 autocast, fp32 params",
          "batch": TRAIN_BATCH, "gt_slots": TRAIN_G, "steps": TRAIN_STEPS,
          "step_p50_ms": p50, "step_p90_ms": p90, "metrics_first": metrics[0],
          "metrics_last": metrics[-1], "launches_per_step": per_step[0],
          "launches_total": total, "hungarian_host_per_step": matching,
          "params_moved": moved, "ema_moved": ema_moved,
          "n_params": len(p0), "losses_finite": finite, "grads_finite": grads_finite})
    prof = profile_window(lambda: (step(state, batch, gen), sync()), 1, top=12)
    res["train_in_situ"] = prof["ours"]
    emit({"phase": "train_profile", "what": "one train step", **prof})
    res["train_run"] = (state, step, batch, gen)
    bad = [c for c in per_step if c != want]
    if bad or not finite or not grads_finite:
        raise AssertionError(f"train: counts {bad[:1]} (want {want}), finite {finite}, "
                             f"grads finite {grads_finite}")
    if moved < 0.9 * len(p0) or ema_moved < 0.9 * len(p0):
        raise AssertionError(f"train: {moved} params and {ema_moved} EMA tensors moved "
                             f"of {len(p0)}")


@contextlib.contextmanager
def captured_scatters(calls: list):
    """Keep, in ``calls``, a copy of the inputs of every call of the default
    value-gradient scatter while the context is open; each call still goes
    on to the kernel."""
    from dfine_tpu_torch.ops import deform_attn as tda

    kernel = tda.rows_scatter_add

    def keep(idx, contrib, hw):
        calls.append((idx.clone(), contrib.clone(), hw))
        return kernel(idx, contrib, hw)

    # the backward picks the f32 payload by the identity of rows_scatter_add
    tda.rows_scatter_add = tda._SCATTERS["pallas"] = keep
    try:
        yield calls
    finally:
        tda.rows_scatter_add = tda._SCATTERS["pallas"] = kernel


def phase_scatter_in_situ(res):
    """The three row scatter-adds and ``index_add_`` on the inputs that the
    default backward of one more train step (phase_train's state, batch and
    generator) gives its 12 calls: how the destinations cluster over the
    kernels' 128-row tiles, each one's time on them (summed over the step),
    ``rows_scatter_add`` against its plain version and ``_tiled`` bit for bit
    against its plain version on the CPU."""
    import torch

    from dfine_tpu_torch.ops.kernels import scatter_rows as sr

    state, step, batch, gen = res.pop("train_run")
    with captured_scatters([]) as calls:
        step(state, batch, gen)
        sync()
    del state
    if len(calls) != DECODER_LAYERS * len(M_SHAPES):
        raise AssertionError(f"in situ: {len(calls)} scatter calls in one step")
    names = ("rows_scatter_add", "rows_scatter_add_mxu", "rows_scatter_add_tiled")
    total = dict.fromkeys((*names, "library"), 0.0)
    levels = {}
    for idx, contrib, hw in calls:
        r, d = idx.shape[0], contrib.shape[-1]
        kept = (idx >= 0) & (idx < hw)
        safe = torch.where(kept, idx, hw).long()
        tiles = -(-hw // TILE_ROWS)
        ones = torch.ones_like(safe)
        per_tile = torch.zeros((r, tiles + 1), dtype=torch.long, device=DEV).scatter_add_(
            1, torch.where(kept, idx // TILE_ROWS, tiles).long(), ones)[:, :tiles].float()
        per_pixel = torch.zeros((r, hw + 1), dtype=torch.long, device=DEV).scatter_add_(
            1, safe, ones)[:, :hw]
        c16 = contrib.bfloat16()
        flat = (torch.arange(r, device=DEV)[:, None] * (hw + 1) + safe).reshape(-1)
        src = contrib.reshape(-1, d)
        payload = {"rows_scatter_add": contrib, "rows_scatter_add_mxu": c16,
                   "rows_scatter_add_tiled": c16}
        ms = {n: cuda_ms(lambda n=n: getattr(sr, n)(idx, payload[n], hw), 20) for n in names}
        ms["library"] = cuda_ms(lambda: torch.zeros((r * (hw + 1), d), device=DEV).index_add_(
            0, flat, src), 20)
        torch.testing.assert_close(sr.rows_scatter_add(idx, contrib, hw),
                                   sr.rows_scatter_add_plain(idx, contrib, hw),
                                   atol=SCATTER_ATOL, rtol=SCATTER_RTOL)
        if not torch.equal(sr.rows_scatter_add_tiled(idx, c16, hw).cpu(),
                           sr.rows_scatter_add_bf16_plain(idx.cpu(), c16.cpu(), hw)):
            raise AssertionError(f"in situ, hw {hw}: rows_scatter_add_tiled not bit-equal")
        level = levels.setdefault(hw, {"n": idx.shape[1], "calls": 0, "kept_share": 0.0,
                                       "tile_max_over_mean": 0.0, "busiest_pixel_entries": 0,
                                       **{f"{k}_ms_per_call": 0.0 for k in ms}})
        level["calls"] += 1
        level["kept_share"] = max(level["kept_share"], float(kept.float().mean()))
        level["tile_max_over_mean"] = max(level["tile_max_over_mean"],
                                          float(per_tile.max() / per_tile.mean()))
        level["busiest_pixel_entries"] = max(level["busiest_pixel_entries"],
                                             int(per_pixel.max()))
        for k, v in ms.items():
            total[k] += v
            level[f"{k}_ms_per_call"] += v / DECODER_LAYERS
    res["in_situ"] = total
    emit({"phase": "scatter_in_situ",
          "what": f"the {len(calls)} scatter inputs of one {SIZE} detect train step (batch "
                  f"{TRAIN_BATCH}, bf16): ms summed over the step, by CUDA events; library = "
                  "index_add_ of the f32 payload", "ms_per_step": total, "levels": levels})


def _unclipped_grads(state, metrics):
    """The optimizer clips the gradients in place by c / max(norm, c); undo it."""
    c = state.optimizer.clip
    scale = max(float(metrics["grad_norm"]), c) / c
    return {k: p.grad.detach() * scale for k, p in state.model.named_parameters()
            if p.grad is not None}


def rel_norms(ref, other, keys):
    """||other[k] - ref[k]|| / ||ref[k]|| for each k of ``keys``."""
    return {k: float((other[k] - ref[k]).norm() / ref[k].norm().clamp_min(1e-30)) for k in keys}


def _rms_all(ref) -> float:
    """The RMS over every element of the tensors of ``ref``."""
    import torch

    n_all = sum(t.numel() for t in ref.values())
    return float(torch.cat([t.flatten() for t in ref.values()]).norm()) / math.sqrt(n_all)


def rounding_exempt(ref):
    """The tensors of ``ref`` whose RMS is under ROUNDING_SHARE of the RMS
    over all of them (rule (a)), with their norms; raises if one of them is
    not of the kinds NOUGHT_PARTS names."""
    rms_all = _rms_all(ref)
    out = {k: float(t.norm()) for k, t in ref.items()
           if float(t.norm()) / math.sqrt(t.numel()) < ROUNDING_SHARE * rms_all}
    odd = [k for k in out if not any(part in k for part in NOUGHT_PARTS)]
    if odd:
        raise AssertionError(f"gradients nought to rounding where none should be: {odd}")
    return out


def _worst(rel, n=5):
    return [[k, rel[k]] for k in sorted(rel, key=rel.get, reverse=True)[:n]]


def phase_train_bwd_variants(res):
    """One train step each with the default, ``mxu`` and ``tiled`` backward,
    on the same weights, batch and CDN noise, in fp32 and under bf16
    autocast, and the default twice more as the controls: the losses agree,
    and so does each parameter's gradient outside rules (a) and (c)."""
    import torch

    from dfine_tpu_torch.models.dfine import build_model
    from dfine_tpu_torch.ops.deform_attn import set_deform_bwd
    from dfine_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    base = build_model(SIZE, NUM_CLASSES, False, device="cpu")
    base.load_state_dict(res["train_init"])
    batch = make_train_batch(TRAIN_BATCH, seed=7, device=DEV)
    noise = _noise(TRAIN_BATCH, seed=3).to(DEV)
    want = DECODER_LAYERS * len(M_SHAPES)
    controls = [f"control{i}" for i in range(CONTROLS)]
    out, exempt_all, failures = {}, {}, []
    for mode, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        runs = {}
        try:
            for run in ["pallas", *controls, "mxu", "tiled"]:
                set_deform_bwd("pallas" if run in controls else run)
                state, step = _train_setup(dtype, model=copy.deepcopy(base).to(DEV))
                reset_launch_counts()  # this step: the chosen backward's kernel
                _, m = step(state, batch, dn_noise=noise)
                sync()
                runs[run] = (float(m["loss"]), _unclipped_grads(state, m), launch_counts())
                del state
        finally:
            set_deform_bwd("pallas")
        loss0, g0, _ = runs["pallas"]
        tol = VARIANT_GRAD_REL[mode]
        control = {k: max(rel_norms(g0, runs[c][1], [k])[k] for c in controls) for k in g0}
        if mode == "fp32":  # rule (a) is read on the fp32 default gradient, for both modes
            nought = rounding_exempt(g0)
        exempt = {k: {"rule": "a", "fp32_norm": nought[k]} for k in nought}
        exempt.update({k: {"rule": "c", "norm": float(g.norm()), "control": control[k],
                           **{i: rel_norms(g0, runs[i][1], [k])[k] for i in ("mxu", "tiled")}}
                       for k, g in g0.items() if g.numel() == 1 and k not in exempt})
        checked = [k for k in g0 if k not in exempt]
        exempt_all[mode] = exempt
        out[f"control_{mode}"] = {
            "losses_bit_equal": all(runs[c][0] == loss0 for c in controls),
            "max": max(control[k] for k in checked),
            "median": float(np.median([control[k] for k in checked])),
            "worst": _worst({k: control[k] for k in checked}),
            "n_exempt_by_rule": {r: sum(e["rule"] == r for e in exempt.values()) for r in "ac"}}
        for impl in ("mxu", "tiled"):
            loss, grads, counts = runs[impl]
            rel = rel_norms(g0, grads, checked)
            share = {k: r / (tol + 2 * control[k]) for k, r in rel.items()}  # of the limit
            out[f"{impl}_{mode}"] = {
                "loss": loss, "loss_bit_equal": loss == loss0, "default_loss": loss0,
                "launches": counts, "n_checked": len(checked), "n_exempt": len(exempt),
                "max_rel": max(rel.values()), "median_rel": float(np.median(list(rel.values()))),
                "worst": _worst(rel), "max_share_of_limit": max(share.values()),
                "worst_share_of_limit": _worst(share, 3), "all": math.sqrt(
                    sum(float((grads[k] - g0[k]).norm()) ** 2 for k in g0)
                    / sum(float(g0[k].norm()) ** 2 for k in g0))}
            res[f"{impl}_counts"] = counts
            name = f"rows_scatter_add_{impl}"
            if counts[name] != want or counts["rows_scatter_add"]:
                failures.append(f"{impl} {mode}: launches {counts}, want {want} of {name}")
            if abs(loss - loss0) > 1e-6 * abs(loss0):
                failures.append(f"{impl} {mode}: loss {loss} vs the default's {loss0}")
            bad = {k: r for k, r in share.items() if not r <= 1.0}
            if bad:
                failures.append(f"{impl} {mode}: {len(bad)} gradients beyond their limits "
                                f"(share of the limit): {_worst(bad)}")
    emit({"phase": "train_bwd_variants", "batch": TRAIN_BATCH, "tol_rel": VARIANT_GRAD_REL,
          "limit": "tol_rel + 2 x control", "rounding_share": ROUNDING_SHARE, **out})
    emit({"phase": "train_bwd_variants_exempt", **exempt_all})
    if failures:
        raise AssertionError("; ".join(failures))


@contextlib.contextmanager
def query_selection(model):
    """Yields a list that, after a forward of ``model``, holds the set of
    queries its encoder head selected (top-300) for each image."""
    seen = []

    def hook(mod, inp, out):
        top = out.detach().float().max(-1).values.topk(QUERIES, dim=1).indices
        seen[:] = [set(row.tolist()) for row in top.cpu()]

    handle = model.decoder.enc_score_head.register_forward_hook(hook)
    try:
        yield seen
    finally:
        handle.remove()


def _selected(model, seed, noise, device):
    """The queries each image's encoder head selects in a train-mode forward
    (no gradient) of a copy of ``model`` on ``device``, batch ``seed``."""
    import torch

    model = copy.deepcopy(model).to(device).train()
    batch = make_train_batch(PARITY_BATCH, seed, device)
    with query_selection(model) as seen, torch.no_grad():
        model(batch["images"], batch["targets"], dn_noise=noise.to(device))
    return seen


def phase_train_parity(res):
    """One fp32 train step of the m detect model on the card against the same
    step on the CPU: same weights, batch and CDN noise (drawn on the CPU).
    The first moment, 0.1 x the clipped gradient, is held leaf by leaf, so
    a gradient wrong in size shows even where the step's sign does not.
    The batch seed is the first of ``PARITY_SEEDS`` for which both sides'
    encoder heads select the same top-300 queries (exact score ties at the
    boundary may be broken differently by the two topk kernels). A LAB
    parameter (one element) is held by its gradient's terms (``lab_terms``),
    every other leaf by its first moment."""
    _card_vs_cpu_step(res, "train_parity", res["train_init"], seg=False)


def phase_train_seg_parity(res):
    """``phase_train_parity`` for the m det+seg step (the ``masks`` loss, GT
    ellipses at 160 x 160), at the first two batch seeds that select alike:
    every loss term of every set, the mask terms included, and every leaf,
    ``pixel_decoder.*`` and ``mask_head.*`` among them, by the same rules."""
    _card_vs_cpu_step(res, "train_seg_parity", res["train_seg_init"], seg=True,
                      n_seeds=SEG_PARITY_SEEDS)


@contextlib.contextmanager
def lab_terms(model, out: dict):
    """While open, ``out[name]`` gets, in each backward, the terms whose sum
    is the gradient of each LAB parameter ``name`` of ``model`` (y = scale *
    x + bias): dL/dy * x for the scale, dL/dy for the bias, on the host."""
    from dfine_tpu_torch.models.layers import LearnableAffine

    def keep(prefix):
        def hook(mod, inp, y):
            x = inp[0].detach()

            def terms(g):
                out[f"{prefix}.scale"] = (g * x).float().cpu()
                out[f"{prefix}.bias"] = g.float().cpu()
            y.register_hook(terms)
        return hook

    handles = [mod.register_forward_hook(keep(name)) for name, mod in model.named_modules()
               if isinstance(mod, LearnableAffine)]
    try:
        yield out
    finally:
        for h in handles:
            h.remove()


def _card_vs_cpu_step(res, phase, init, seg, n_seeds=1):
    """The parity steps at the first ``n_seeds`` batch seeds that select
    alike; every seed's readings are printed before a failure is raised."""
    from dfine_tpu_torch.models.dfine import build_model

    cpu_model = build_model(SIZE, NUM_CLASSES, seg, device="cpu")
    cpu_model.load_state_dict(init)
    noise = _noise(PARITY_BATCH, seed=4)
    seeds = []
    for cand in PARITY_SEEDS:
        if len(seeds) < n_seeds and (_selected(cpu_model, 100 + cand, noise, "cpu")
                                     == _selected(cpu_model, 100 + cand, noise, DEV)):
            seeds.append(100 + cand)
    if len(seeds) < n_seeds:
        raise AssertionError(f"{len(seeds)} batch seeds of {list(PARITY_SEEDS)} gave the same "
                             f"selection, want {n_seeds}")
    failures = []
    for seed in seeds:
        failures += _parity_at(phase, init, cpu_model, noise, seed, seg)
    if failures:
        raise AssertionError("; ".join(failures))


def _sum_vs_first_moment(a, metrics, mu: float, clip: float) -> float:
    """|0.1 x sum(a) x the clip factor - mu| over its limit: TERMS_SUM_RTOL
    of |mu| plus a float32 sum's rounding bound, eps x log2(n) x the sum of
    the magnitudes (the terms are summed in another order than autograd's)."""
    scale = 0.1 * clip / max(metrics["grad_norm"], clip)
    bound = TERMS_SUM_RTOL * abs(mu) + 2.0**-24 * math.log2(a.numel()) * scale * float(
        a.abs().sum())
    return abs(scale * float(a.sum()) - mu) / bound


def _parity_at(phase, init, cpu_model, noise, seed, seg):
    """One parity step at batch ``seed``; returns its failures."""
    import torch

    from dfine_tpu_torch.train.optim import OptimConfig

    out = {}
    for tag, dev in (("cpu", "cpu"), ("gpu", DEV)):
        state, step = _train_setup(torch.float32, model=copy.deepcopy(cpu_model).to(dev), seg=seg)
        t = time.perf_counter()
        with query_selection(state.model) as chosen, captured_losses([]) as terms, \
                lab_terms(state.model, {}) as fields:
            _, m = step(state, make_train_batch(PARITY_BATCH, seed, dev, masks=seg),
                        dn_noise=noise.to(dev))
        if dev != "cpu":
            sync()
        m = {k: float(v) for k, v in m.items()}
        if seg:  # every set's terms, not only the final set's
            m.update({k: float(v) for k, v in terms[0].items()})
        adam = state.optimizer.adamw.state
        out[tag] = (m, {k: v.detach().cpu() for k, v in state.model.named_parameters()},
                    {k: adam[v]["exp_avg"].cpu() for k, v in state.model.named_parameters()},
                    time.perf_counter() - t, chosen, fields)
        del state
    (m_cpu, p_cpu, mu_cpu, t_cpu, sel_cpu, f_cpu), (m_gpu, p_gpu, mu_gpu, _, sel_gpu, f_gpu) = (
        out["cpu"], out["gpu"])
    if sel_cpu != sel_gpu:  # the step's own selection, not only the seed's probe
        return [f"{phase} seed {seed}: the two sides selected different queries"]
    loss_err = {k: abs(m_gpu[k] - v) / max(abs(v), 1e-12) for k, v in m_cpu.items()}
    lr, n_el, n_far, worst = 2e-5, 0, 0, 0.0  # AdamW's first step moves a parameter ~lr
    far_by_leaf, unexplained = {}, {}
    for k, v in p_cpu.items():
        diff = (p_gpu[k] - v).abs()
        worst = max(worst, float(diff.max()))
        far = diff > PARITY_STEP_ATOL
        n_far += int(far.sum())
        n_el += v.numel()
        if far.any():
            far_by_leaf[k] = int(far.sum())
            # lr * g / (|g| + 1e-8) moves as far only where g changed sign
            # or is within FLIP_MU_FLOOR of 0
            same = (mu_cpu[k] * mu_gpu[k] > 0) & (torch.minimum(
                mu_cpu[k].abs(), mu_gpu[k].abs()) >= FLIP_MU_FLOOR)
            if (far & same).any():
                unexplained[k] = int((far & same).sum())
    moved = sum(int(not torch.equal(p_gpu[k], init[k])) for k in p_gpu)
    mu_exempt = rounding_exempt(mu_cpu)
    held = [k for k in mu_cpu if k not in mu_exempt]
    mu_rel = {c: {} for c in PARITY_MU_REL}
    for k, r in rel_norms(mu_cpu, mu_gpu, [k for k in held if k not in f_cpu]).items():
        mu_rel["sampling_offsets" if "sampling_offsets" in k else "tensor"][k] = r
    # a LAB parameter: its gradient's terms within the "tensor" limit, the
    # gap of their sums within that limit of the sum of their magnitudes,
    # and each side's sum its first moment (0.1 x the sum x the clip
    # factor) within TERMS_SUM_RTOL, which shows that they are its terms
    clip = OptimConfig().clip_max_norm
    lab = {}
    for k in [k for k in held if k in f_cpu]:
        a_cpu, a_gpu = f_cpu[k].double(), f_gpu[k].double()
        s_cpu, mag = float(a_cpu.sum()), float(a_cpu.abs().sum())
        lab[k] = {"first_moment_rel": rel_norms(mu_cpu, mu_gpu, [k])[k],
                  "terms_rel": float((a_gpu - a_cpu).norm() / a_cpu.norm()),
                  "sum_gap_over_magnitude": abs(float(a_gpu.sum()) - s_cpu) / mag,
                  "kappa": mag / max(abs(s_cpu), 1e-300),
                  "sum_vs_first_moment": max(_sum_vs_first_moment(a, m, float(mu[k]), clip)
                                             for a, m, mu in ((a_cpu, m_cpu, mu_cpu),
                                                              (a_gpu, m_gpu, mu_gpu)))}
    lab_limits = {"terms_rel": PARITY_MU_REL["tensor"],
                  "sum_gap_over_magnitude": PARITY_MU_REL["tensor"], "sum_vs_first_moment": 1.0}
    failures = [f"{phase} seed {seed} {k}: {r}" for k, r in lab.items()
                if not all(r[c] <= lim for c, lim in lab_limits.items())]
    extra = {}
    if seg:
        mask_part = {k: r for rel in mu_rel.values() for k, r in rel.items()
                     if "pixel_decoder." in k or "mask_head." in k}
        extra = {"mask_terms": sorted(k for k in m_cpu if "mask" in k),
                 "mask_part_first_moment": {"n": len(mask_part),
                                            "max_rel": max(mask_part.values(), default=0.0),
                                            "worst": _worst(mask_part)}}
        if not mask_part or len(extra["mask_terms"]) < 4:
            failures.append(f"{phase}: mask terms {extra['mask_terms']}, "
                            f"{len(mask_part)} mask-head leaves checked")
    far_limit = PARITY_FAR_SHARE["det+seg" if seg else "detect"]
    emit({"phase": phase, "what": f"{SIZE} {'det+seg' if seg else 'detect'} fp32, batch "
          f"{PARITY_BATCH}, card vs CPU, one step", "batch_seed": seed,
          "same_selection": sel_cpu == sel_gpu,
          "metrics_cpu": m_cpu, "metrics_gpu": m_gpu, "rel_err": loss_err,
          "param_max_abs_diff": worst, "param_share_beyond_step_atol": n_far / n_el,
          "step_atol": PARITY_STEP_ATOL, "far_share_limit": far_limit,
          "far_by_leaf": _worst(far_by_leaf), "far_unexplained": unexplained,
          "params_moved": moved, "cpu_step_seconds": t_cpu,
          "loss_rtol": PARITY_LOSS_RTOL, "grad_norm_rtol": PARITY_GNORM_RTOL,
          "first_moment": {c: {"n": len(r), "max_rel": max(r.values(), default=0.0),
                               "median_rel": float(np.median(list(r.values()) or [0.0])),
                               "worst": _worst(r), "tol": PARITY_MU_REL[c]}
                           for c, r in mu_rel.items()},
          "lab_terms": {"n": len(lab), "limits": lab_limits,
                        **{c: {"max": max((r[c] for r in lab.values()), default=0.0),
                               "worst": _worst({k: r[c] for k, r in lab.items()}, 3)}
                           for c in ("first_moment_rel", "terms_rel", "sum_gap_over_magnitude",
                                     "kappa", "sum_vs_first_moment")}},
          "lab_terms_all": lab, "first_moment_exempt_rule_a": mu_exempt, **extra})
    for k, v in m_cpu.items():
        tol = PARITY_GNORM_RTOL if k == "grad_norm" else PARITY_LOSS_RTOL
        if abs(m_gpu[k] - v) > tol * abs(v) + (0 if k == "grad_norm" else PARITY_LOSS_ATOL):
            failures.append(f"{phase} seed {seed} {k}: card {m_gpu[k]} vs CPU {v}")
    # AdamW's first step is lr * g / (|g| + 1e-8): a gradient within rounding
    # noise of zero may take the other sign on the other device (2 lr apart)
    if n_far > far_limit * n_el or worst > 2 * lr + PARITY_STEP_ATOL or unexplained:
        failures.append(f"{phase} seed {seed} params: {n_far} of {n_el} beyond "
                        f"{PARITY_STEP_ATOL}, max {worst}, without a sign change {unexplained}")
    if moved < 0.9 * len(p_gpu):
        failures.append(f"{phase} seed {seed}: only {moved} parameters moved")
    bad = {k: r for c, rel in mu_rel.items() for k, r in rel.items()
           if not r <= PARITY_MU_REL[c]}
    if bad:
        failures.append(f"{phase} seed {seed} first moment: {_worst(bad)} beyond "
                        f"{PARITY_MU_REL}")
    return failures


@contextlib.contextmanager
def captured_mask_products(calls: list):
    """Keep, in ``calls``, the inputs of every mask-logit product of the
    criterion (the matched embeddings against ``mask_feat``) while the
    context is open; each call still computes its product."""
    from dfine_tpu_torch.train import criterion

    fn = criterion.mask_logits

    def keep(embed, q_idx, mask_feat):
        calls.append((embed.detach(), q_idx, mask_feat.detach()))
        return fn(embed, q_idx, mask_feat)

    criterion.mask_logits = keep
    try:
        yield calls
    finally:
        criterion.mask_logits = fn


def _mask_product_ms(calls) -> dict:
    """Device ms of the criterion's mask-logit products on the inputs one
    train step gave them: forward alone, and forward + backward of a sum
    over the logits (the two gradients the step takes through them)."""
    import torch

    from dfine_tpu_torch.train.criterion import mask_logits

    fwd = bwd = 0.0
    shapes = []
    for embed, q_idx, feat in calls:
        e, f = embed.clone().requires_grad_(), feat.clone().requires_grad_()
        g = torch.ones((), device=e.device)

        def both():
            e.grad = f.grad = None
            (mask_logits(e, q_idx, f).sum() * g).backward()

        fwd += timings("", lambda: mask_logits(embed, q_idx, feat), 20)["ms"]
        bwd += timings("", both, 10)["ms"]
        shapes.append({"embed": list(embed.shape), "q_idx": list(q_idx.shape),
                       "mask_feat": list(feat.shape), "dtype": str(embed.dtype)})
    return {"forward_ms": fwd, "forward_backward_ms": bwd, "calls": len(calls), "inputs": shapes}


def phase_train_seg(res):
    """The m det+seg train step on the card: bf16 autocast, fp32 parameters,
    the ``masks`` loss on GT ellipses [8, 100, 160, 160] made on the host
    and moved to the card before the step."""
    import torch

    from dfine_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    state, step = _train_setup(torch.bfloat16, seg=True)
    res["train_seg_init"] = {k: v.detach().cpu().clone()
                             for k, v in state.model.state_dict().items()}
    batch = make_train_batch(TRAIN_BATCH, seed=7, device=DEV, masks=True)
    gen = torch.Generator(device=DEV).manual_seed(0)
    for _ in range(TRAIN_WARMUP):
        step(state, batch, gen)
    sync()
    mask_part = [k for k, _ in state.model.named_parameters()
                 if k.startswith(("decoder.pixel_decoder.", "decoder.mask_head."))]
    p0 = {k: v.detach().clone() for k, v in state.model.named_parameters()}
    e0 = {k: v.detach().clone() for k, v in state.ema.named_parameters()}
    want = {"ms_deform_attn_fwd": DECODER_LAYERS,
            "rows_scatter_add": DECODER_LAYERS * len(M_SHAPES),
            "rows_scatter_add_mxu": 0, "rows_scatter_add_tiled": 0}
    times, per_step, total, terms = [], [], {k: 0 for k in want}, []
    torch.cuda.reset_peak_memory_stats()
    with captured_losses(terms):
        for _ in range(TRAIN_STEPS):
            reset_launch_counts()  # the main path of this phase: one det+seg train step
            t = time.perf_counter()
            step(state, batch, gen)
            sync()
            times.append(time.perf_counter() - t)
            counts = launch_counts()
            per_step.append(counts)
            for k in total:
                total[k] += counts[k]
    res["train_seg_counts"] = total
    first, last = ({k: float(v) for k, v in t_.items()} for t_ in (terms[0], terms[-1]))
    n_dn = DECODER_LAYERS - 1  # with masks the last DN layer is "_dn_final"
    mask_keys = [f"loss_mask_{w}{suf}" for w in ("bce", "dice")
                 for suf in ([""] + [f"_aux_{i}" for i in range(DECODER_LAYERS - 1)]
                             + [f"_dn_{i}" for i in range(n_dn)] + ["_dn_final"])]
    missing = [k for k in mask_keys if k not in last]
    finite = all(np.isfinite(list(t_.values())).all() for t_ in (first, last))
    p50, p90 = percentiles(times)
    moved = sum(int(not torch.equal(p0[k], v)) for k, v in state.model.named_parameters())
    mask_moved = sum(int(not torch.equal(p0[k], state.model.get_parameter(k)))
                     for k in mask_part)
    ema_moved = sum(int(not torch.equal(e0[k], v)) for k, v in state.ema.named_parameters())
    ema_mask_moved = sum(int(not torch.equal(e0[k], state.ema.get_parameter(k)))
                         for k in mask_part)
    emit({"phase": "train_seg", "model": f"{SIZE} det+seg {IMG}px, bf16 autocast, fp32 params",
          "batch": TRAIN_BATCH, "gt_slots": TRAIN_G, "gt_masks": [TRAIN_BATCH, TRAIN_G, *MASK_HW],
          "steps": TRAIN_STEPS, "step_p50_ms": p50, "step_p90_ms": p90,
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 2**30,
          "launches_per_step": per_step[0], "launches_total": total,
          "loss_terms_first": first, "loss_terms_last": last,
          "mask_terms_expected": len(mask_keys), "mask_terms_missing": missing,
          "terms_finite": finite, "params_moved": moved, "n_params": len(p0),
          "mask_params_moved": mask_moved, "n_mask_params": len(mask_part),
          "ema_moved": ema_moved, "ema_mask_moved": ema_mask_moved})
    with captured_mask_products([]) as calls:
        prof = profile_window(lambda: (step(state, batch, gen), sync()), 1, top=12)
    products = _mask_product_ms(calls)
    emit({"phase": "train_seg_profile", "what": "one det+seg train step", **prof,
          "idle_share_at_p50": 1.0 - prof["device_busy_ms"] / p50,
          "mask_products": products})
    del state, batch
    torch.cuda.empty_cache()
    bad = [c for c in per_step if c != want]
    if bad or missing or not finite:
        raise AssertionError(f"train_seg: counts {bad[:1]} (want {want}), mask terms missing "
                             f"{missing}, finite {finite}")
    if (moved < 0.9 * len(p0) or mask_moved != len(mask_part) or ema_moved < 0.9 * len(p0)
            or ema_mask_moved != len(mask_part)):
        raise AssertionError(f"train_seg: {moved} params ({mask_moved} of {len(mask_part)} of "
                             f"the mask head) and {ema_moved} EMA tensors moved of {len(p0)}")


def phase_train_l_frozen(res):
    """The l detect train step with the JAX trainer's l options: the freeze
    mask (backbone norms and stem), per-group learning-rate peaks and
    ``b_accum_steps = 2``, bf16, batch 4. Over 4 micro-steps: frozen
    parameters bit-unchanged; the others unchanged after micro-steps 1 and
    3, and after 2 and 4 moved wherever their mean gradient is nonzero; the
    EMA changed only after 2 and 4; each group's learning rate that of its
    schedule at the optimizer's count; 6 + 18 launches a micro-step. Then 8
    timed micro-steps and a profile of two."""
    import torch

    from dfine_tpu_torch.models.dfine import build_model
    from dfine_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from dfine_tpu_torch.train.optim import OptimConfig, freeze_mask, onecycle

    model = build_model(L_SIZE, NUM_CLASSES, False, device=DEV)
    mask = freeze_mask(model, freeze_backbone_norm=True, freeze_stem=True)
    cfg = OptimConfig(per_group_max_lr=True, b_accum_steps=L_ACCUM)
    state, step = _train_setup(torch.bfloat16, model=model, optim=cfg, update_mask=mask)
    opt = state.optimizer
    peaks = {"backbone": onecycle(2 * cfg.backbone_lr, cfg), "rest": onecycle(2 * cfg.base_lr, cfg)}
    frozen = {k for k, keep in mask.items() if not keep}
    batch = make_train_batch(L_BATCH, seed=9, device=DEV)
    gen = torch.Generator(device=DEV).manual_seed(0)
    want = {"ms_deform_attn_fwd": L_DECODER_LAYERS,
            "rows_scatter_add": L_DECODER_LAYERS * len(M_SHAPES),
            "rows_scatter_add_mxu": 0, "rows_scatter_add_tiled": 0}
    checks, failures, per_step, times = [], [], [], []
    total = {k: 0 for k in want}

    def micro_step():
        reset_launch_counts()  # the main path of this phase: one micro-step
        t = time.perf_counter()
        _, m = step(state, batch, gen)
        sync()
        times.append(time.perf_counter() - t)
        counts = launch_counts()
        per_step.append(counts)
        for k in total:
            total[k] += counts[k]
        return m

    for micro in range(1, L_CHECKED + 1):
        p0 = {k: v.detach().clone() for k, v in model.named_parameters()}
        e0 = {k: v.detach().clone() for k, v in state.ema.state_dict().items()}
        m = micro_step()
        stepped = micro % L_ACCUM == 0
        changed = {k for k, v in model.named_parameters() if not torch.equal(p0[k], v)}
        live = {k for k, v in model.named_parameters()
                if k not in frozen and v.grad is not None and bool(v.grad.any())}
        ema_changed = sum(int(not torch.equal(e0[k], v))
                          for k, v in state.ema.state_dict().items() if v.is_floating_point())
        lrs = {g["group"]: g["lr"] for g in opt.adamw.param_groups}
        want_lr = {g: peaks["backbone" if g.startswith("backbone") else "rest"](opt.count - 1)
                   for g in lrs} if stepped else None  # set only when the optimizer steps
        check = {"micro_step": micro, "optimizer_count": opt.count, "stepped": stepped,
                 "grad_norm": float(m["grad_norm"]), "loss": float(m["loss"]),
                 "changed": len(changed), "frozen_changed": len(changed & frozen),
                 "trainable": len(mask) - len(frozen), "with_nonzero_mean_grad": len(live),
                 "live_unmoved": sorted(live - changed)[:5], "ema_changed": ema_changed,
                 "ema_tensors": sum(int(v.is_floating_point()) for v in e0.values()),
                 "lr": lrs, "lr_want": want_lr, "launches": per_step[-1]}
        checks.append(check)
        if changed & frozen:
            failures.append(f"micro {micro}: frozen moved {sorted(changed & frozen)[:3]}")
        if stepped and (live - changed or len(live) < 0.9 * (len(mask) - len(frozen))):
            failures.append(f"micro {micro}: {len(live - changed)} of {len(live)} live "
                            "parameters did not move")
        if not stepped and changed:
            failures.append(f"micro {micro}: {len(changed)} parameters moved between steps")
        n_float = sum(int(v.is_floating_point()) for v in e0.values())
        if (ema_changed < 0.5 * n_float) if stepped else ema_changed:
            failures.append(f"micro {micro}: EMA changed {ema_changed} of {n_float} tensors, "
                            f"stepped {stepped}")
        if stepped and any(abs(lrs[g] - want_lr[g]) > 1e-12 * max(1.0, want_lr[g]) for g in lrs):
            failures.append(f"micro {micro}: learning rates {lrs} want {want_lr}")
    times.clear()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(L_TIMED):
        micro_step()
    res["train_l_counts"] = total
    p50, p90 = percentiles(times)
    emit({"phase": "train_l_frozen", "model": f"{L_SIZE} detect {IMG}px, bf16 autocast, fp32 "
          "params, freeze_mask(norms, stem), per_group_max_lr", "batch": L_BATCH,
          "b_accum_steps": L_ACCUM, "frozen_params": len(frozen), "n_params": len(mask),
          "micro_steps_timed": L_TIMED, "micro_step_p50_ms": p50, "micro_step_p90_ms": p90,
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 2**30,
          "checks": checks, "launches_total": total})
    prof = profile_window(lambda: (step(state, batch, gen), sync()), L_ACCUM, top=12)
    emit({"phase": "train_l_frozen_profile", "what": "one micro-step (mean of one that "
          "accumulates and one that steps)", **prof,
          "idle_share_at_p50": 1.0 - prof["device_busy_ms"] / p50})
    del state, model, batch
    torch.cuda.empty_cache()
    bad = [c for c in per_step if c != want]
    if bad:
        failures.append(f"counts {bad[:1]}, want {want}")
    if failures:
        raise AssertionError("train_l_frozen: " + "; ".join(failures))


def in_situ_ms(res, kernel: str):
    """ms a launch of ``kernel`` in the default train step's profile (all its
    instances), or None where that step does not launch it."""
    rows = [v for k, v in res["train_in_situ"].items() if kernel in k]
    n = sum(v["count_per_call"] for v in rows)
    return sum(v["ms_per_launch"] * v["count_per_call"] for v in rows) / n if n else None


def kernel_line(res):
    d = res["deform"]
    # (name, pallas_call line, launch counts, path, kernel symbol)
    scatters = (("rows_scatter_add", 85, "train_counts",
                 f"train, {TRAIN_STEPS} steps at batch {TRAIN_BATCH} (ms: one backward)",
                 "rows_scatter_add_tile_kernel"),
                ("rows_scatter_add_mxu", 173, "mxu_counts",
                 "train, one step with set_deform_bwd('mxu') (ms: one backward)",
                 "rows_scatter_add_mma_kernel"),
                ("rows_scatter_add_tiled", 277, "tiled_counts",
                 "train, one step with set_deform_bwd('tiled') (ms: one backward)",
                 "rows_scatter_add_tile_sorted_kernel"))
    return {"kernels": [
        {"name": "ms_deform_attn_fwd", "route": "cuda",
         "source": "dfine_tpu_torch/csrc/ms_deform_attn_fwd.cu",
         "replaces": "dfine_tpu/ops/deform_attn.py:72",  # XLA gather: no Pallas counterpart
         "launches": res["serving_counts"]["ms_deform_attn_fwd"],
         "train_launches": res["train_counts"]["ms_deform_attn_fwd"],
         "train_seg_launches": res["train_seg_counts"]["ms_deform_attn_fwd"],
         "train_l_launches": res["train_l_counts"]["ms_deform_attn_fwd"],
         "train_shape_ms": res["deform_train"]["ms"],
         "train_in_situ_ms": in_situ_ms(res, "ms_deform_attn_fwd_kernel"),
         "empty_launch_ms": d["empty_launch_ms"],
         "max_abs_err": d["max_abs_err"], "ms": d["ms"], "plain_ms": d["plain_ms"],
         "bound_ms": d["bound_ms"], "bound_by": d["bound_by"], "library_ms": None,
         "path": f"serving, {SERVE_FRAMES} frames"},
    ] + [
        {"name": name, "route": "cuda", "source": "dfine_tpu_torch/csrc/rows_scatter_add_tile.cu",
         "replaces": f"dfine_tpu/ops/pallas/scatter_rows.py:{line}",
         "launches": res[counts][name], "max_abs_err": res[name]["max_abs_err"],
         "train_seg_launches": res["train_seg_counts"][name],
         "train_l_launches": res["train_l_counts"][name],
         "ms": res[name]["ms"], "plain_ms": res[name]["plain_ms"],
         "bound_ms": res[name]["bound_ms"], "bound_by": res[name]["bound_by"],
         "library_ms": res[name]["library_ms"], "path": path,
         "train_in_situ_ms": in_situ_ms(res, symbol),
         "step_inputs_ms": res["in_situ"][name]}
        for name, line, counts, path, symbol in scatters
    ]}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 2
    try:
        import dfine_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: run from the root of a checkout ({e})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    res, failed = {}, []
    for fn in (phase_build, phase_deform_fwd, phase_scatter, phase_scatter_mxu,
               phase_scatter_tiled, phase_core_backward, phase_model, phase_serving,
               phase_gradient, phase_train, phase_scatter_in_situ, phase_train_bwd_variants,
               phase_train_parity, phase_train_seg, phase_train_seg_parity,
               phase_train_l_frozen):
        t0 = time.perf_counter()
        try:
            fn(res)
        except Exception:  # a failed phase is reported and the run goes on
            traceback.print_exc()
            failed.append(fn.__name__)
            emit({"phase": fn.__name__, "failed": True})
        print(f"# {fn.__name__}: {time.perf_counter() - t0:.1f} s", file=sys.stderr, flush=True)
    if failed:
        print(f"chip_smoke: failed phases {failed}", file=sys.stderr)
        return 1
    emit(kernel_line(res))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        print(f"chip_smoke: nvidia-smi failed: {smi.stderr}", file=sys.stderr)
        return 1
    print(smi.stdout.strip().splitlines()[0], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
