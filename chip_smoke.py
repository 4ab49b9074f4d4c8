#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (``dfine_tpu_torch``) on one NVIDIA card.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each printed as one JSON line:

1. build: both hand-written kernels from ``dfine_tpu_torch/csrc`` (one nvcc
   per source, started together);
2. kernels: each kernel against its plain PyTorch version on the card at the
   shapes of D-FINE-m at 640 px (TF32 off), with its time, the plain
   version's, one PyTorch call's where one computes the same function, and
   the least time the card could take (bound);
3. model: the m det+seg model on the card, fp32, against the same weights
   on the CPU through the plain path;
4. serving: ``TorchModel`` (m det+seg, bf16) answers 720p BGR frames, with
   the deformable-attention kernel's launch count read around the run;
5. gradient: one backward of the m det+seg model at batch 8, through the
   ``MSDeformAttnCore`` backward and its scatter kernel, counts read around it.

Then one ``{"kernels": [...]}`` line, the card's name and power limit as
nvidia-smi gives them, and, if every phase passed, the last line
``{"ok": true, "device": {...}}``. Without a CUDA device, or outside a
checkout of the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import copy
import json
import math
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
SERVE_WARMUP, SERVE_FRAMES, SERVE_KEEP = 5, 30, 20
DECODER_LAYERS = 4  # m: num_layers, eval_idx = -1
# one H100 SXM (NVIDIA data sheet, dense rates): HBM bytes/s, fp32 FLOP/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
FWD_TOL = 1e-5
SCATTER_ATOL, SCATTER_RTOL = 1e-4, 1e-5
GRAD_REL_TOL = 2e-4  # test_pallas_scatter.py:69-78
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
    import torch

    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    return us / 1e3 / iters


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
    rows = sorted((e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA),
                  key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in rows) / 1e3 / n
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "idle_share": 1.0 - busy_ms / wall_ms,
            "device_activities_per_call": sum(e.count for e in rows) / n,
            "top": [{"name": e.key[:90], "ms_per_call": e.self_device_time_total / 1e3 / n,
                     "count_per_call": e.count / n} for e in rows[:top]],
            "ours": {e.key: {"ms_per_launch": e.self_device_time_total / 1e3 / e.count,
                             "count_per_call": e.count / n}
                     for e in rows
                     if "ms_deform_attn_fwd_kernel" in e.key or "rows_scatter_add_kernel" in e.key}}


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


def phase_build(res):
    from dfine_tpu_torch.ops.kernels import _build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(_build.SOURCES)) as pool:  # one nvcc per source, together
        list(pool.map(_build.load, _build.SOURCES))
    ptxas = {n: sorted({l.strip() for l in log.splitlines() if "registers" in l or "spill" in l})
             for n, log in _build.build_logs.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "built": sorted(_build.build_logs), "ptxas": ptxas})


def _deform_inputs(dev, b, d, shapes, pts, value_dtype, seed, lo=-0.15, hi=1.15):
    import torch

    rng = np.random.default_rng(seed)
    s, p = sum(h * w for h, w in shapes), sum(pts)
    value = torch.from_numpy(rng.normal(size=(b, s, HEADS, d)).astype(np.float32))
    loc = torch.from_numpy(rng.uniform(lo, hi, (b, QUERIES, HEADS, p, 2)).astype(np.float32))
    att = torch.from_numpy(rng.normal(size=(b, QUERIES, HEADS, p)).astype(np.float32))
    return value.to(dev, value_dtype), loc.to(dev), att.softmax(-1).to(dev)


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

    # timing at the serving shape: m@640, B=1, bf16 value, locations in the map
    v, l, a = _deform_inputs(dev, 1, HEAD_DIM, M_SHAPES, M_POINTS, torch.bfloat16, 4, 0.0, 1.0)
    t = {**timings("", lambda: ms_deform_attn_fwd(v, M_SHAPES, l, a, M_POINTS), 200),
         **timings("plain_", lambda: ms_deform_attn_fwd_plain(v, M_SHAPES, l, a, M_POINTS), 20)}
    n_pts = QUERIES * HEADS * sum(M_POINTS)
    nbytes = (v.numel() * v.element_size() + l.numel() * 4 + a.numel() * 4
              + QUERIES * HEADS * HEAD_DIM * 4)
    flops = n_pts * (4 * 2 * HEAD_DIM + 2 * HEAD_DIM)  # 4 corner FMAs + the att FMA per channel
    bound_ms, bound_by = bound(nbytes, flops)
    res["deform"] = {"max_abs_err": max_err, **t, "bound_ms": bound_ms, "bound_by": bound_by,
                     "checks": checks}
    emit({"phase": "kernel_ms_deform_attn_fwd", "shape": "m@640 B=1 bf16 value",
          **res["deform"]})


def phase_scatter(res):
    import torch

    from dfine_tpu_torch.ops.kernels.scatter_rows import rows_scatter_add, rows_scatter_add_plain

    dev = torch.device(DEV)
    g = torch.Generator(device=dev).manual_seed(1)
    r = GRAD_BATCH * HEADS
    tot = {"bytes": 0.0, "flops": 0.0}
    max_err, levels = 0.0, []
    for (h, w), p in zip(M_SHAPES, M_POINTS):
        hw, n = h * w, QUERIES * p * 4
        idx = torch.randint(-1, hw, (r, n), device=dev, generator=g, dtype=torch.int32)
        contrib = torch.randn((r, n, HEAD_DIM), device=dev, generator=g)
        out = rows_scatter_add(idx, contrib, hw)
        ref = rows_scatter_add_plain(idx, contrib, hw)
        torch.testing.assert_close(out, ref, atol=SCATTER_ATOL, rtol=SCATTER_RTOL)
        err = (out - ref).abs().max().item()
        max_err = max(max_err, err)
        dropped = torch.count_nonzero(rows_scatter_add(torch.full_like(idx, -1), contrib, hw))
        if dropped.item():
            raise AssertionError("all-dropped scatter wrote nonzero rows")
        # library yardstick: index_add_ onto a padded flat output (pad row absorbs drops)
        safe = torch.where(idx >= 0, idx, hw).long()
        flat = (torch.arange(r, device=dev)[:, None] * (hw + 1) + safe).reshape(-1)
        src = contrib.reshape(-1, HEAD_DIM)
        for key, val in {
            **timings("", lambda: rows_scatter_add(idx, contrib, hw), 50),
            **timings("plain_", lambda: rows_scatter_add_plain(idx, contrib, hw), 20),
            **timings("library_", lambda: torch.zeros(
                (r * (hw + 1), HEAD_DIM), device=dev).index_add_(0, flat, src), 50),
        }.items():
            tot[key] = tot.get(key, 0.0) + val if key.endswith("ms") else val
        n_valid = int((idx >= 0).sum().item())
        tot["bytes"] += idx.numel() * 4 + contrib.numel() * 4 + r * hw * HEAD_DIM * 4
        tot["flops"] += n_valid * HEAD_DIM
        levels.append({"hw": hw, "n": n, "max_abs_err": err})
    bound_ms, bound_by = bound(tot["bytes"], tot["flops"])
    res["scatter"] = {"max_abs_err": max_err, **{k: v for k, v in tot.items() if "ms" in k},
                      "bound_ms": bound_ms, "bound_by": bound_by, "levels": levels}
    emit({"phase": "kernel_rows_scatter_add",
          "shape": f"m@640 B={GRAD_BATCH}: one backward = 3 calls, times summed",
          **res["scatter"]})


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
            "rows_scatter_add": DECODER_LAYERS * len(M_SHAPES)}
    if counts != want or not finite or stem_grad is None or not stem_grad.abs().sum().item() > 0:
        raise AssertionError(f"gradient path: counts {counts} (want {want}), finite {finite}")


def kernel_line(res):
    d, s = res["deform"], res["scatter"]
    return {"kernels": [
        {"name": "ms_deform_attn_fwd", "route": "cuda",
         "source": "dfine_tpu_torch/csrc/ms_deform_attn_fwd.cu",
         "replaces": "dfine_tpu/ops/deform_attn.py:72",  # XLA gather: no Pallas counterpart
         "launches": res["serving_counts"]["ms_deform_attn_fwd"],
         "max_abs_err": d["max_abs_err"], "ms": d["ms"], "plain_ms": d["plain_ms"],
         "bound_ms": d["bound_ms"], "bound_by": d["bound_by"], "library_ms": None,
         "path": f"serving, {SERVE_FRAMES} frames"},
        {"name": "rows_scatter_add", "route": "cuda",
         "source": "dfine_tpu_torch/csrc/rows_scatter_add.cu",
         "replaces": "dfine_tpu/ops/pallas/scatter_rows.py:85",
         "launches": res["gradient_counts"]["rows_scatter_add"],
         "max_abs_err": s["max_abs_err"], "ms": s["ms"], "plain_ms": s["plain_ms"],
         "bound_ms": s["bound_ms"], "bound_by": s["bound_by"], "library_ms": s["library_ms"],
         "path": f"gradient, one backward at batch {GRAD_BATCH}"},
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
    for fn in (phase_build, phase_deform_fwd, phase_scatter, phase_core_backward, phase_model,
               phase_serving, phase_gradient):
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
