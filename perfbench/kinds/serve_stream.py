"""Traffic kind ``serve_stream``: camera frames served by the program's
CUDA-graph backend (``AOTModel``, ``max_batch_size`` 1), in a closed loop
of one client: a video stream served as fast as it answers.

Set-up: the backend as an application builds it (its own weights, graph
capture and smoke check), then the run's weights loaded into its model in
place (a captured graph reads them where they are; ``serving_weights``),
``pool_frames`` frames drawn from the seed (C-contiguous HWC uint8, as a
camera or a decoder hands them over), each with the threshold that keeps
the reference's ``keep_per_frame`` best scores of it (so every frame and
every seed costs the same postprocess, and the program's own output
chooses nothing), and ``warmup_frames`` calls. The reference's work in
set-up (the BatchNorm statistics and the thresholds) is timed and left out
of ``setup_s``. The window: the pool's frames in turn, each call
``backend(frame)`` under its frame's threshold, timed on the host clock
from the ndarray handed in to the list of dicts returned; a seeded
reservoir keeps ``sample_frames`` of the answers for the comparison. The
traced run adds a window of harness spans (preprocess, program,
postprocess, each closed by a synchronize) and a profiled one.
"""

from __future__ import annotations

import gc
import sys
import time
from typing import Any, Dict

import numpy as np
import torch

from .. import judge, trace, weights
from ..counts import deform as deform_counts
from ..counts import flops as flop_counts
from ..reference import deform as ref_deform
from ..reference import model as ref_model
from ..reference import precision as ref_precision
from ..reference import serve as ref_serve

PROGRAM_KEYS = ("backbone", "encoder", "decoder")


def check_registry(cfg: Dict[str, Any]) -> None:
    """The program's registry entry of the configuration's size holds the
    numbers of the configuration's file."""
    from dfine_tpu_torch.configs import model_config

    prog = model_config(cfg["program_size"])
    for k in PROGRAM_KEYS:
        for key, v in cfg[k].items():
            if key in prog[k] and _norm(prog[k][key]) != _norm(v):
                raise ValueError(f"{cfg['name']}: {k}.{key} is {v!r} in the configuration, "
                                 f"{prog[k][key]!r} in the program's registry")


def _norm(v):
    return list(v) if isinstance(v, tuple) else v


def frames(seed: int, n: int, hw, device) -> np.ndarray:
    """``n`` uint8 BGR frames [n, H, W, 3] drawn from the seed
    (``weights.images``)."""
    x = weights.images(weights.generator(seed, device, stream=1), n, hw, device)
    x = (x * 255.0).round().to(torch.uint8).permute(0, 2, 3, 1).cpu().numpy()
    return np.ascontiguousarray(x)


def build_backend(cfg, device):
    """The program's CUDA-graph serving backend for the configuration, one
    frame a call."""
    from dfine_tpu_torch import AOTModel

    h, w = cfg["input_size"]
    return AOTModel(cfg["program_size"], None, cfg["num_classes"], w, h, conf_thresh=0.5,
                    half=cfg["serve_dtype"] == "bfloat16", enable_mask_head=cfg["mask_head"],
                    device=device, max_batch_size=1)


def serving_weights(cfg, mix, seed: int, device):
    """The run's weights: the seeded draw (``weights.for_config``), then
    every BatchNorm's statistics set from the reference's activations over
    ``calibration_frames`` frames (one train-mode forward, momentum 1), as
    a trained model's statistics fit its data: with the draw's own
    statistics the features lose the frame within a few layers and every
    frame gets the same answer. Returns (the state dict on the host, the
    reference model holding it, in eval mode, the seconds of the
    reference's own work: its build and the calibration forward)."""
    t0 = time.perf_counter()
    ref = ref_model.build(cfg, device)
    _sync(device)
    t1 = time.perf_counter()
    w = weights.for_config(cfg, ref, seed, device)
    _sync(device)
    t2 = time.perf_counter()
    ref.load_state_dict(w, strict=True)
    bn_frames = torch.from_numpy(frames(seed + 1, mix["calibration_frames"], mix["frame_hw"],
                                        device)).to(device)
    bns = [m for m in ref.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    for m in bns:
        m.momentum = 1.0
    ref.train()
    with torch.no_grad(), ref_precision.fp32():
        ref(ref_serve.model_input(bn_frames, cfg["input_size"]))
    for m in bns:
        m.momentum = 0.1
    ref.eval()
    _sync(device)
    ref_s = (t1 - t0) + (time.perf_counter() - t2)
    return {k: v.detach().cpu() for k, v in ref.state_dict().items()}, ref, ref_s


def reference_model(cfg, state, device):
    ref = ref_model.build(cfg, device)
    ref.load_state_dict(state, strict=True)
    return ref


def setup(cell, seed: int, device, backend=None) -> Dict[str, Any]:
    """The backend (built here unless given) with the run's weights, the
    frames and their thresholds, after the warm-up calls; ``ref_s`` the
    seconds of the reference's work in it."""
    cfg, mix = cell["config_spec"], cell["mix"]
    check_registry(cfg)
    backend = backend or build_backend(cfg, device)
    state, ref, ref_s = serving_weights(cfg, mix, seed, device)
    load(backend, state)
    pool = frames(seed, mix["pool_frames"], mix["frame_hw"], device)
    t0 = time.perf_counter()
    raw = ref_serve.outputs(ref, torch.from_numpy(pool).to(device), cfg["input_size"],
                            keep_masks=False)
    thresholds = ref_serve.thresholds(raw, mix["keep_per_frame"])
    del ref, raw
    ref_s += time.perf_counter() - t0
    for i in range(mix["warmup_frames"]):
        serve(backend, pool, thresholds, i)
    _sync(device)
    return {"backend": backend, "pool": pool, "thresholds": thresholds, "state": state,
            "ref_s": ref_s}


def load(backend, state) -> None:
    """The weights into the backend's model, in place: a captured graph
    reads the parameters where they are."""
    backend.model.load_state_dict(state, strict=True)


def serve(backend, pool, thresholds, n: int):
    """The client's n-th call: frame n of the pool under its threshold."""
    backend.conf_thresh = thresholds[n % len(pool)]
    (out,) = backend(pool[n % len(pool)])
    return out


def window(backend, pool, thresholds, seconds: float, rng, sample: int) -> Dict[str, Any]:
    """Closed loop over the pool for ``seconds``: every call's latency, the
    malformed answers, and a reservoir of ``sample`` (frame index, answer)."""
    lat, kept, bad, keep = [], [], 0, []
    n = 0
    t0 = time.perf_counter()
    end = t0 + seconds
    while True:
        t = time.perf_counter()
        if t >= end:
            break
        out = serve(backend, pool, thresholds, n)
        lat.append(time.perf_counter() - t)
        kept.append(len(out["scores"]))
        bad += int(not well_formed(out, pool.shape[1:3]))
        if len(keep) < sample:
            keep.append((n, out))
        else:
            j = int(rng.integers(0, n + 1))
            if j < sample:
                keep[j] = (n, out)
        n += 1
    return {"latency_s": lat, "kept": kept, "malformed": bad, "frames": n,
            "window_s": time.perf_counter() - t0, "sample": keep}


def well_formed(out, hw) -> bool:
    b = out["boxes"]
    ok = np.isfinite(b).all() and (b >= 0).all() and (b[:, [0, 2]] <= hw[1]).all() \
        and (b[:, [1, 3]] <= hw[0]).all()
    return bool(ok and ("masks" not in out or out["masks"].shape == (len(b), *hw)))


def spans_window(backend, pool, thresholds, seconds: float) -> Dict[str, Any]:
    """The traced run's spans: preprocess (H2D, resize), program (graph
    replay or eager forward, top-k decode), postprocess (D2H, masks at the
    frame's size, thresholds), each closed by a synchronize."""
    spans: Dict[str, list] = {}
    n = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        backend.conf_thresh = thresholds[n % len(pool)]
        with trace.span(spans, "pre"):
            batch, proc, orig, pads = backend._prepare_inputs(pool[n % len(pool)])
        with torch.inference_mode():
            with trace.span(spans, "program"):
                dec = backend._predict(batch)
            with trace.span(spans, "post"):
                backend._postprocess(dec, proc, orig, pads)
        n += 1
    return {"spans": spans, "frames": n, "window_s": time.perf_counter() - t0}


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def compared(cell, state, pool, thresholds, sample, device, mode="fp32") -> Dict[str, float]:
    """The comparison's numbers of the sampled answers against the
    reference (in ``mode``) on the same frames."""
    cfg, mix = cell["config_spec"], cell["mix"]
    ref = reference_model(cfg, state, device)
    idx = [i % len(pool) for i, _ in sample]
    raw = ref_serve.outputs(ref, torch.from_numpy(pool[idx]).to(device), cfg["input_size"], mode)
    views = ref_serve.views(raw, cfg["input_size"], mix["frame_hw"], [thresholds[i] for i in idx])
    return judge.serve_numbers([o for _, o in sample], views)


def control_answers(cell, state, pool, thresholds, sample_idx, device):
    """The control, the reference in fp8 put in the program's place: its
    served answers (``postprocess_predictions``' form) of the sampled
    frames, the top 100 masks as the program keeps them."""
    from ..reference.postprocess import postprocess_predictions, topk_decode

    cfg, mix = cell["config_spec"], cell["mix"]
    ref = reference_model(cfg, state, device)
    outs = []
    with torch.no_grad():
        for i in sample_idx:
            i %= len(pool)
            x = ref_serve.model_input(torch.from_numpy(pool[i][None]).to(device),
                                      cfg["input_size"])
            with ref_precision.fp8(torch.device(device).type):
                o = ref(x)
            dec = topk_decode(o["pred_logits"], o["pred_boxes"], 300, masks=o.get("pred_masks"))
            if "masks" in dec:
                dec["masks"] = dec["masks"][:, :100]
            outs.append(postprocess_predictions(dec, tuple(cfg["input_size"]),
                                                [tuple(mix["frame_hw"])],
                                                conf_thresh=thresholds[i])[0])
    return outs


def run(cell, seed: int, seconds: float, traced: bool, device, t_start: float) -> Dict[str, Any]:
    mix = cell["mix"]
    st = setup(cell, seed, device)
    backend, pool, thr = st["backend"], st["pool"], st["thresholds"]
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    rec: Dict[str, Any] = {"kind": "serve_stream",
                           "setup_s": time.perf_counter() - t_start - st["ref_s"],
                           "reference_setup_s": st["ref_s"]}
    rng = np.random.default_rng(seed % weights.SEED_MOD)
    win = window(backend, pool, thr, seconds, rng, mix["sample_frames"])
    rec.update({k: win[k] for k in ("latency_s", "kept", "frames", "window_s")})
    lat = np.asarray(win["latency_s"]) * 1e3
    print(f"serve_stream: {win['frames']} frames in {win['window_s']:.3f} s, p50 "
          f"{np.median(lat):.4f} ms, p95 {np.percentile(lat, 95):.4f} ms, kept a frame "
          f"{np.mean(win['kept']):.3f}; reference in set-up {st['ref_s']:.3f} s (not in setup_s)",
          file=sys.stderr, flush=True)
    rec["attempted"], rec["failed"] = win["frames"], win["malformed"]
    rec["memory_peak_bytes"] = torch.cuda.max_memory_allocated() if on_card else 0
    if traced:
        rec["span_window"] = spans_window(backend, pool, thr, seconds)
        distinct = mix["profile_distinct"]
        it = iter(range(10**9))
        rec["profile"] = trace.profiled(
            lambda: serve(backend, pool[:distinct], thr, next(it)), mix["profile_frames"])
        rec["profile_frame_reps"] = mix["profile_frames"] / distinct
    state = st["state"]
    del backend, st
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    rec["numbers"] = compared(cell, state, pool, thr, win["sample"], device)
    if traced:
        rec.update(traced_counts(cell, state, pool, device, rec["profile_frame_reps"]))
    return rec


def traced_counts(cell, state, pool, device, reps: float) -> Dict[str, Any]:
    """From the reference: the operations of one frame's forward, and the
    least time of the sampling kernel's launches in the profiled window
    (its distinct frames' calls, times their repeats)."""
    cfg, mix = cell["config_spec"], cell["mix"]
    ref = reference_model(cfg, state, device)
    x1 = ref_serve.model_input(torch.from_numpy(pool[:1]).to(device), cfg["input_size"])
    with torch.no_grad():
        flops = flop_counts.counted(lambda: ref(x1))
    ref_deform.recorded = []
    try:
        ref_serve.outputs(ref, torch.from_numpy(pool[:mix["profile_distinct"]]).to(device),
                          cfg["input_size"], block=1, keep_masks=False)
        calls = ref_deform.recorded
    finally:
        ref_deform.recorded = None
    least = deform_counts.least_seconds_of(calls, deform_counts.forward_call) * reps
    return {"flops_per_frame": flops, "deform_fwd_least_s": least}


FAULTS = ("stale", "label")


class Faulty:
    """A serving backend with a fault planted where its answer is made:
    ``stale``, each answer replaced by the previous frame's; ``label``,
    each detection's class altered."""

    def __init__(self, backend, fault: str):
        object.__setattr__(self, "backend", backend)
        object.__setattr__(self, "fault", fault)
        object.__setattr__(self, "prev", None)

    def __getattr__(self, name):
        return getattr(self.backend, name)

    def __setattr__(self, name, value):
        if name == "prev":
            object.__setattr__(self, name, value)
        else:
            setattr(self.backend, name, value)

    def __call__(self, frame):
        (out,) = self.backend(frame)
        if self.fault == "stale":
            out, self.prev = (self.prev or out), out
        elif self.fault == "label":
            out = dict(out, labels=(out["labels"] + 1) % self.backend.n_outputs)
        return [out]


def calibrate(cell, seeds, seconds: float, faults, device):
    """For each seed, the readings a cell's limits are set from: the
    program's numbers after a window of ``seconds``, those of each fault of
    ``faults`` (``FAULTS``) planted in it over the same frames, and the
    control's (the reference in fp8 in the program's place, on the
    program's sampled frames). One backend serves every seed."""
    backend = build_backend(cell["config_spec"], device)
    for seed in seeds:
        st = setup(cell, seed, device, backend)
        pool, thr, state = st["pool"], st["thresholds"], st["state"]
        out = {}
        for name, be in [("program", backend)] + [(f, Faulty(backend, f)) for f in faults]:
            rng = np.random.default_rng(seed % weights.SEED_MOD)
            win = window(be, pool, thr, seconds, rng, cell["mix"]["sample_frames"])
            out[name] = compared(cell, state, pool, thr, win["sample"], device)
            out[name]["kept_mean"] = float(np.mean(win["kept"]))
            masks = [o["masks"].reshape(len(o["masks"]), -1).any(1) for _, o in win["sample"]
                     if "masks" in o and len(o["masks"])]
            if masks:
                out[name]["nonempty_masks"] = float(np.concatenate(masks).mean())
            if name == "program":
                idx = [i for i, _ in win["sample"]]
        answers = control_answers(cell, state, pool, thr, idx, device)
        out["control"] = compared(cell, state, pool, thr, list(zip(idx, answers)), device)
        yield seed, out
