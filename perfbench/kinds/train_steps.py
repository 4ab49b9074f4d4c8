"""Traffic kind ``train_steps``: the program's train step
(``make_train_step``) on batches drawn from the seed.

Set-up builds one ``TrainState`` with the run's seeded weights and the
configuration's optimizer, freeze mask and EMA, and a ring of
``ring_batches`` batches with their CDN noise (images as ``weights.images``
draws them, ``gt_slots`` target slots an image, of which as many hold
valid boxes as ``boxes_per_image`` gives: one count an image of the ring,
the same counts on every seed in the seed's order; with ``masks`` the
ellipse inscribed in each box at the mask head's stride 4).
It drives the state through ``checked_steps`` steps on the ring's first
batches, reading each step's loss, the first clipped gradient (the
optimizer's first moment) and, after the last, each parameter's and EMA
leaf's change; then ``warmup_steps`` more. The window runs the same step
on the ring's batches in turn, from the same state, and ends with a
synchronize; the reference follows the checked steps after it.
"""

from __future__ import annotations

import gc
import sys
import time
from typing import Any, Dict, List

import numpy as np
import torch

from .. import judge, trace, weights
from ..counts import deform as deform_counts
from ..counts import flops as flop_counts
from ..reference import model as ref_model
from ..reference import train as ref_train
from .serve_stream import check_registry

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def ellipses(boxes: torch.Tensor, valid: torch.Tensor, hw) -> torch.Tensor:
    """[B, G, H, W] f32: the ellipse inscribed in each valid cxcywh box."""
    h, w = hw
    y = ((torch.arange(h, device=boxes.device) + 0.5) / h)[:, None]
    x = ((torch.arange(w, device=boxes.device) + 0.5) / w)[None, :]
    cx, cy, bw, bh = (boxes[..., i][..., None, None] for i in range(4))
    inside = ((x - cx) / (bw / 2)) ** 2 + ((y - cy) / (bh / 2)) ** 2 <= 1.0
    return (inside & valid[..., None, None]).float()


def ring(cfg, mix, seed: int, device) -> List[Dict[str, Any]]:
    """The ring's batches: {"images", "targets", "noise"} (noise: the CDN
    draws flip, new_label, sign, part over the 2 * G denoising slots)."""
    rng = np.random.default_rng(seed % weights.SEED_MOD)
    g = weights.generator(seed, device, stream=2)
    b, slots, c = mix["batch"], mix["gt_slots"], cfg["num_classes"]
    counts = np.asarray(mix["boxes_per_image"])
    if counts.shape != (mix["ring_batches"] * b,) or counts.min() < 1 or counts.max() > slots:
        raise ValueError("boxes_per_image: one count in 1..gt_slots for each image of the ring")
    counts = rng.permutation(counts).reshape(mix["ring_batches"], b)
    h, w = cfg["input_size"]
    groups = max(1, cfg["decoder"]["num_denoising"] // slots)
    d = 2 * groups * slots
    ratio = cfg["decoder"]["label_noise_ratio"]
    out = []
    for n_valid in counts:
        wh = rng.uniform(0.03, 0.4, (b, slots, 2))
        cxcy = rng.uniform(wh / 2, 1 - wh / 2)
        boxes = torch.from_numpy(np.concatenate([cxcy, wh], -1).astype(np.float32)).to(device)
        valid = torch.from_numpy(np.arange(slots)[None] < n_valid[:, None]).to(device)
        targets = {"labels": torch.from_numpy(rng.integers(0, c, (b, slots))).to(device),
                   "boxes": boxes, "valid": valid}
        if cfg["mask_head"]:
            targets["masks"] = ellipses(boxes, valid, (h // 4, w // 4))
            targets["mask_valid"] = valid
        noise = (torch.rand((b, d), generator=g, device=device) < ratio * 0.5,
                 torch.randint(0, c, (b, d), generator=g, device=device),
                 torch.randint(0, 2, (b, d, 4), generator=g, device=device).float() * 2.0 - 1.0,
                 torch.rand((b, d, 4), generator=g, device=device))
        images = weights.images(g, b, (h, w), device)
        out.append({"images": images, "targets": targets, "noise": noise})
    return out


def program_state(cfg, w: Dict[str, torch.Tensor], device):
    """The program's TrainState and step for the configuration, with the
    weights ``w``."""
    from dfine_tpu_torch.models.dfine import build_model
    from dfine_tpu_torch.train.criterion import CriterionConfig, default_weight_dict
    from dfine_tpu_torch.train.optim import OptimConfig, build_optimizer, freeze_mask
    from dfine_tpu_torch.train.train_step import TrainState, make_train_step

    check_registry(cfg)
    model = build_model(cfg["program_size"], cfg["num_classes"], cfg["mask_head"], device=device)
    model.load_state_dict(w, strict=True)
    fz = cfg["freeze"]
    mask = (freeze_mask(model, fz["backbone_norm"], fz["stem"])
            if fz["backbone_norm"] or fz["stem"] else None)
    o = dict(cfg["optim"])
    o["betas"] = tuple(o["betas"])
    state = TrainState.create(model, build_optimizer(model, OptimConfig(**o)))
    losses = tuple(cfg["criterion"]["losses"]) + (("masks",) if cfg["mask_head"] else ())
    crit = CriterionConfig(num_classes=cfg["num_classes"], losses=losses,
                           weight_dict=default_weight_dict(), reg_max=cfg["decoder"]["reg_max"],
                           reg_scale=cfg["decoder"]["reg_scale"])
    step = make_train_step(crit, compute_dtype=DTYPES[cfg["train_compute_dtype"]],
                           ema_base=cfg["ema_base"], update_mask=mask)
    return state, step


def call(step, state, batch):
    """The window's call: one step on a ring batch and its noise."""
    from dfine_tpu_torch.models.denoising import CdnNoise

    return step(state, {"images": batch["images"], "targets": batch["targets"]},
                dn_noise=CdnNoise(*batch["noise"]))


def checked_steps(state, step, batches, w) -> Dict[str, Any]:
    """The program's readings over the checked steps (``judge.train_numbers``)."""
    model, opt = state.model, state.optimizer
    names = {p: k for k, p in model.named_parameters()}
    beta1 = opt.adamw.defaults["betas"][0]
    losses, grad = [], {}
    for i, batch in enumerate(batches):
        _, m = call(step, state, batch)
        losses.append(float(m["loss"]))
        if i == 0:
            grad = {names[p]: float(s["exp_avg"].norm()) / (1 - beta1)
                    for p, s in opt.adamw.state.items()}
    change = {k: float((p.detach() - w[k]).norm()) for k, p in model.named_parameters()}
    emas = {k: float((p - w[k]).norm()) for k, p in state.ema.named_parameters()}
    return {"losses": losses, "grad": grad, "change": change, "ema": emas}


def setup(cell, seed: int, device) -> Dict[str, Any]:
    cfg, mix = cell["config_spec"], cell["mix"]
    shapes = weights.shapes_of(ref_model_meta(cfg))
    w = weights.for_config(cfg, shapes, seed, device)
    state, step = program_state(cfg, w, device)
    batches = ring(cfg, mix, seed, device)
    ours = checked_steps(state, step, batches[:mix["checked_steps"]], w)
    del w
    for i in range(mix["warmup_steps"]):
        call(step, state, batches[(mix["checked_steps"] + i) % len(batches)])
    _sync(device)
    return {"state": state, "step": step, "batches": batches, "ours": ours}


def ref_model_meta(cfg):
    return ref_model.build(cfg, "meta")


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def window(state, step, batches, seconds: float, device, first: int) -> Dict[str, Any]:
    """Steps on the ring's batches in turn for ``seconds``, then a
    synchronize: every step issued is done when the window closes.
    ``issued_s``: when each step's call returned, from the window's start."""
    losses, issued, n = [], [], 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        _, m = call(step, state, batches[(first + n) % len(batches)])
        losses.append(m["loss"])
        issued.append(time.perf_counter() - t0)
        n += 1
    _sync(device)
    wall = time.perf_counter() - t0
    bad = int((~torch.isfinite(torch.stack(losses).float())).sum()) if losses else 0
    return {"steps": n, "window_s": wall, "failed": bad, "issued_s": issued}


def chunk_rates(issued, batch: int, chunk_s: float = 10.0):
    """Images a second of the steps issued in each ``chunk_s`` of the
    window (the last, partial chunk left out)."""
    out, t, n = [], chunk_s, 0
    for x in issued:
        if x > t:
            out.append(n * batch / chunk_s)
            t, n = t + chunk_s, 0
        n += 1
    return out


def reference_readings(cell, seed, batches, device, mode="fp32"):
    cfg, mix = cell["config_spec"], cell["mix"]
    shapes = weights.shapes_of(ref_model_meta(cfg))
    w = weights.for_config(cfg, shapes, seed, device)
    k = mix["checked_steps"]
    return ref_train.readings(cfg, w, batches[:k], [b["noise"] for b in batches[:k]], mode,
                              device)


def run(cell, seed: int, seconds: float, traced: bool, device, t_start: float) -> Dict[str, Any]:
    cfg, mix = cell["config_spec"], cell["mix"]
    st = setup(cell, seed, device)
    state, step, batches = st["state"], st["step"], st["batches"]
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    first = mix["checked_steps"] + mix["warmup_steps"]
    rec: Dict[str, Any] = {"kind": "train_steps", "setup_s": time.perf_counter() - t_start,
                           "batch": mix["batch"]}
    win = window(state, step, batches, seconds, device, first)
    rec.update({"steps": win["steps"], "window_s": win["window_s"]})
    print(f"train_steps: {win['steps']} steps in {win['window_s']:.3f} s, "
          f"{win['steps'] * mix['batch'] / win['window_s']:.4f} img/s; issued a 10 s chunk: "
          f"{[round(r, 3) for r in chunk_rates(win['issued_s'], mix['batch'])]} img/s",
          file=sys.stderr, flush=True)
    rec["attempted"], rec["failed"] = win["steps"], win["failed"]
    rec["memory_peak_bytes"] = torch.cuda.max_memory_allocated() if on_card else 0
    prof_idx = []
    if traced:
        it = iter(range(10**9))

        def one():
            i = (first + win["steps"] + next(it)) % len(batches)
            prof_idx.append(i)
            call(step, state, batches[i])

        rec["profile"] = trace.profiled(one, mix["profile_steps"])
    ours = st["ours"]
    del state, step, st
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    rec["numbers"] = judge.train_numbers(ours, reference_readings(cell, seed, batches, device))
    if traced:
        rec.update(traced_counts(cell, seed, [batches[i] for i in prof_idx], device))
    return rec


def traced_counts(cell, seed, profiled_batches, device) -> Dict[str, Any]:
    """From the reference: the operations of a forward and backward of one
    batch, and the least time of the deform backward's launches in the
    profiled steps (their batches' sampling calls, at the seeded weights)."""
    cfg = cell["config_spec"]
    shapes = weights.shapes_of(ref_model_meta(cfg))
    w = weights.for_config(cfg, shapes, seed, device)
    model = ref_model.build(cfg, device)
    model.load_state_dict(w, strict=True)
    model.train()
    crit = ref_train.criterion_config(cfg)
    b = profiled_batches[0]
    from ..reference.denoising import CdnNoise

    def fwd_bwd():
        out = model(b["images"], b["targets"], CdnNoise(*b["noise"]))
        ref_train.criterion_forward(out, b["targets"], crit)["total"].backward()

    flops = flop_counts.counted(fwd_bwd)
    del model
    calls = ref_train.sampling_calls(cfg, w, profiled_batches,
                                     [x["noise"] for x in profiled_batches], device)
    least = deform_counts.least_seconds_of(calls, deform_counts.backward_call)
    return {"flops_per_step": flops, "deform_bwd_least_s": least}


FAULTS = ("half_batch",)


def half(batch):
    """The batch with its second half left out (the mean over the rest)."""
    n = batch["images"].shape[0] // 2
    return {"images": batch["images"][:n],
            "targets": {k: v[:n] for k, v in batch["targets"].items()},
            "noise": tuple(t[:n] for t in batch["noise"])}


def calibrate(cell, seeds, seconds: float, faults, device):
    """For each seed, the readings a cell's limits are set from: the
    program's numbers over the checked steps, those of each fault of
    ``faults`` (``FAULTS``) planted in it, and the control's (the reference
    in fp8 against the fp32 reference). The checked steps need no window:
    ``seconds`` is not used."""
    cfg, mix = cell["config_spec"], cell["mix"]
    k = mix["checked_steps"]
    shapes = weights.shapes_of(ref_model_meta(cfg))
    for seed in seeds:
        batches = ring(cfg, mix, seed, device)
        theirs = reference_readings(cell, seed, batches, device)
        out = {}
        for name in ("program",) + tuple(faults):
            w = weights.for_config(cfg, shapes, seed, device)
            state, step = program_state(cfg, w, device)
            feed = batches[:k] if name != "half_batch" else [half(b) for b in batches[:k]]
            ours = checked_steps(state, step, feed, w)
            out[name] = judge.train_numbers(ours, theirs)
            out[name]["losses"] = ours["losses"]
            del state, step, w
            gc.collect()
        ctrl = reference_readings(cell, seed, batches, device, mode="fp8")
        out["control"] = judge.train_numbers(ctrl, theirs)
        out["reference_losses"] = theirs["losses"]
        yield seed, out
