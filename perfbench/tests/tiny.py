"""A checkout-like root of tiny cells for the CPU tests: D-FINE-n det+seg
at 320 px with 8 classes, served and trained at small sizes. The program
runs them in float32 on the CPU, where it reads within about 1e-6 of the
reference (5e-5 on the parameters' change), so their limits are set some
ten to a hundred times above that: far under what the fp8 control and the
faults read at this size."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from perfbench.manifest import ROOT, load_json

SERVE_MIX = {"kind": "serve_stream", "why": "tiny", "frame_hw": [180, 320], "pool_frames": 4,
             "calibration_frames": 2, "keep_per_frame": 5, "warmup_frames": 1,
             "sample_frames": 2, "profile_distinct": 2, "profile_frames": 2}
TRAIN_MIX = {"kind": "train_steps", "why": "tiny", "batch": 2, "gt_slots": 10,
             "boxes_per_image": [2, 3, 4, 6, 2, 5, 1, 6], "ring_batches": 4, "checked_steps": 3,
             "warmup_steps": 0, "profile_steps": 1}


def config():
    from dfine_tpu_torch.configs import model_config

    cfg = load_json(ROOT / "perfbench" / "configs" / "dfine_m_seg_640.json")
    n = model_config("n")
    cfg.update(name="tiny_n_seg_320", program_size="n", num_classes=8, input_size=[320, 320],
               serve_dtype="float32", train_compute_dtype="float32",
               backbone=n["backbone"], encoder=n["encoder"], decoder=n["decoder"])
    return cfg


SERVE_LIMITS = {"unmatched_share": 0.05, "box_gap_median_px": 0.05, "score_gap_median": 1e-3,
                "mask_gap_median": 0.05}
TRAIN_LIMITS = {"loss_gap": 1e-4, "grad_gap_median": 1e-4, "grad_gap_q90": 1e-3,
                "change_gap_median": 1e-3, "ema_gap_median": 1e-3}


def make_root(tmp: Path, serve_limits=None, train_limits=None) -> Path:
    """``tmp`` laid out as a checkout holding the cells ``tiny_serve`` and
    ``tiny_train`` (the code is the real ``perfbench``'s); the limits are
    ``SERVE_LIMITS`` / ``TRAIN_LIMITS`` unless given."""
    man = load_json(ROOT / "BENCHMARK.json")
    pb = tmp / "perfbench"
    for sub in ("configs", "traffic", "limits"):
        (pb / sub).mkdir(parents=True, exist_ok=True)
    (pb / "configs" / "tiny_n_seg_320.json").write_text(json.dumps(config()))
    (pb / "traffic" / "tiny_cam.json").write_text(json.dumps(SERVE_MIX))
    (pb / "traffic" / "tiny_train.json").write_text(json.dumps(TRAIN_MIX))
    (pb / "limits" / "tiny_serve.json").write_text(json.dumps(serve_limits or SERVE_LIMITS))
    (pb / "limits" / "tiny_train.json").write_text(json.dumps(train_limits or TRAIN_LIMITS))
    man["configs"].append({"name": "tiny_n_seg_320", "source": "test", "reduced": [],
                           "file": "perfbench/configs/tiny_n_seg_320.json", "why": "test"})
    man["workloads"] += [
        {"name": "tiny_serve", "config": "tiny_n_seg_320", "traffic": "tiny_cam", "chips": 1,
         "why": "test"},
        {"name": "tiny_train", "config": "tiny_n_seg_320", "traffic": "tiny_train", "chips": 1,
         "why": "test"}]
    for m in man["end_to_end"] + man["per_layer"]:
        if "workloads" in m:
            kind = "serve" if any("serve" in w for w in m["workloads"]) else "train"
            m["workloads"].append(f"tiny_{kind}")
    (tmp / "BENCHMARK.json").write_text(json.dumps(man))
    return tmp


def copy_checkout(tmp: Path) -> Path:
    """A copy of the committed benchmark's files under ``tmp``."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp / "BENCHMARK.json")
    shutil.copytree(ROOT / "perfbench", tmp / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    return tmp
