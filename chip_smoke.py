#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (``dfine_tpu_torch``) on one NVIDIA card.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each printed as one JSON line:

1. build: every hand-written kernel from ``dfine_tpu_torch/csrc`` (one nvcc
   per source, started together), with each kernel's registers and spills
   and the atomic opcodes in its SASS (none in the tensor-core scatter);
   no instance of the deformable-attention backward kernel may have a
   stack frame or spill;
2. kernels: each kernel against its plain PyTorch version on the card at the
   shapes of D-FINE-m at 640 px (TF32 off), with its time, the plain
   version's, one PyTorch call's where one computes the same function, and
   the least time the card could take (bound); the deformable-attention
   kernel also beside the time of a launch of it with no work, on the
   non-square levels of every rect bucket and at apps.test_batching's
   batch 32. The three
   row scatter-adds
   (the value gradient of the deformable attention: ``rows_scatter_add``,
   ``_mxu`` and ``_tiled``) run at the train step's shapes and at head dim
   16, ``_tiled`` also bit for bit against its plain version on the CPU;
   one call of each, at every head dim, must be its kernel alone: the call
   captured in a CUDA graph and the graph's nodes counted (no profiler);
2b. core_backward, core_bwd_kernel: ``MSDeformAttnCore``'s backward
   against autograd of the plain core (one backward kernel and one scatter
   a level a call); the deformable-attention backward kernel
   (``csrc/ms_deform_attn_bwd.cu``) against its plain version, the closed
   form, at m@640, B = 8, Q = 300, bf16 value, D = 32 and 64, f32 and bf16
   payload (idx equal, contrib bit-equal, gradients within GRAD_REL_TOL),
   with the value frozen, on the shared cases and off the map; each timed
   beside its plain version, with the device activities and CUDA-graph
   nodes of one call of each and its bound;
3. model: the m det+seg model on the card, fp32, against the same weights
   on the CPU through the plain path;
4. serving: ``TorchModel`` (m det+seg, bf16) answers 720p BGR frames, with
   the deformable-attention kernel's launch count read around the run;
5. gradient: one backward of the m det+seg model at batch 8, through the
   ``MSDeformAttnCore`` backward (its backward kernel and the scatter
   kernel), counts read around it;
6. train: the m detect train step (``make_train_step``: CDN queries,
   Hungarian matching on the device, criterion, AdamW, EMA) at 640 px,
   batch 8, bf16 autocast over fp32 parameters, replaying its CUDA graph:
   the launches the graph holds (1 solver launch a step, 4 backward
   launches; none from Python on a replay) and the solver's device ms a
   step (CUDA events around it in eager steps, and its kernel in a
   profile); then one eager step with the backward kernel and one with its
   plain closed form patched in, in turns, profiled (device ms and
   activities);
6b. hungarian: one more train step with its matching span (matching_cost,
   the solver, the go union) under ``set_sync_debug_mode("error")``; the
   Hungarian kernel (``csrc/hungarian_lap.cu``) against its plain version
   on the card and on the CPU, assignment for assignment, on that step's
   [6, 8, 100, 300] costs, on random problems (pad rows, an image without
   a valid row, square, G = 1, Q = 40, 300 and 500) and on the one-to-many
   costs with +1e6 blocks; on integer costs (ties) the same optimum;
   scipy's optimum on every case; its time beside the plain version's on
   the card, the path it replaced (the costs to the host, scipy's 48
   solves) and its bound; one kernel a call by the graph count, a CUDA
   graph of it replayed against eager; the train step timed with it and
   with the replaced host path, in turns;
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

The serving surface (m det+seg, 640 px, bf16 unless said, ``build_model``'s
seeded weights loaded from a reference-style ``.pth``; 720p BGR frames plus
one 1080x1920 and one 1200x1600; the fp32 comparisons of 14-15 on weights
re-drawn from seed 1):

13. serving_modes: ``TorchModel`` in letterbox, rect (buckets made at
    load) and NMS mode, each frame's threshold keeping 15-40 detections: call p50/p90, kept a frame, 4 deform launches a
    frame, boxes inside the frame and masks of the frame's size; letterbox
    and rect boxes against plain's on a square frame (1 px); the
    deformable-attention kernel against its plain version on the inputs that
    serving the 1080x1920 and 1200x1600 frames in rect mode gives it;
    ``mask2poly`` (no cv2) on served masks;
14. deploy: the serving fold (folded) against unfused at fp32 on the card
    (phase_model's rule), and bf16 serving of both with device busy ms and
    activities a frame;
15. int8: ``w8a8`` and ``w8a16`` at fp32, card against the same converted
    model on the CPU (logits and masks within twice the CPU model's own
    reaction to a 1e-6 input perturbation; the card in the other mode must
    read at least 3 times those limits), bf16 serving of each,
    ``count_int8``;
16. aot_graph: ``AOTModel`` plain and rect (a CUDA graph per bucket, one
    pool): replay against the same model run eagerly (fp32), bf16 call
    p50/p90, the deform launches a frame from the profiler's kernel names,
    device busy and idle share, pool bytes;
17. export: ``export_model`` (.pt2, npz, graph manifest) and a dynamic-batch
    .pt2; a fresh process imports ``dfine_tpu_torch``, loads and serves
    them; the program's outputs against the eager fused model.

The trainer entry point:

18. trainer: ``Trainer(cfg).train()`` (what ``python -m
    dfine_tpu_torch.apps.train`` runs) with the repo's config.yaml read by
    the port's reader: m det+seg at 640 px, batch 8, bf16, 2 epochs on a
    synthetic segment dataset of 40 PNG frames at 720x1280 (32 train, 8
    val; mosaic in epoch 0), with the launches of the whole run (4 sampling
    launches a step and an eval batch, 12 scatters a step); step and loader
    wait p50/p90, eval ms an image (device and host tail), checkpoint
    seconds and MB, peak memory, the image decoder and plot writer used.
    Then a fresh trainer resumed from ``last`` for a third epoch (step,
    optimizer count and best_metric carried), ``TorchModel`` serving
    ``best`` against the trainer's own eval of the same input, and one
    sampling call of the trainer's eval and one scatter call of its step
    against their plain versions.

Data parallelism (``phase_dp``; two ranks on one card measure no scaling):

19. dp: (a) the m det+seg DP step (bf16, batch 8, SyncBN forced) in a
    one-rank NCCL group against the plain step on the same weights, batch
    and CDN noise (loss within 1e-6, gradients within the bf16 limit of
    phase 8), then timed beside the plain step with its launches a step,
    and in turns with the same DP step on the flat optimizer (p50, p90 and
    device busy ms of each);
    (b) two processes sharing the card over gloo (picked because both see
    one device UUID): the fp32 DP step on 2 x 4 rows against the
    single-process step on the 8 rows (loss, grad norm, parameters at
    tests/test_multichip.py's tolerances), both ranks bit-equal after it,
    each rank's launches and its first sampling and scatter calls against
    their plain versions; then one flat-optimizer DP step of each rank
    against the single-process flat step by the same rules; (c) ``python
    -m dfine_tpu_torch.apps.train``'s main in two processes with ``train.dp.multihost`` on the trainer
    phase's dataset (each train frame once, batch 4, one epoch): equal
    ranks, every val frame gathered once, the final metrics equal to a
    single-process eval of ``last.ckpt``, no file written by rank 1 (an
    audit hook), ``best`` served by ``TorchModel``, each rank's launches.
    The backend, step p50 and seconds of each run are printed.

The apps, on the trainer's experiment (``phase_apps``):

20. apps: ``apps.export`` (the repo's formats: graph manifest and
    ``.pt2``); the val frames relabelled with ``best``'s own fp32
    detections at the middle of the widest gap between their scores that
    no detection's eager and ``.pt2`` scores straddle (``keep_threshold``,
    ``paired_spans``), in the first keep window of ``APPS_KEEP_WINDOWS``
    that has one (``widened_threshold``; the window used is printed);
    ``python -m dfine_tpu_torch.apps.infer`` in a subprocess over the val
    frames with the most detections (files written, polygon lines and
    crops among them, 4 sampling launches a frame); ``apps.bench`` (eager, CUDA graph and
    ``.pt2`` rows: eager and graph F1 equal, the ``.pt2``'s at least
    APPS_EXPORT_F1_SHARE of eager's, or, where no window had a free gap,
    with each detection of a straddling pair counted on both sides: kept in
    both backends and dropped in both (``EitherWay``); latency a frame); the ``.pt2`` against
    the eager backend, which serves its model, detection by detection near
    the threshold (``threshold_drift``: scores within EXPORT_SCORE_ATOL, and
    the same F1 exactly wherever that drift changes no detection's side;
    reported beside half the threshold's gap); ``apps.check_errors``;
    ``apps.quant`` with the config's ``int8_max_drop``, forced to revert
    every kernel (it must end at ``count_int8 = (0, n)`` with the fp F1),
    and with ``int8_max_drop=1`` (every kernel stays int8); ``Int8Model``
    on that run's ``export_int8.npz`` against its eval (the same int8
    modules, integers and scales, at least one of them, and the same F1 as
    that run's int8 model under the serving fold, which ``Int8Model``
    serves);
    ``apps.test_batching``'s sweep at batch 1-32 (img/s, ms an image, graph
    pool bytes), with the first sampling call of each batch size held
    against the plain version and the batch-32 graph's decode against the
    same program run eagerly on the same batch; the etl tools
    (split, coco_yolo both ways, mask_tools, preprocess) on a copy of the
    dataset. Each app's launch counts are set to 0 before it and read
    after; the phase's seconds are printed.

The widened decoder tail, extra pyramid levels and the flat optimizer (run
after 12, before 13, beside the other train phases):

21. wide_tail: m detect with ``decoder.layer_scale`` 2 past ``eval_idx`` 1
    (layers 2-3 at d = 512, head dim 64). Each kernel at D = 64 against its
    plain version (the sampling kernel, bf16 and f32, on the cases of
    ``tests/test_torch_port_deform_cases.py`` and at the wide layer's train
    shape; the three scatters at the train step's shapes with
    ``index_add_`` beside them and on the cases of
    ``tests/test_torch_port_scatter_cases.py``), timed beside their plain
    versions and bounds; the wide train step (bf16, batch 8): 2 warm-up and
    10 timed steps, p50/p90, device ms, peak memory, launches by kernel and
    head dim (2 + 2 sampling, 6 + 6 scatters a step); the three scatters
    and ``index_add_`` on one more step's own D = 64 inputs; ``TorchModel``
    serving the trained weights (eval stops at ``eval_idx``, 2 sampling
    launches a frame); the first step in fp32 card
    against CPU (``train_parity``'s rules);
22. extra_level: m det+seg with a fourth level (stride 64, points (3, 6,
    3, 3)): ``TorchModel`` serving 12 frames (4 launches a frame over 4
    levels, the served sampling inputs against the plain version), one
    train step at batch 8 (4 + 16 launches), the fp32 model card against
    CPU, the 4-level ``AOTModel`` replayed against eager (fp32) and
    served in bf16 (the extra level's BatchNorm folded);
23. flat_optim: ``build_optimizer(flat=True)`` against the four-group
    ``Optimizer`` on path 21's model with the freeze mask, per-group peaks
    and ``b_accum_steps`` 2, from the same gradients: parameters and EMA
    after 3 optimizer steps within FLAT_ATOL; then each one's optimizer
    tail (clip, AdamW, EMA) timed in the same call, with its device
    activities.

The first line says which optional packages (PIL, matplotlib, yaml,
imageio, torchvision) the card's Python imports. Then one
``{"kernels": [...]}`` line, the card's name and power limit as
nvidia-smi gives them, and, if every phase passed, the last line
``{"ok": true, "device": {...}}``. Without a CUDA device, or outside a
checkout of the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import copy
import csv
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
SOLVER_EAGER_STEPS = 3  # eager steps whose solver launches CUDA events time
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
# the serving surface: timed calls a mode; fused vs unfused fp32 logits and
# masks (test_serving.py:44-46's logit tolerance); a graph replay against
# the same model run eagerly (the same kernels on the same inputs: expected
# bit-equal); the exported bf16 program against the eager fused model
MODE_FRAMES = 12
DEPLOY_ATOL = 2e-3
# int8 card vs CPU: each side's fp32 activations differ by about this share
# (phase_model: logits within 1e-4), so the int8 model is held to its own
# reaction to an input perturbed by it
NOISE_REL = 1e-6
# ... and these limits must fail the card run in the other int8 mode by this factor
WRONG_MODE_MARGIN = 3.0
GRAPH_ATOL = 1e-5
EXPORT_SCORE_ATOL = 1e-3
# the trainer entry point: a synthetic segment dataset of 720p PNG frames, m
# det+seg at 640 px, batch 8, bf16, 2 epochs then a resumed third; serving
# best (fp32) against the trainer's eval model under the same serving fold
# (``fold_for_serving``) on the same input: the same weights, folded tensors
# and kernels on the same tensor, so expected equal
TRAINER_FRAMES, TRAINER_TRAIN_FRAMES, TRAINER_HW, TRAINER_CLASSES = 40, 32, (720, 1280), 3
TRAINER_BATCH, TRAINER_EPOCHS = 8, 2
# train.csv lists each train frame this many times (each listing its own
# sample: own augmentations, own cache entry), so that an epoch is long
# enough for the loader to run behind the steps: 32 steps an epoch
TRAINER_REPEAT = 8
SERVE_SCORE_ATOL, SERVE_BOX_ATOL_PX, SERVE_MASK_SHARE = 1e-5, 1e-3, 1e-4
# the apps on the trainer's run: val relabelled with best's own detections
# at keep_threshold's threshold (the middle of the widest score gap that
# keeps APPS_KEEP // 2 to APPS_KEEP in the busiest frame, outside the spans
# of the detections' eager and .pt2 scores; where that window has no such
# gap, the next of APPS_KEEP_WINDOWS that has one); infer over the
# APPS_INFER_FRAMES val frames with the most of the eager backend's own
# detections at a threshold in its scores' widest gap that keeps 1 to
# APPS_KEEP in the busiest frame (infer_threshold); test_batching's sweep
# over APPS_BATCH_IMAGES images a batch size, up to APPS_MAX_BATCH. The .pt2
# is the eager backend's model in bf16: its bench row must keep
# APPS_EXPORT_F1_SHARE of eager's F1 (the runs on the mask-polygon labels
# read 0.95, 0.96 and 1.0 of it on an H100 80GB HBM3 at 700 W, 0.72 once at
# a threshold 1e-6 above a score, and 0.89 once in a gap of the fp32 scores
# alone, which eager's and the .pt2's scores, up to 0.0045 apart, straddled
# 1-7 times a run); where no window has a free gap, each detection of a
# straddling pair counts on both sides (as COCO's ignore regions do): the
# share must hold with those detections all kept in both backends and with
# them all dropped (EitherWay). Near the threshold the .pt2's scores stay
# within EXPORT_SCORE_ATOL of eager's (as phase_export holds them on one
# input), and where that drift moves no eager detection across the
# threshold, bench's F1 of the two is equal exactly
APPS_KEEP, APPS_INFER_FRAMES, APPS_BATCH_IMAGES, APPS_MAX_BATCH = 20, 4, 128, 32
APPS_EXPORT_F1_SHARE = 0.9
# the keep windows (least, most kept in the busiest val frame) tried in turn
# for a threshold outside every eager/.pt2 span, the first APPS_KEEP's; no
# window keeps fewer than 5 (a window reaching 1 took a free gap at the top
# scores, 5 labels over 8 frames, on an H100: too few for quant's F1)
APPS_KEEP_WINDOWS = ((APPS_KEEP // 2, APPS_KEEP), (APPS_KEEP // 4, 3 * APPS_KEEP // 2))
# the scores near the threshold: each backend served at this much under the
# lowest threshold that keeps the widest keep window's most in every val
# frame, and the detections within half of it of conf compared
# (threshold_drift)
APPS_DRIFT_WINDOW = 0.02
# data parallelism (phase_dp): the m det+seg step at world 1 over NCCL (bf16,
# SyncBN forced) against the plain step, then DP_STEPS timed; two gloo ranks
# sharing the card on 2 x 4 rows against the single-process step on the 8
# rows (fp32, no CDN queries and no DDF, whose weights scale with the rank's
# own batch by design, as in tests/test_multichip.py); the trainer's entry
# point in two processes at DP_TRAINER_BATCH (2 rows a rank: SyncBN on).
# The loss and parameter tolerances are tests/test_multichip.py's. Its grad
# norm's too (1e-4; 1.1e-5 on an H100 80GB HBM3 at 700 W), though the
# backbone convs ahead of a train-mode BatchNorm have gradients that cancel
# at random weights: summing the batch as 2 x 4 rows instead of 8 moved
# their first moments by 1.2 % a tensor and the grad norm by 2.5e-4 in a CPU
# rehearsal at n det+seg, 320 px. AdamW's first step moves a parameter
# by about DP_LR with the sign of its gradient, so an element whose gradient
# is one of rounding may step the other way: every element within 2 DP_LR +
# 2e-6 and at most DP_FAR_SHARE of them beyond the parameter tolerance
# (tests/test_torch_port_dp.py's rule)
DP_STEPS, DP_TRAINER_BATCH = 5, 4
DP_OVERRIDES, DP_LOSSES = (("decoder.num_denoising", 0),), ("vfl", "boxes")
DP_LOSS_RTOL, DP_GNORM_RTOL, DP_PARAM_RTOL, DP_PARAM_ATOL = 1e-5, 1e-4, 1e-4, 1e-5
DP_LR, DP_FAR_SHARE = 2e-5, 0.005
# the widened decoder tail (path A): m detect with layer_scale 2 past eval_idx
# 1, so layers 2-3 run at d = 512 (head dim 64) in training, and eval runs
# layers 0-1 only
WIDE_OVERRIDES = (("decoder.layer_scale", 2), ("decoder.eval_idx", 1))
WIDE_HEAD_DIM, WIDE_LAYERS, WIDE_EVAL_LAYERS = 64, 2, 2
# a fourth level (path B): m det+seg, stride 64 (10 x 10 at 640 px), 15 points
EXTRA_LEVELS = 4
EXTRA_OVERRIDES = (("decoder.num_levels", EXTRA_LEVELS), ("decoder.num_points", (3, 6, 3, 3)))
# the flat optimizer (path C) against the four-group one from the same
# gradients: 3 optimizer steps of 2 micro-steps; each parameter and EMA
# element within FLAT_ATOL, a twentieth of the first steps' learning rate
# (2e-5) and far above the f32 rounding of an update (tests/
# test_torch_port_flat_optim.py holds the same limit on the CPU)
FLAT_STEPS, FLAT_ATOL = 3, 1e-6
# the m train step timed with the device solver and with the host scipy path
# it replaced, in turns (device, scipy, scipy, device) this many times
HUNGARIAN_STEP_TURNS = 10
# the dependent butterfly argmins of hungarian_lap_probe a timed launch: the
# time of one path step's argmin is the launch's time less an empty one's,
# over this count
HUNGARIAN_PROBE_ITERS = 20000
# packages the port may use where present, never needs: the run reports which import
OPTIONAL_PACKAGES = ("PIL", "matplotlib", "yaml", "imageio", "torchvision")


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
                     if any(k in e.key for k in ("ms_deform_attn_fwd_kernel",
                                                 "ms_deform_attn_bwd_kernel", "rows_scatter_add",
                                                 "hungarian_lap_kernel", *BN_SYMBOLS))}}


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


def build_source(path, name: str):
    """An earlier source of a kernel (a CUDA file with a plain C interface),
    built as the port's kernels are built into ``_build/earlier/lib<name>.so``,
    for timing it beside the port's: (the loaded library, nvcc's ptxas
    lines by kernel)."""
    import ctypes
    from pathlib import Path

    from dfine_tpu_torch.ops.kernels import _build

    lib = _build.BUILD_DIR / "earlier" / f"lib{name}.so"
    log = _build.compile_source(Path(path), lib)
    return ctypes.CDLL(str(lib)), ptxas_by_kernel(log)


def ptxas_numbers(line: str) -> dict:
    """Registers, stack frame and spill bytes from one kernel's ptxas lines
    (``ptxas_by_kernel``'s value); None where a number is missing."""
    def num(pattern):
        m = re.search(pattern, line)
        return int(m.group(1)) if m else None

    return {"registers": num(r"Used (\d+) registers"),
            "stack_frame_bytes": num(r"(\d+) bytes stack frame"),
            "spill_store_bytes": num(r"(\d+) bytes spill stores"),
            "spill_load_bytes": num(r"(\d+) bytes spill loads")}


# the backward kernel's instances (value bf16/f32 x payload bf16/f32 x D 16/32/64),
# and the one the default train step launches: bf16 value, f32 payload, D = 32
BWD_INSTANCES = 12
BWD_MAIN_INSTANCE = "ms_deform_attn_bwd_kernelI13__nv_bfloat16fLi32E"


def bwd_build(ptxas: dict) -> dict:
    """The backward kernel's build from its library's ptxas lines: every
    ``ms_deform_attn_bwd_kernel`` instance's numbers, the main instance's,
    and ``clean``: all BWD_INSTANCES found, none with a stack frame or a
    spill (the level table and the pair arrays must stay in registers)."""
    inst = {k: ptxas_numbers(v) for k, v in ptxas.items() if "ms_deform_attn_bwd_kernel" in k}
    main = [v for k, v in inst.items() if BWD_MAIN_INSTANCE in k]
    clean = len(inst) == BWD_INSTANCES and all(
        v["stack_frame_bytes"] == 0 and v["spill_store_bytes"] == 0
        and v["spill_load_bytes"] == 0 for v in inst.values())
    return {"instances": len(inst), "clean": clean, "main": main[0] if len(main) == 1 else None}


def phase_build(res):
    from dfine_tpu_torch.ops.kernels import _build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(_build.SOURCES)) as pool:  # one nvcc per source, together
        list(pool.map(_build.load, _build.SOURCES))
    ptxas = {n: ptxas_by_kernel(log) for n, log in _build.build_logs.items()}
    atomics = sass_atomics()
    bwd = bwd_build(ptxas["ms_deform_attn_bwd"]) if "ms_deform_attn_bwd" in ptxas else None
    res["bwd_build"] = bwd
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "built": sorted(_build.build_logs), "ptxas": ptxas, "sass_atomics": atomics,
          "ms_deform_attn_bwd": bwd})
    # the mma scatter sums on the tensor cores: no atomic in its own functions
    mma = {f: o for f, o in atomics["rows_scatter_add_tile"].items()
           if "rows_scatter_add_mma_kernel" in f}
    if not mma or any(mma.values()):
        raise AssertionError(f"rows_scatter_add_mma_kernel SASS atomics: {mma or 'not found'}")
    # the solver keeps a lane's columns in registers: no instance may spill
    # (read where this process built it: a library already built is not rebuilt)
    lap = {f: v for f, v in ptxas.get("hungarian_lap", {}).items()
           if "hungarian_lap_kernel" in f}
    if "hungarian_lap" in ptxas and (len(lap) != 3 or any(
            "0 bytes spill stores, 0 bytes spill loads" not in v for v in lap.values())):
        raise AssertionError(f"hungarian_lap_kernel instances (3 wanted, none spilling): {lap}")
    # the backward kernel: no instance may have a stack frame or spill
    if bwd is not None and not bwd["clean"]:
        raise AssertionError(f"ms_deform_attn_bwd_kernel instances ({BWD_INSTANCES} wanted, no "
                             f"stack frame, no spill): {ptxas['ms_deform_attn_bwd']}")


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


def _touched(v, l, shapes, pts):
    """The distinct (b, row, head) value rows that a valid corner of ``l``
    reads (found as the plain version finds its corners), and the number
    of valid corners."""
    import torch

    b, q, heads = l.shape[:3]
    s = v.shape[1]
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
    return torch.unique(torch.cat(keys)).numel(), corners


def _deform_bound(v, l, a, shapes=M_SHAPES, pts=M_POINTS):
    """The least time for this run's data: loc, att and the output once, and
    of the value only the rows that a valid corner reads (``_touched``); an
    FMA a channel for each valid corner and each point's att."""
    rows, corners = _touched(v, l, shapes, pts)
    b, q, heads = l.shape[:3]
    d = v.shape[3]
    nbytes = (rows * d * v.element_size() + l.numel() * 4 + a.numel() * 4
              + b * q * heads * d * 4)
    flops = corners * 2 * d + a.numel() * 2 * d
    return bound(nbytes, flops)


def _bwd_bound(v, l, a, payload, shapes=M_SHAPES, pts=M_POINTS):
    """The backward kernel's least time for this run's data: the value rows
    that a valid corner reads (``_touched``), loc, att and g_out read once;
    grad_loc, grad_att and every entry's idx (4 B) and contrib (d channels
    of the payload) written once, 4 B Q H P entries; an FMA a channel for
    each valid corner's g.v and a product a channel for each entry's
    contribution."""
    import torch

    rows, corners = _touched(v, l, shapes, pts)
    b, q, heads = l.shape[:3]
    d = v.shape[3]
    entries = 4 * a.numel()
    nbytes = (rows * d * v.element_size() + 2 * (l.numel() + a.numel()) * 4
              + b * q * heads * d * 4
              + entries * (4 + d * torch.empty((), dtype=payload).element_size()))
    flops = corners * 2 * d + entries * d
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


def _levels(canvas_hw):
    """The sampling levels of a canvas, at M_SHAPES's strides (8, 16, 32:
    1080x1920 -> a 384x640 canvas -> 48x80, 24x40, 12x20)."""
    return tuple((canvas_hw[0] // s, canvas_hw[1] // s) for s in (IMG // h for h, _ in M_SHAPES))


def _rect_levels():
    """The sampling levels of each rect bucket at IMG."""
    from dfine_tpu_torch.infer.base import default_rect_buckets

    return [_levels(hw) for hw in default_rect_buckets((IMG, IMG))]


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
    # rect serving's non-square levels: those of every canonical bucket (B = 1)
    for shapes in _rect_levels():
        for dtype in (torch.float32, torch.bfloat16):
            v, l, a = _deform_inputs(dev, 1, HEAD_DIM, shapes, M_POINTS, dtype, seed=5)
            err = (ms_deform_attn_fwd(v, shapes, l, a, M_POINTS)
                   - ms_deform_attn_fwd_plain(v, shapes, l, a, M_POINTS)).abs().max().item()
            checks.append({"rect_levels": shapes, "value": str(dtype).split(".")[1],
                           "max_abs_err": err})
            max_err = max(max_err, err)
            if not err <= FWD_TOL:
                raise AssertionError(f"deform fwd at levels {shapes} {dtype}: max err {err}")
    # apps.test_batching's largest batch: B = 32, 300 queries, bf16 value
    v, l, a = _deform_inputs(dev, APPS_MAX_BATCH, HEAD_DIM, M_SHAPES, M_POINTS, torch.bfloat16,
                             seed=7, q=QUERIES)
    err = (ms_deform_attn_fwd(v, M_SHAPES, l, a, M_POINTS)
           - ms_deform_attn_fwd_plain(v, M_SHAPES, l, a, M_POINTS)).abs().max().item()
    checks.append({"batch": APPS_MAX_BATCH, "queries": QUERIES, "value": "bfloat16",
                   "max_abs_err": err})
    max_err = max(max_err, err)
    if not err <= FWD_TOL:
        raise AssertionError(f"deform fwd at B={APPS_MAX_BATCH}: max err {err} > {FWD_TOL}")
    del v, l, a
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


def _device_counts(fn, calls: int = 10) -> dict:
    """The device activities of ``calls`` calls of ``fn`` (torch.profiler),
    by name: {name: count in the window}. A profiler window in which CUPTI
    recorded no device activity at all is taken again, after a pause of half
    a second, up to six windows; empty if every window was dropped. (On the
    H100, windows of one short call late in a run were dropped six times in
    a row, while windows of many calls were kept.)"""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(6):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        counts = {e.key: e.count for e in _device_rows(prof)}
        if counts:
            break
        time.sleep(0.5)
    return counts


def _kernels_of(fn, calls: int = 10) -> list:
    """The device activities of one call of ``fn`` by name (``_device_counts``
    over ``calls``): each activity's count in the window over ``calls``; an
    empty list if every window was dropped."""
    return sorted(k for k, n in _device_counts(fn, calls).items()
                  for _ in range(round(n / calls)))


# each kernel wrapper's one kernel, as the device trace names it
KERNEL_SYMBOLS = {"ms_deform_attn_fwd": "ms_deform_attn_fwd_kernel",
                  "ms_deform_attn_bwd": "ms_deform_attn_bwd_kernel",
                  "rows_scatter_add": "rows_scatter_add_tile_kernel",
                  "rows_scatter_add_mxu": "rows_scatter_add_mma_kernel",
                  "rows_scatter_add_tiled": "rows_scatter_add_tile_sorted_kernel",
                  "hungarian_lap": "hungarian_lap_kernel"}


# the BatchNorm kernels (batch_norm_train): each launches once a BatchNorm
# and step, every BatchNorm of the model taking all four
BN_SYMBOLS = ("batch_norm_stats_kernel", "batch_norm_apply_kernel",
              "batch_norm_grad_sums_kernel", "batch_norm_grad_apply_kernel")


def replayed_bn_launches(fn, calls: int) -> dict:
    """Each BatchNorm kernel's launches in ``calls`` calls of ``fn``, counted
    by its symbol in the profiler's device trace (a replay runs them with no
    Python launch)."""
    counts = _device_counts(fn, calls)
    return {sym: sum(n for k, n in counts.items() if re.search(rf"\b{sym}\b", k))
            for sym in BN_SYMBOLS}


def n_batch_norms(model) -> int:
    from dfine_tpu_torch.models.layers import BatchNorm2d

    return sum(isinstance(m, BatchNorm2d) for m in model.modules())


def replayed_launches(fn, calls: int) -> dict:
    """Each kernel wrapper's launches in ``calls`` calls of ``fn``, counted
    by its kernel's symbol in the profiler's device trace (a replayed CUDA
    graph runs them with no Python launch, so the wrappers' counters miss
    it); all 0 if CUPTI dropped every window."""
    counts = _device_counts(fn, calls)
    return {w: sum(n for k, n in counts.items() if re.search(rf"\b{sym}\b", k))
            for w, sym in KERNEL_SYMBOLS.items()}


GRAPH_NODE_TYPES = ("KERNEL", "MEMSET", "MEMCPY", "HOST", "EMPTY", "GRAPH", "EVENT_RECORD",
                    "WAIT_EVENT", "MEM_ALLOC", "MEM_FREE", "CONDITIONAL", "BATCH_MEM_OP")


def graph_nodes(fn) -> list:
    """The work one call of ``fn`` puts on the stream, without the profiler:
    the call captured in a CUDA graph (after a warm-up call on a side
    stream, which builds the kernels), the graph kept uninstantiated and
    written out by ``debug_dump`` (cudaGraphDebugDotPrint) and read back. One (type, text)
    pair a node: its type the first node-type word of its label (KERNEL,
    MEMSET, ...; "?" where none), its text the label itself, which names
    the kernel. Allocations in the capture come from the graph's pool and
    add no node."""
    import tempfile

    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)  # the captured graph, not instantiated
    graph.enable_debug_mode()
    with torch.cuda.graph(graph):
        fn()
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "graph.dot")
        graph.debug_dump(path)
        with open(path) as f:
            dot = f.read()
    del graph
    nodes = dot_nodes(dot)
    if not nodes:
        raise AssertionError(f"graph_nodes: no node read from the dump: {dot[:800]!r}")
    return nodes


def dot_nodes(dot: str) -> list:
    """(type, label) of each node definition of a graph's DOT text (a line
    opening with a node's name and its attributes; edges open with a name
    and an arrow)."""
    starts = list(re.finditer(r'(?m)^\s*"graph_\d+_node_\d+"\s*\[', dot))
    nodes = []
    for k, m in enumerate(starts):
        text = dot[m.end(): starts[k + 1].start() if k + 1 < len(starts) else len(dot)]
        text = text.split("];")[0]
        kind = re.search(r"\b(" + "|".join(GRAPH_NODE_TYPES) + r")\b", text)
        nodes.append((kind.group(1) if kind else "?", text))
    return nodes


def one_kernel(fn, symbol: str, what: str) -> list:
    """Raise unless one call of ``fn`` is a single kernel node naming
    ``symbol`` (no fill, copy or second kernel beside it); returns the
    nodes' types and kernel symbols."""
    nodes = graph_nodes(fn)
    named = [(kind, (re.findall(r"_Z\w*" + symbol + r"\w*", text) or [text[:120]])[0])
             for kind, text in nodes]
    if len(nodes) != 1 or nodes[0][0] not in ("KERNEL", "?") or symbol not in nodes[0][1]:
        raise AssertionError(f"{what}: one call is {len(nodes)} graph nodes {named}, want its "
                             f"{symbol} kernel alone")
    return named


def _scatter(res, name, d=HEAD_DIM):
    """A row scatter-add kernel against its plain version at the train
    step's shapes (f32 payload for ``rows_scatter_add``, bf16 for ``_mxu``
    and ``_tiled``) at head dim ``d``, with the edge cases, the device
    activities of one call and the times of one backward. ``_tiled`` is also
    held bit for bit against the plain version on the CPU and against its
    own second run; for ``_mxu`` the script reports whether two runs are
    bit-equal. At ``HEAD_DIM`` also head dim 16 and the refusal of D = 8;
    the results go to ``res[name]``, at another ``d`` to
    ``res[f"{name}_d{d}"]``."""
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
        idx, contrib = inputs(hw, n, d)
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
        src = contrib.float().reshape(-1, d)
        parts = {
            **timings("", lambda: fn(idx, contrib, hw), 50),
            **timings("plain_", lambda: plain(idx, contrib, hw), 20),
            **timings("library_", lambda: torch.zeros(
                (r * (hw + 1), d), device=dev).index_add_(0, flat, src), 50)}
        level["ms"] = parts["ms"]
        for key_, val in parts.items():
            if key_.endswith("ms") and val is not None:
                tot[key_] = tot.get(key_, 0.0) + val
            elif not key_.endswith("ms"):
                tot[key_] = val
        tot["bytes"] += (idx.numel() * 4 + contrib.numel() * contrib.element_size()
                         + r * hw * d * 4)
        tot["flops"] += int((idx >= 0).sum().item()) * d
        levels.append(level)
    # one call is one kernel, at every D: no fill of the output, no sort or
    # gather around it (counted in a CUDA graph of the call, not by CUPTI,
    # which dropped whole profiler windows of D = 64 calls late in a run)
    activities = one_kernel(lambda: fn(idx, contrib, hw), "rows_scatter_add",
                            f"{name} at D = {d}")
    if d == HEAD_DIM:
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
    key = name if d == HEAD_DIM else f"{name}_d{d}"
    res[key] = {"max_abs_err": max_err, **{k: v for k, v in tot.items() if "ms" in k},
                "bound_ms": bound_ms, "bound_by": bound_by, "levels": levels,
                "atol": atol, "rtol": rtol, "activities_per_call": activities}
    emit({"phase": f"kernel_{key}",
          "shape": f"m@640 train step, B={TRAIN_BATCH}, Q={TRAIN_QUERIES}, D={d}, "
                   f"{'f32' if f32 else 'bf16'} payload: one backward = 3 calls, times summed",
          **res[key]})


def phase_scatter(res):
    _scatter(res, "rows_scatter_add")


def phase_scatter_mxu(res):
    _scatter(res, "rows_scatter_add_mxu")


def phase_scatter_tiled(res):
    _scatter(res, "rows_scatter_add_tiled")


def phase_core_backward(res):
    """``MSDeformAttnCore``'s backward (the backward kernel, then the
    default scatter a level) against autograd of the plain core, with its
    launches: one backward kernel and one scatter a level."""
    import torch

    from dfine_tpu_torch.ops.deform_attn import ms_deform_attn, ms_deform_attn_core
    from dfine_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    dev = torch.device(DEV)
    value, loc, att = _deform_inputs(dev, GRAD_BATCH, HEAD_DIM, M_SHAPES, M_POINTS,
                                     torch.float32, seed=5)
    g_out = torch.randn((GRAD_BATCH, QUERIES, HEADS * HEAD_DIM), device=dev)
    grads = []
    for fn in (ms_deform_attn, ms_deform_attn_core):
        v, l, a = (t.clone().requires_grad_() for t in (value, loc, att))
        out = fn(v, M_SHAPES, l, a, M_POINTS)
        reset_launch_counts()
        (out * g_out).sum().backward()
        sync()
        if fn is ms_deform_attn:
            counts = launch_counts()
        grads.append((v.grad, l.grad, a.grad))
    want = {"ms_deform_attn_fwd": 0, "ms_deform_attn_bwd": 1, "rows_scatter_add": len(M_SHAPES),
            "rows_scatter_add_mxu": 0, "rows_scatter_add_tiled": 0, "hungarian_lap": 0}
    if counts != want:
        raise AssertionError(f"core backward: launches {counts}, want {want}")
    errs = {}
    for name, ours, ref in zip(("value", "loc", "att"), *grads):
        scale = ref.abs().max().item() + 1e-9
        errs[name] = (ours - ref).abs().max().item() / scale
        if not errs[name] <= GRAD_REL_TOL:
            raise AssertionError(f"core backward grad {name}: rel err {errs[name]}")
    emit({"phase": "core_backward", "batch": GRAD_BATCH, "max_rel_err": errs,
          "tol_rel": GRAD_REL_TOL, "launches": counts})


def bwd_compared(ours, ref) -> dict:
    """Two outputs of the backward (grad_att, grad_loc, idx levels, contrib
    levels): the gradients' largest gaps, absolute and relative to the
    largest value of ``ref``; idx equal and contrib bit-equal (each level's
    block contiguous, compared through an integer view), or, where ``ref``
    has no value streams, ``ours`` has none either."""
    import torch

    out = {}
    for name, x, y in zip(("grad_att", "grad_loc"), ours[:2], ref[:2]):
        err = (x - y).abs().max().item()
        out[f"{name}_max_abs_err"] = err
        out[f"{name}_max_rel_err"] = err / max(y.abs().max().item(), 1e-30)
    out["max_abs_err"] = max(out["grad_att_max_abs_err"], out["grad_loc_max_abs_err"])
    if ref[2] is None:
        out["idx_equal"] = out["contrib_bit_equal"] = ours[2] is None and ours[3] is None
        return out
    bits = torch.int16 if ref[3][0].dtype == torch.bfloat16 else torch.int32
    out["idx_equal"] = all(torch.equal(x, y) for x, y in zip(ours[2], ref[2]))
    out["contrib_bit_equal"] = all(
        x.is_contiguous() and torch.equal(x.view(bits), y.view(bits))
        for x, y in zip(ours[3], ref[3]))
    out["entries"] = sum(x.numel() for x in ours[2])
    return out


def bwd_equal(check: dict) -> bool:
    """The verdict on ``bwd_compared``: idx equal, contrib bit-equal, and
    both gradients within GRAD_REL_TOL of their largest value."""
    return bool(check["idx_equal"] and check["contrib_bit_equal"]
                and check["grad_att_max_rel_err"] <= GRAD_REL_TOL
                and check["grad_loc_max_rel_err"] <= GRAD_REL_TOL)


def _bwd_against_plain(v, l, a, g, payload, shapes=M_SHAPES, pts=M_POINTS,
                       need_value=True) -> dict:
    """One call of the backward kernel against its plain version on the same
    tensors (``bwd_compared``): raise unless ``bwd_equal``. Returns the
    comparison."""
    from dfine_tpu_torch.ops.kernels.deform_attn import ms_deform_attn_bwd, ms_deform_attn_bwd_plain

    out = bwd_compared(ms_deform_attn_bwd(v, shapes, l, a, g, pts, payload, need_value),
                       ms_deform_attn_bwd_plain(v, shapes, l, a, g, pts, payload, need_value))
    if not bwd_equal(out):
        raise AssertionError(f"ms_deform_attn_bwd against its plain version: {out}")
    return out


def _bwd_cases_checks(dev) -> list:
    """The backward kernel against its plain version on the cases shared
    with the CPU tests (``tests/test_torch_port_deform_cases.py``: pixel
    edges, one level, head dims 16 and 64, four levels, off the map), bf16
    and f32 value, f32 and bf16 payload."""
    import torch

    _tests_on_path()
    from test_torch_port_deform_cases import DEFORM_CASES, deform_case

    checks = []
    for case in DEFORM_CASES:
        value, shapes, loc, att, pts = deform_case(case)
        rng = np.random.default_rng(13)
        g = torch.from_numpy(rng.normal(size=(loc.shape[0], loc.shape[1], HEADS
                                              * value.shape[-1])).astype(np.float32)).to(dev)
        l, a = torch.from_numpy(loc).to(dev), torch.from_numpy(att).to(dev)
        for dtype in (torch.float32, torch.bfloat16):
            v = torch.from_numpy(value).to(dev, dtype)
            for payload in (torch.float32, torch.bfloat16):
                checks.append({"case": case, "d": int(value.shape[-1]),
                               "value": str(dtype).split(".")[1],
                               "payload": str(payload).split(".")[1],
                               **_bwd_against_plain(v, l, a, g, payload, shapes, pts)})
    return checks


def phase_core_bwd_kernel(res):
    """The deformable-attention backward kernel (``csrc/ms_deform_attn_bwd.cu``)
    against its plain version (the closed form) at the gradient path's train
    shape: m@640, B = GRAD_BATCH, Q = QUERIES, 8 heads, locations in [-0.15,
    1.15], bf16 value, at D = 32 and 64 with the f32 and the bf16 payload,
    with the value frozen too, and on the shared cases; each timed beside
    its plain version in this call (device ms by the profiler, call ms by
    CUDA events), with the device activities (profiler) and the CUDA-graph
    nodes of one call of each (one kernel node for the kernel), and the
    bound of this run's data."""
    import torch

    from dfine_tpu_torch.ops.kernels.deform_attn import ms_deform_attn_bwd, ms_deform_attn_bwd_plain

    dev = torch.device(DEV)
    runs = {}
    for d in (HEAD_DIM, WIDE_HEAD_DIM):
        v, l, a = _deform_inputs(dev, GRAD_BATCH, d, M_SHAPES, M_POINTS, torch.bfloat16, seed=11,
                                 q=QUERIES)
        g = torch.from_numpy(np.random.default_rng(12).normal(
            size=(GRAD_BATCH, QUERIES, HEADS * d)).astype(np.float32)).to(dev)
        for payload in (torch.float32, torch.bfloat16):
            key = f"d{d}_{str(payload).split('.')[1]}_payload"
            check = _bwd_against_plain(v, l, a, g, payload)
            kernel = lambda: ms_deform_attn_bwd(v, M_SHAPES, l, a, g, M_POINTS, payload)  # noqa: E731
            plain = lambda: ms_deform_attn_bwd_plain(  # noqa: E731
                v, M_SHAPES, l, a, g, M_POINTS, payload)
            bound_ms, bound_by = _bwd_bound(v, l, a, payload)
            nodes = one_kernel(kernel, "ms_deform_attn_bwd", f"ms_deform_attn_bwd {key}")
            runs[key] = {**check, **timings("", kernel, 100), **timings("plain_", plain, 10),
                         "activities_per_call": len(_kernels_of(kernel)),
                         "plain_activities_per_call": len(_kernels_of(plain)),
                         "graph_nodes_per_call": len(nodes),
                         "plain_graph_nodes_per_call": len(graph_nodes(plain)),
                         "bound_ms": bound_ms, "bound_by": bound_by}
            runs[key]["share_of_bound"] = bound_ms / runs[key]["ms"]
            emit({"phase": "kernel_ms_deform_attn_bwd",
                  "shape": f"m@640 B={GRAD_BATCH} Q={QUERIES} D={d} bf16 value, "
                           f"{str(payload).split('.')[1]} payload", **runs[key]})
        frozen = _bwd_against_plain(v, l, a, g, torch.float32, need_value=False)
        same = [torch.equal(x, y) for x, y in zip(
            ms_deform_attn_bwd(v, M_SHAPES, l, a, g, M_POINTS, need_value=False)[:2],
            ms_deform_attn_bwd(v, M_SHAPES, l, a, g, M_POINTS)[:2])]
        runs[f"d{d}_value_frozen"] = {**frozen, "grads_bit_equal_to_full": all(same)}
        if not all(same):
            raise AssertionError(f"ms_deform_attn_bwd at D = {d}: the value-frozen call's "
                                 "gradients differ from the full call's")
        del v, l, a, g
    checks = _bwd_cases_checks(dev)
    res["deform_bwd"] = runs
    emit({"phase": "kernel_ms_deform_attn_bwd_checks", "tol_rel": GRAD_REL_TOL,
          "value_frozen": {k: v for k, v in runs.items() if "frozen" in k}, "cases": checks})


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
    if counts["ms_deform_attn_fwd"] != want or counts["ms_deform_attn_bwd"]:
        raise AssertionError(f"deform kernels launched {counts['ms_deform_attn_fwd']}x (want "
                             f"{want}) and the backward {counts['ms_deform_attn_bwd']}x (want 0)")


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
    want = {"ms_deform_attn_fwd": DECODER_LAYERS, "ms_deform_attn_bwd": DECODER_LAYERS,
            "rows_scatter_add": DECODER_LAYERS * len(M_SHAPES),
            "rows_scatter_add_mxu": 0, "rows_scatter_add_tiled": 0, "hungarian_lap": 0}
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


def _train_setup(compute_dtype, model=None, seg=False, optim=None, update_mask=None,
                 flat=False):
    """A TrainState (fp32 parameters) and its step: the m detect model, or
    ``model``; ``seg`` adds the ``masks`` loss (and builds the mask head);
    ``flat``: the flat optimizer (``build_optimizer(flat=True)``)."""
    from dfine_tpu_torch.models.dfine import build_model
    from dfine_tpu_torch.train.criterion import CriterionConfig
    from dfine_tpu_torch.train.optim import OptimConfig, build_optimizer
    from dfine_tpu_torch.train.train_step import TrainState, make_train_step

    if model is None:
        model = build_model(SIZE, NUM_CLASSES, seg, device=DEV)
    losses = ("vfl", "boxes", "local") + (("masks",) if seg else ())
    state = TrainState.create(model, build_optimizer(model, optim or OptimConfig(), flat=flat))
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
def timed_matching(events: list):
    """Keep, in ``events``, a pair of CUDA events recorded on the stream
    around each call of the train step's Hungarian solver
    (``matcher.hungarian``: one launch for all S x B problems and the cast
    of its answer) while the context is open; the events are read after
    the steps have synchronised, so the timing adds no sync."""
    import torch

    from dfine_tpu_torch import matcher

    orig = matcher.hungarian

    def hungarian(*args, **kw):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = orig(*args, **kw)
        end.record()
        events.append((start, end))
        return out

    matcher.hungarian = hungarian
    try:
        yield events
    finally:
        matcher.hungarian = orig


@contextlib.contextmanager
def plain_deform_bwd():
    """``MSDeformAttnCore``'s backward with the plain closed form in place
    of the backward kernel, on the card too: the step as it ran before the
    kernel, for measuring the two side by side only."""
    from dfine_tpu_torch.ops import deform_attn as tda
    from dfine_tpu_torch.ops.kernels.deform_attn import ms_deform_attn_bwd_plain

    kernel = tda.ms_deform_attn_bwd
    tda.ms_deform_attn_bwd = ms_deform_attn_bwd_plain
    try:
        yield
    finally:
        tda.ms_deform_attn_bwd = kernel


def bwd_turns(step_fn) -> dict:
    """One train step (``step_fn``, ending in a synchronise) profiled with
    the backward kernel and with the plain closed form (``plain_deform_bwd``),
    in turns (kernel, plain, plain, kernel): device busy ms, device
    activities and wall ms (the profiler's cost in it) of each."""
    out = {"kernel": [], "plain": []}
    for which in ("kernel", "plain", "plain", "kernel"):
        with plain_deform_bwd() if which == "plain" else contextlib.nullcontext():
            prof = profile_window(step_fn, 1, top=0)
        out[which].append({k: prof[k] for k in ("device_busy_ms", "device_activities_per_call",
                                                "wall_ms")})
    return out


def _graph_launches(step) -> dict:
    """The kernel launches the step's one captured graph holds (a replay
    runs them with no Python launch, so the wrappers' counters miss it)."""
    graphs = list(step.graphs.values())
    if len(graphs) != 1:
        raise AssertionError(f"{len(graphs)} captured train-step graphs, want 1")
    return graphs[0].launches


def phase_train(res):
    """The m detect train step on the card: bf16 autocast, fp32 parameters,
    the default (``"pallas"``) deformable-attention backward, each step a
    replay of the step's CUDA graph (the first warm-up call captures it):
    the graph holds the step's launches and a replay launches none from
    Python. Then the solver timed by CUDA events in eager steps, and the
    eager step with the backward kernel and with the plain closed form in
    turns."""
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
    want = {"ms_deform_attn_fwd": DECODER_LAYERS, "ms_deform_attn_bwd": DECODER_LAYERS,
            "rows_scatter_add": DECODER_LAYERS * len(M_SHAPES),
            "rows_scatter_add_mxu": 0, "rows_scatter_add_tiled": 0, "hungarian_lap": 1}
    times, per_step, metrics = [], [], []
    for _ in range(TRAIN_STEPS):
        reset_launch_counts()  # the main path of this slice: one replayed train step
        t = time.perf_counter()
        _, m = step(state, batch, gen)
        sync()
        times.append(time.perf_counter() - t)
        per_step.append(launch_counts())
        metrics.append({k: float(v) for k, v in m.items()})
    graph_launches = _graph_launches(step)
    # what TRAIN_STEPS more replays ran on the card, counted in its device trace
    total = replayed_launches(lambda: step(state, batch, gen), TRAIN_STEPS)
    res["train_counts"], res["train_graph_launches"] = total, graph_launches
    bn_total = replayed_bn_launches(lambda: step(state, batch, gen), TRAIN_STEPS)
    bn_want = {sym: n_batch_norms(state.model) * TRAIN_STEPS for sym in BN_SYMBOLS}
    res["train_bn_counts"] = bn_total
    solver_events = []  # CUDA events around the solver: eager steps (a replay runs no Python)
    with timed_matching(solver_events):
        for _ in range(SOLVER_EAGER_STEPS):
            step.eager(state, batch, gen)
    sync()
    solver = {"event_span_ms": sum(a.elapsed_time(b) for a, b in solver_events)
              / SOLVER_EAGER_STEPS, "calls_per_step": len(solver_events) / SOLVER_EAGER_STEPS}
    p50, p90 = percentiles(times)
    finite = all(np.isfinite(list(m_.values())).all() for m_ in metrics)
    grads_finite = all(torch.isfinite(p.grad).all().item() for p in state.model.parameters()
                       if p.grad is not None)
    moved = sum(int(not torch.equal(p0[k], v)) for k, v in state.model.named_parameters())
    ema_moved = sum(int(not torch.equal(e0[k], v)) for k, v in state.ema.named_parameters())
    emit({"phase": "train", "model": f"{SIZE} detect {IMG}px, bf16 autocast, fp32 params",
          "batch": TRAIN_BATCH, "gt_slots": TRAIN_G, "steps": TRAIN_STEPS,
          "step_p50_ms": p50, "step_p90_ms": p90, "metrics_first": metrics[0],
          "metrics_last": metrics[-1], "graph_launches": graph_launches,
          "python_launches_per_replay": per_step[0],
          "launches_in_profiled_replays": total, "bn_launches_in_profiled_replays": bn_total,
          "hungarian_device_per_step": solver,
          "params_moved": moved, "ema_moved": ema_moved,
          "n_params": len(p0), "losses_finite": finite, "grads_finite": grads_finite})
    prof = profile_window(lambda: (step(state, batch, gen), sync()), 1, top=12)
    res["train_in_situ"] = prof["ours"]
    solver["profiled_kernel_ms"] = in_situ_ms(res, "hungarian_lap_kernel")
    res["train_solver"] = solver
    emit({"phase": "train_profile", "what": "one train step",
          "hungarian_device_per_step": solver, **prof})
    res["train_bwd_turns"] = bwd_turns(lambda: (step.eager(state, batch, gen), sync()))
    res["train_bn_calls"] = _bn_calls(lambda: (step.eager(state, batch, gen), sync()), state.model)
    emit({"phase": "train_bwd_turns", "what": "one eager train step with the deform "
          "backward's kernel and with its plain closed form, in turns (profiler)",
          **res["train_bwd_turns"]})
    # the later phases patch Python functions into the step: they run it
    # eagerly, and the graph and its pool go
    step.graphs.clear()
    state.optimizer.zero_grad()
    torch.cuda.empty_cache()
    res["train_run"] = (state, step.eager, batch, gen)
    bad = [c for c in per_step if any(c.values())]
    replays_want = {k: n * TRAIN_STEPS for k, n in want.items()}
    if (bad or graph_launches != want or total != replays_want or bn_total != bn_want
            or not finite or not grads_finite):
        raise AssertionError(f"train: graph launches {graph_launches} (want {want}), in "
                             f"{TRAIN_STEPS} profiled replays {total} (want {replays_want}), "
                             f"BatchNorm kernels {bn_total} (want {bn_want}), "
                             f"Python launches in a replay {bad[:1]}, finite {finite}, grads "
                             f"finite {grads_finite}")
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


@contextlib.contextmanager
def captured_matching(calls: list):
    """Run the criterion's matching span (``matching_cost``, then
    ``solve_matchings``: the solver and the go union) under
    ``torch.cuda.set_sync_debug_mode("error")`` while the context is open,
    so that a synchronisation anywhere in it raises; keep copies of the
    costs and masks it solved in ``calls``."""
    import torch

    from dfine_tpu_torch.train import criterion as crit

    cost_fn, solve_fn = crit.matching_cost, crit.solve_matchings

    def strict(fn):
        def call(*args, **kw):
            prev = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                return fn(*args, **kw)
            finally:
                torch.cuda.set_sync_debug_mode(prev)
        return call

    def solve(costs, valid):
        out = strict(solve_fn)(costs, valid)
        calls.append((costs.detach().clone(), valid.clone()))
        return out

    crit.matching_cost, crit.solve_matchings = strict(cost_fn), solve
    try:
        yield calls
    finally:
        crit.matching_cost, crit.solve_matchings = cost_fn, solve_fn


def _scipy_path(costs, valid):
    """The port's matching before the device solver, as the yardstick of
    what the kernel replaces: the costs copied to the host, scipy's
    ``linear_sum_assignment`` on each (set, image) problem's valid rows,
    the answer copied back."""
    import torch
    from scipy.optimize import linear_sum_assignment

    c = costs.detach().float().cpu().numpy()
    v = valid.cpu().numpy()
    s, b, g, _ = c.shape
    out = np.full((s, b, g), -1, np.int64)
    for bi in range(b):
        rows = np.flatnonzero(v[bi])
        if rows.size:
            for si in range(s):
                r, col = linear_sum_assignment(c[si, bi][rows])
                out[si, bi, rows[r]] = col
    return torch.from_numpy(out).to(costs.device)


def _hungarian_probe():
    """``call(iters)`` launches ``hungarian_lap_probe_kernel``: one warp,
    ``iters`` dependent xor-butterfly argmins over (value, column, row), the
    argmin of one path step."""
    import ctypes

    import torch

    from dfine_tpu_torch.ops.kernels import _build

    fn = _build.load("hungarian_lap").hungarian_lap_probe
    fn.argtypes, fn.restype = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p], ctypes.c_int
    out = torch.empty(1, device=DEV)

    def call(iters):
        if fn(out.data_ptr(), iters, torch.cuda.current_stream().cuda_stream):
            raise RuntimeError("hungarian_lap_probe launch failed")
    return call


def _no_pending(costs, valid):
    """The step's costs with each valid row's first argmin moved to its own
    column (row i's at column i, 1 below its row's minimum): the row
    reduction assigns every row, and no path step is taken."""
    import torch

    g = costs.shape[-2]
    rows = torch.arange(g, device=costs.device)
    out = costs.clone()
    out[..., rows, rows] = costs.min(-1).values - 1.0
    return torch.where(valid[None, :, :, None], out, costs)


def _bn_calls(fn, model) -> list:
    """(shape, dtype, act) of every BatchNorm call in one call of ``fn``, in
    order."""
    from dfine_tpu_torch.models.layers import BatchNorm2d

    calls = []

    def hook(_, args):
        calls.append((tuple(args[0].shape), args[0].dtype, args[1] if len(args) > 1 else None))

    handles = [m.register_forward_pre_hook(hook) for m in model.modules()
               if isinstance(m, BatchNorm2d)]
    try:
        fn()
    finally:
        for h in handles:
            h.remove()
    return calls


def _bn_leaves(call, seed: int):
    """Seeded inputs of one BatchNorm call: (x, dy, weight, bias,
    running_mean, running_var, num_batches_tracked, act), x, weight and
    bias leaves that take gradients, x and dy NCHW-contiguous."""
    import torch

    shape, dtype, act = call
    g = torch.Generator(device=DEV).manual_seed(seed)
    x, dy = ((torch.randn(shape, generator=g, device=DEV) * scale + shift).to(dtype)
             for scale, shift in ((2.0, 0.5), (1.0, 0.0)))
    c = shape[1]
    w = torch.randn(c, generator=g, device=DEV) * 0.5 + 1
    b = torch.randn(c, generator=g, device=DEV) * 0.3
    stats = (torch.randn(c, generator=g, device=DEV), torch.rand(c, generator=g, device=DEV) + 0.5,
             torch.zeros((), dtype=torch.int64, device=DEV))
    return (x.requires_grad_(True), dy, w.requires_grad_(True), b.requires_grad_(True),
            *stats, act)


def bn_library(x, weight, bias, running_mean, running_var, num_batches_tracked, momentum, eps,
               act=None):
    """The library's yardstick for ``batch_norm_train``: the one call
    ``F.batch_norm`` makes (``torch._batch_norm_impl_index``: cuDNN or
    PyTorch's own kernel) on the activations' dtype with the f32 parameters,
    the running statistics updated from its saved mean and invstd (the
    biased variance, as flax keeps it), then the activation as an op."""
    import torch

    from dfine_tpu_torch.ops.kernels.batch_norm import _PLAIN_ACTS, update_running_stats

    y, mean, invstd, _, _ = torch._batch_norm_impl_index(
        x, weight, bias, None, None, True, 0.0, eps, torch.backends.cudnn.enabled)
    with torch.no_grad():
        update_running_stats(running_mean, running_var, num_batches_tracked, mean,
                             invstd.pow(-2) - eps, momentum)
    return _PLAIN_ACTS[act](y)


def _bn_pass(fn, leaves) -> list:
    """One forward and backward of ``fn`` (``batch_norm_train``, its plain
    version or ``bn_library``) a call: [(y, dx, grad_weight, grad_bias)]."""
    out = []
    for x, dy, w, b, rm, rv, nbt, act in leaves:
        x.grad = w.grad = b.grad = None
        y = fn(x, w, b, rm, rv, nbt, 0.1, 1e-5, act)
        y.backward(dy)
        out.append((y.detach(), x.grad, w.grad, b.grad))
    return out


def bn_hbm_bytes(calls, l2_bytes: int) -> int:
    """The bytes the four kernels must move through device memory for
    ``calls``, forward and backward: x read and y written, x and dy read
    and dx written, once each (10 bytes a bf16 element); and x (forward) or
    x and dy (backward) read a second time where they do not fit in the L2
    (16 bytes a bf16 element), as ``csrc/batch_norm_train.cu``'s bound."""
    total = 0
    for shape, dtype, _ in calls:
        size = math.prod(shape) * (2 if str(dtype) == "torch.bfloat16" else 4)
        total += 5 * size + size * (size >= l2_bytes) + 2 * size * (2 * size >= l2_bytes)
    return total


def bn_check(call, seed: int) -> dict:
    """The kernels against the plain chain on seeded inputs of one call's
    shape: z (no activation) against the chain's (the share equal, the
    share off by more than a rounding of the dtype plus a floor of 2^-16 of
    the largest), y against PyTorch's activation of the kernels' own z (the
    share equal), each gradient's distance from its f64 value over twice
    the chain's plus a floor of f32 rounding (over 1 fails), the running
    mean and variance against the chain's over f32 rounding (1e-5 relative
    plus 1e-5; over 1 fails), ``num_batches_tracked`` of both, and the
    launches of one call."""
    import torch
    import torch.nn.functional as F

    from dfine_tpu_torch.ops.kernels.batch_norm import (batch_norm_train, batch_norm_train_grads,
                                                        batch_norm_train_plain)

    leaves = _bn_leaves(call, seed)
    x, dy, w, b, rm, rv, nbt, act = leaves

    def own_stats():  # each run updates its own copy of the running statistics
        return (*leaves[:4], rm.clone(), rv.clone(), nbt.clone(), act)

    ours_leaves, plain_leaves = own_stats(), own_stats()
    launches = batch_norm_train.launches
    ours = _bn_pass(batch_norm_train, [ours_leaves])[0]
    launches = batch_norm_train.launches - launches
    plain = _bn_pass(batch_norm_train_plain, [plain_leaves])[0]
    z, z_ref = (_bn_pass(fn, [(*own_stats()[:-1], None)])[0][0]
                for fn in (batch_norm_train, batch_norm_train_plain))
    rel = 2.0 ** -7 if call[1] == torch.bfloat16 else 1e-5
    z32, zr32 = z.float(), z_ref.float()
    off = (z32 - zr32).abs() > rel * zr32.abs() + 2.0 ** -16 * zr32.abs().max()
    want = {None: z, "relu": F.relu(z), "silu": F.silu(z)}[act]
    x64, dy64 = x.detach().double(), dy.double()
    var, mean = torch.var_mean(x64, dim=(0, 2, 3), correction=0)
    invstd = 1 / torch.sqrt(var + 1e-5)
    truth = batch_norm_train_grads(x64, dy64, w.detach().double(), b.detach().double(), mean,
                                   invstd, act)
    xhat = (x64 - mean.view(1, -1, 1, 1)) * invstd.view(1, -1, 1, 1)
    floors = (truth[0].norm(), (dy64 * xhat).abs().sum((0, 2, 3)).norm(),
              dy64.abs().sum((0, 2, 3)).norm())
    grads = {name: float((o.double() - t).norm()
                         / (2 * (p.double() - t).norm() + 1e-6 * f))
             for name, o, p, t, f in zip(("dx", "grad_weight", "grad_bias"), ours[1:], plain[1:],
                                         truth, floors)}
    stats = {name: float(((o - p).abs() / (1e-5 + 1e-5 * p.abs())).max())
             for name, o, p in (("running_mean", ours_leaves[4], plain_leaves[4]),
                                ("running_var", ours_leaves[5], plain_leaves[5]))}
    return {"launches": launches, "z_equal_share": float((z == z_ref).float().mean()),
            "z_off_share": float(off.float().mean()),
            "y_act_equal_share": float((ours[0] == want).float().mean()), **grads, **stats,
            "num_batches_tracked": (int(ours_leaves[6]), int(plain_leaves[6]))}


def bn_check_fails(g: dict, dtype) -> bool:
    import torch

    return (g["launches"] != 4 or g["z_off_share"] > 0 or g["y_act_equal_share"] < 0.999
            or (dtype == torch.bfloat16 and g["z_equal_share"] < 0.99)
            or max(g["dx"], g["grad_weight"], g["grad_bias"]) > 1
            or max(g["running_mean"], g["running_var"]) > 1 or g["num_batches_tracked"] != (1, 1))


def _bn_in_situ_ms(prof_ours: dict) -> float:
    """The four kernels' device ms a step in a profile of one step."""
    return sum(v["ms_per_launch"] * v["count_per_call"] for k, v in prof_ours.items()
               if any(sym in k for sym in BN_SYMBOLS))


def phase_batch_norm(res):
    """The BatchNorm kernels at the train steps' own shapes: the m detect
    step (phase_train), the m det+seg step (phase_train_seg) and the l
    detect step at batch 8 (built here, bf16, its CUDA graph replayed);
    each call's shape, dtype and activation from one eager step; every
    distinct one of the three against the plain version (the replaced
    chain), forward, backward and running statistics. For each step's calls
    alone, in turns: the kernels, the library's one call (``bn_library``)
    and the replaced chain (profiler device ms, a step); in situ, the four
    kernels' device ms in a profiled replay of each step; the bound, the
    bytes that must cross memory (``bn_hbm_bytes``: 10 bytes a bf16 element
    where a pass's tensors fit in the L2, 16 above) at 3.35 TB/s."""
    import torch

    from dfine_tpu_torch.models.dfine import build_model
    from dfine_tpu_torch.ops.kernels.batch_norm import batch_norm_train, batch_norm_train_plain

    l2 = torch.cuda.get_device_properties(0).L2_cache_size
    gen = torch.Generator(device=DEV).manual_seed(0)
    steps = {"m_detect": (res["train_bn_calls"], _bn_in_situ_ms(res["train_in_situ"])),
             "m_det_seg": (res["train_seg_bn_calls"], _bn_in_situ_ms(res["train_seg_in_situ"]))}
    state_l, step_l = _train_setup(torch.bfloat16, model=build_model(L_SIZE, NUM_CLASSES, False,
                                                                     device=DEV))
    batch_l = make_train_batch(TRAIN_BATCH, seed=11, device=DEV)
    for _ in range(TRAIN_WARMUP):
        step_l(state_l, batch_l, gen)
    sync()
    prof = profile_window(lambda: (step_l(state_l, batch_l, gen), sync()), 1, top=12)
    steps["l_detect"] = (_bn_calls(lambda: (step_l.eager(state_l, batch_l, gen), sync()),
                                   state_l.model), _bn_in_situ_ms(prof["ours"]))
    del state_l, step_l, batch_l
    torch.cuda.empty_cache()
    distinct = sorted({c for calls, _ in steps.values() for c in calls}, key=str)
    gaps, failed = {}, []
    for i, call in enumerate(distinct):
        g = gaps[str(call)] = bn_check(call, 1000 + i)
        if bn_check_fails(g, call[1]):
            failed.append((call, g))
    torch.cuda.empty_cache()
    fns = {"kernels": batch_norm_train, "library": bn_library, "chain": batch_norm_train_plain}
    out = {}
    for name, (calls, in_situ) in steps.items():
        leaves = [_bn_leaves(call, 2000 + i) for i, call in enumerate(calls)]
        turns = {k: [] for k in fns}
        for which in ("kernels", "library", "chain", "chain", "library", "kernels"):
            turns[which].append(device_ms(lambda: _bn_pass(fns[which], leaves), iters=3,
                                          warmup=1))
        del leaves
        torch.cuda.empty_cache()
        elements = sum(math.prod(shape) for shape, *_ in calls)
        hbm = bn_hbm_bytes(calls, l2)
        out[name] = {"calls_per_step": len(calls),
                     "acts": {str(a): sum(c[2] == a for c in calls) for a in {c[2] for c in calls}},
                     "elements_per_step": elements, "hbm_bytes_per_step": hbm,
                     "bound_ms": hbm / HBM_BYTES_PER_S * 1e3,
                     "bound_ms_16_bytes": 16 * elements / HBM_BYTES_PER_S * 1e3,
                     "in_situ_ms": in_situ, "alone_ms": turns["kernels"],
                     "library_ms": turns["library"], "chain_ms": turns["chain"]}
    worst = {k: max(g[k] for g in gaps.values())
             for k in ("z_off_share", "dx", "grad_weight", "grad_bias", "running_mean",
                       "running_var")}
    worst.update({k: min(g[k] for g in gaps.values())
                  for k in ("z_equal_share", "y_act_equal_share")})
    res["batch_norm"] = {"steps": out, "distinct_calls": len(gaps), "l2_bytes": l2,
                         "worst": worst}
    emit({"phase": "batch_norm", "what": f"the BatchNorms of the m detect, m det+seg and l "
          f"detect train steps at batch {TRAIN_BATCH}: kernels against the plain chain and the "
          "library's one call", **res["batch_norm"]})
    if failed:
        raise AssertionError(f"batch_norm: {failed[:4]}")


def phase_hungarian(res):
    """The exact Hungarian solver (``csrc/hungarian_lap.cu``) on the card:
    one more m train step (phase_train's state, batch and generator) with
    its matching span under sync debug mode "error" and its [S, B, G, Q]
    costs kept; the kernel held against its plain version on the card and
    on a CPU copy, assignment for assignment and path steps for path steps,
    on those costs, on random problems (pad rows, an image without a valid
    row, square, G = 1, Q = 40, 300 and 500; the columns-per-lane boundaries
    Q = 32, 320, 321, 512, 1024; square G = Q = 128 and 320; rows too many
    to stage in shared memory), on the step's costs with no pending row, on
    the one-to-many costs with the first round's queries blocked by +1e6
    (and ``match_one_to_many``'s three rounds, card against CPU), and on
    integer costs (ties: the same optimum, the assignments' equality
    reported); scipy's optimum on every case. On the step's costs: the
    kernel's time, its path steps (the slowest problem's and the total) and
    ms a step, the time of a launch with no pending row (the row reduction's
    share) and of an empty launch, one butterfly argmin's latency (the
    probe), the latency floor (the no-pending launch plus the slowest
    problem's steps at one butterfly each), the plain version's time on the
    card, the path it replaces (copy to the host and scipy's S x B solves),
    the bytes bound (the valid cost rows read once), one kernel a call by
    the graph count, and a CUDA graph of the solver replayed against eager.
    Then the whole step timed with the device solver and with the replaced
    path, in turns."""
    import torch

    from dfine_tpu_torch.matcher import match_one_to_many
    from dfine_tpu_torch.ops.hungarian import hungarian as plain
    from dfine_tpu_torch.ops.kernels import hungarian_lap

    _tests_on_path()
    from test_torch_port_hungarian_cases import (CASES, SIZE_CASES, assert_optimal,
                                                 hungarian_case, integer_case, size_case)

    state, step, batch, gen = res["train_run"]
    calls = []
    with captured_matching(calls):  # raises on a sync in the matching span
        step(state, batch, gen)
    sync()
    costs, valid = calls[0]
    s_, b_, g_, q_ = costs.shape
    dev = costs.device
    cases, failures, max_err = {}, [], 0

    def hold(tag, cost, valid, ties=False):
        nonlocal max_err
        lead = cost.shape[:-2]
        steps = torch.full(lead, -1, dtype=torch.int32, device=cost.device)
        card_steps = torch.empty_like(steps)
        cpu_steps = torch.empty(lead, dtype=torch.int32)
        got = hungarian_lap(cost, valid, steps=steps).cpu()
        on_card = plain(cost, valid, steps=card_steps).cpu()
        on_cpu = plain(cost.cpu(), valid.cpu(), steps=cpu_steps)
        equal = torch.equal(got, on_card) and torch.equal(got, on_cpu)
        same_steps = torch.equal(steps.cpu(), cpu_steps) and torch.equal(card_steps.cpu(),
                                                                         cpu_steps)
        c_np, v_np = cost.cpu().numpy(), valid.cpu().numpy()
        try:
            assert_optimal(c_np, v_np, got.numpy(), rtol=0 if ties else 1e-6)
            optimum = True
        except AssertionError:
            optimum = False
        cases[tag] = {"shape": list(cost.shape), "valid_rows": int(v_np.sum()),
                      "equal_to_plain": equal, "steps_equal_to_plain": same_steps,
                      "steps_slowest": int(cpu_steps.max()), "steps_total": int(cpu_steps.sum()),
                      "scipy_optimum": optimum}
        if ties:
            def total(cols):  # the assignment's cost over the valid rows, in float64
                picked = np.take_along_axis(c_np, np.clip(cols, 0, None)[..., None], -1)[..., 0]
                return np.where(v_np[None], picked, 0.0).astype(np.float64).sum()

            cases[tag]["same_total_as_plain"] = bool(total(got.numpy())
                                                     == total(on_cpu.numpy()))
            if not (optimum and cases[tag]["same_total_as_plain"]):
                failures.append(tag)
        else:
            max_err = max(max_err, int((got - on_cpu).abs().max()) if got.numel() else 0)
            if not (equal and same_steps and optimum):
                failures.append(tag)
        return cpu_steps

    step_steps = hold("train_step_costs", costs, valid)
    no_pending = _no_pending(costs, valid)
    if int(hold("train_step_costs_no_pending", no_pending, valid).sum()):
        failures.append("train_step_costs_no_pending: path steps taken")
    for case in CASES:
        cost, v = hungarian_case(case)
        hold(case, torch.from_numpy(cost).to(dev), torch.from_numpy(v).to(dev))
    for case in SIZE_CASES:
        cost, v = size_case(case)
        hold(case, torch.from_numpy(cost).to(dev), torch.from_numpy(v).to(dev))
    for g, q in ((12, 40), (40, 40), (100, 300)):
        cost, v = integer_case(g, q)
        hold(f"integer_g{g}_q{q}", torch.from_numpy(cost).to(dev), torch.from_numpy(v).to(dev),
             ties=True)
    first = hungarian_lap(costs, valid).long()
    blocked = torch.zeros((s_, b_, q_ + 1), dtype=torch.bool, device=dev)
    blocked.scatter_(2, torch.where(first >= 0, first, q_), True)
    round2 = costs + torch.where(blocked[..., None, :q_], 1e6, 0.0)
    hold("one_to_many_round2", round2, valid)
    o2m = match_one_to_many(costs, valid, 3)
    o2m_equal = torch.equal(o2m.cpu(), match_one_to_many(costs.cpu(), valid.cpu(), 3))
    if not o2m_equal:
        failures.append("match_one_to_many card vs CPU")

    # times on the step's own costs; the path steps; the floor's parts
    kernel = timings("", lambda: hungarian_lap(costs, valid), 50)
    no_pending_t = timings("no_pending_", lambda: hungarian_lap(no_pending, valid), 50)
    empty_t = timings("empty_launch_", _empty_deform_launch(), 200)
    probe = _hungarian_probe()
    probe_ms = (cuda_ms(lambda: probe(HUNGARIAN_PROBE_ITERS), iters=5)
                - cuda_ms(lambda: probe(0), iters=50))
    butterfly_ms = probe_ms / HUNGARIAN_PROBE_ITERS
    slowest, total_steps = int(step_steps.max()), int(step_steps.sum())
    floor = {"no_pending_ms": no_pending_t["no_pending_ms"],
             "empty_launch_ms": empty_t["empty_launch_ms"],
             "staging_and_reduction_ms": no_pending_t["no_pending_ms"]
             - empty_t["empty_launch_ms"],
             "butterfly_step_ms": butterfly_ms, "steps_slowest": slowest,
             "steps_total": total_steps,
             "ms_per_step": kernel["ms"] / max(slowest, 1),
             "latency_floor_ms": no_pending_t["no_pending_ms"] + slowest * butterfly_ms}
    plain_t = timings("plain_", lambda: plain(costs, valid), 3)
    for _ in range(2):
        _scipy_path(costs, valid)
    scipy_s = []
    for _ in range(10):
        sync()
        t = time.perf_counter()
        _scipy_path(costs, valid)
        sync()
        scipy_s.append(time.perf_counter() - t)
    n_valid = int(valid.sum())
    # the least work: each valid cost row read once, the mask read, the answer written
    nbytes = s_ * n_valid * q_ * 4 + b_ * g_ + s_ * b_ * g_ * 4
    bound_ms, bound_by = bound(nbytes, s_ * n_valid * q_)
    jmin = costs.argmin(-1).cpu().numpy()
    v_np = valid.cpu().numpy()
    pending = sum(int(v_np[bi].sum()) - len(set(jmin[si, bi][v_np[bi]].tolist()))
                  for si in range(s_) for bi in range(b_))
    nodes = one_kernel(lambda: hungarian_lap(costs, valid), "hungarian_lap", "hungarian_lap")

    # the whole train step with the device solver and with the path it
    # replaced (matcher.hungarian swapped for the host copy and scipy), in turns
    from dfine_tpu_torch import matcher

    device_solver, step_s = matcher.hungarian, {"device": [], "scipy_host": []}
    try:
        for _ in range(HUNGARIAN_STEP_TURNS):
            for path in ("device", "scipy_host", "scipy_host", "device"):
                matcher.hungarian = device_solver if path == "device" else _scipy_path
                sync()
                t = time.perf_counter()
                step(state, batch, gen)
                sync()
                step_s[path].append(time.perf_counter() - t)
    finally:
        matcher.hungarian = device_solver
    steps = {f"{k}_step_p{q}_ms": v for k, ts in step_s.items()
             for q, v in zip((50, 90), percentiles(ts))}

    # a CUDA graph of the solver, replayed on other costs copied into its input
    static = costs.clone()
    hungarian_lap(static, valid)
    sync()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        graphed = hungarian_lap(static, valid)
    static.copy_(round2)
    graph.replay()
    sync()
    graph_equal = torch.equal(graphed, hungarian_lap(round2, valid))
    if not graph_equal:
        failures.append("graph replay")
    del graph

    res["hungarian"] = {
        "max_abs_err": max_err, **kernel, **plain_t, **floor,
        "scipy_host_ms": percentiles(scipy_s)[0], "bound_ms": bound_ms, "bound_by": bound_by}
    emit({"phase": "hungarian", "shape": f"m@640 train step: S={s_} sets x B={b_} images, "
                                         f"G={g_} slots, Q={q_}",
          "valid_rows_per_set": n_valid, "pending_rows_after_reduction": pending,
          **res["hungarian"], "no_pending_timing": no_pending_t,
          "probe": {"iters": HUNGARIAN_PROBE_ITERS, "ms_less_empty": probe_ms},
          "latency_floor_is": "no-pending launch (empty launch + staging + row reduction + "
                              "claims) + slowest problem's steps x one butterfly argmin",
          "scipy_host_p90_ms": percentiles(scipy_s)[1],
          "train_step_in_turns": {**steps, "steps_each": 2 * HUNGARIAN_STEP_TURNS},
          "max_abs_err_is": "largest |column difference| to the plain version on the CPU",
          "graph_nodes_per_call": nodes, "graph_replay_equal": graph_equal,
          "one_to_many_card_equal_cpu": o2m_equal, "matching_span_sync_free": True,
          "cases": cases})
    if failures:
        raise AssertionError(f"hungarian: failed {failures}")


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
    """One eager train step each with the default, ``mxu`` and ``tiled`` backward,
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
                reset_launch_counts()  # this eager step: the chosen backward's kernel
                _, m = step.eager(state, batch, dn_noise=noise)
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
            if (counts[name] != want or counts["rows_scatter_add"]
                    or counts["ms_deform_attn_bwd"] != DECODER_LAYERS):
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


def _card_vs_cpu_step(res, phase, init, seg, n_seeds=1, overrides=()):
    """The parity steps at the first ``n_seeds`` batch seeds that select
    alike; every seed's readings are printed before a failure is raised.
    ``overrides``: the model's configuration, as ``build_model`` takes it."""
    from dfine_tpu_torch.models.dfine import build_model

    cpu_model = build_model(SIZE, NUM_CLASSES, seg, device="cpu", cfg_overrides=overrides)
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
            # eager on both sides: the hooks read each call of the forward
            _, m = step.eager(state, make_train_batch(PARITY_BATCH, seed, dev, masks=seg),
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
    and moved to the card before the step; each timed step a replay of the
    step's CUDA graph. Every loss term is read from an eager step before
    and after them, the mask-logit products' inputs from another."""
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
    want = {"ms_deform_attn_fwd": DECODER_LAYERS, "ms_deform_attn_bwd": DECODER_LAYERS,
            "rows_scatter_add": DECODER_LAYERS * len(M_SHAPES),
            "rows_scatter_add_mxu": 0, "rows_scatter_add_tiled": 0, "hungarian_lap": 1}
    times, per_step, terms = [], [], []
    torch.cuda.reset_peak_memory_stats()
    with captured_losses(terms):  # every set's terms: an eager step (a replay runs no Python)
        step.eager(state, batch, gen)
    for _ in range(TRAIN_STEPS):
        reset_launch_counts()  # the main path of this phase: one replayed det+seg step
        t = time.perf_counter()
        step(state, batch, gen)
        sync()
        times.append(time.perf_counter() - t)
        per_step.append(launch_counts())
    with captured_losses(terms):
        step.eager(state, batch, gen)
    graph_launches = _graph_launches(step)
    # what TRAIN_STEPS more replays ran on the card, counted in its device trace
    total = replayed_launches(lambda: step(state, batch, gen), TRAIN_STEPS)
    res["train_seg_counts"] = total
    bn_total = replayed_bn_launches(lambda: step(state, batch, gen), TRAIN_STEPS)
    bn_want = {sym: n_batch_norms(state.model) * TRAIN_STEPS for sym in BN_SYMBOLS}
    res["train_seg_bn_counts"] = bn_total
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
          "graph_launches": graph_launches, "python_launches_per_replay": per_step[0],
          "launches_in_profiled_replays": total, "bn_launches_in_profiled_replays": bn_total,
          "loss_terms_first": first,
          "loss_terms_last": last,
          "mask_terms_expected": len(mask_keys), "mask_terms_missing": missing,
          "terms_finite": finite, "params_moved": moved, "n_params": len(p0),
          "mask_params_moved": mask_moved, "n_mask_params": len(mask_part),
          "ema_moved": ema_moved, "ema_mask_moved": ema_mask_moved})
    with captured_mask_products([]) as calls:
        step.eager(state, batch, gen)
    sync()
    res["train_seg_bn_calls"] = _bn_calls(lambda: (step.eager(state, batch, gen), sync()),
                                          state.model)
    prof = profile_window(lambda: (step(state, batch, gen), sync()), 1, top=12)
    res["train_seg_in_situ"] = prof["ours"]
    products = _mask_product_ms(calls)
    emit({"phase": "train_seg_profile", "what": "one det+seg train step", **prof,
          "idle_share_at_p50": 1.0 - prof["device_busy_ms"] / p50,
          "mask_products": products})
    del state, batch
    torch.cuda.empty_cache()
    bad = [c for c in per_step if any(c.values())]
    replays_want = {k: n * TRAIN_STEPS for k, n in want.items()}
    if (bad or graph_launches != want or total != replays_want or bn_total != bn_want
            or missing or not finite):
        raise AssertionError(f"train_seg: graph launches {graph_launches} (want {want}), in "
                             f"{TRAIN_STEPS} profiled replays {total} (want {replays_want}), "
                             f"BatchNorm kernels {bn_total} (want {bn_want}), "
                             f"Python launches in a replay {bad[:1]}, mask terms missing "
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
    want = {"ms_deform_attn_fwd": L_DECODER_LAYERS, "ms_deform_attn_bwd": L_DECODER_LAYERS,
            "hungarian_lap": 1,
            "rows_scatter_add": L_DECODER_LAYERS * len(M_SHAPES),
            "rows_scatter_add_mxu": 0, "rows_scatter_add_tiled": 0}
    checks, failures, per_step, times = [], [], [], []
    total = {k: 0 for k in want}

    def fp32(x: float) -> float:
        return float(torch.tensor(x, dtype=torch.float32))

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
        lrs = {g["group"]: float(g["lr"]) for g in opt.adamw.param_groups}
        # written only when the optimizer steps, into fp32 tensors
        want_lr = {g: fp32(peaks["backbone" if g.startswith("backbone") else "rest"](
            opt.count - 1)) for g in lrs} if stepped else None
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


# ------------------------------------------------------- serving surface --


def _serve_frames():
    """720p BGR frames from default_rng, then one 1080x1920 and one
    1200x1600 frame (rect mode's 16:9 and 4:3 buckets)."""
    rng = np.random.default_rng(11)
    return _frames(4) + [rng.integers(0, 256, hw + (3,), dtype=np.uint8)
                         for hw in ((1080, 1920), (1200, 1600))]


def _serving_weights(res) -> str:
    """The serving phases' weights: ``build_model``'s seeded m det+seg
    weights, written as a reference .pth (every serving phase loads it), with
    the mask head's last layer scaled by 30 so that the mask logits leave 0
    and the served masks are not empty at the detections' threshold. Beside
    it, for the fp32 comparisons (deploy, int8), a model whose every weight
    is re-drawn from seed 1, so that no layer is trivial."""
    import tempfile

    import torch

    from dfine_tpu_torch.models.dfine import build_model

    if "serving_pth" not in res:
        res["tmp"] = tempfile.TemporaryDirectory()
        model = build_model(SIZE, NUM_CLASSES, True, device="cpu")
        with torch.no_grad():
            model.decoder.mask_head.layers[-1].weight.mul_(30.0)
        res["serving_pth"] = os.path.join(res["tmp"].name, "m_detseg.pth")
        torch.save({"model": model.state_dict()}, res["serving_pth"])
        parity = build_model(SIZE, NUM_CLASSES, True, device="cpu")
        randomize_(parity, seed=1)
        res["parity_model"] = parity
    return res["serving_pth"]


def _check_served(out, frame):
    oh, ow = frame.shape[:2]
    b = out["boxes"]
    if not (np.isfinite(b).all() and (b >= 0).all() and (b[:, [0, 2]] <= ow).all()
            and (b[:, [1, 3]] <= oh).all()):
        raise AssertionError("served boxes not finite or outside the frame")
    if out["masks"].shape != (len(out["scores"]), oh, ow):
        raise AssertionError(f"served masks shape {out['masks'].shape} for a {oh}x{ow} frame")


def _keep_threshold(model, frame) -> float:
    """The threshold that keeps 15-40 of ``frame``'s detections, in the
    widest gap between neighbouring scores there: bf16 scores tie in blocks,
    and a threshold on a tied score keeps the whole block, or not, as the
    last bit of a call moves."""
    model.conf_thresh = 0.0
    s = np.sort(model(frame)[0]["all_scores"])[::-1]
    k = 15 + int(np.argmax(s[14:39] - s[15:40]))
    return float((s[k - 1] + s[k]) / 2)


def _serve_timed(model, frames, n):
    """``n`` timed calls after a warm-up of every frame, each frame with its
    ``_keep_threshold`` (so that every backend postprocesses about the same
    number of masks); the deform launches counted around the timed calls."""
    from dfine_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    thresholds = [_keep_threshold(model, f) for f in frames]
    reset_launch_counts()
    times, kept = [], []
    for i in range(n):
        frame = frames[i % len(frames)]
        model.conf_thresh = thresholds[i % len(frames)]
        t = time.perf_counter()
        (out,) = model(frame)
        times.append(time.perf_counter() - t)
        kept.append(len(out["scores"]))
        _check_served(out, frame)
    launches = launch_counts()["ms_deform_attn_fwd"]
    p50, p90 = percentiles(times)
    return {"call_p50_ms": p50, "call_p90_ms": p90, "kept_per_frame": float(np.mean(kept)),
            "deform_launches": launches, "deform_launches_per_frame": launches / n}


def _served_deform_checks(model, frames):
    """The sampling kernel against its plain version on the inputs one
    served call of each frame gives it (rect mode: non-square levels), every
    launch of the call; these launches are made outside any counted run."""
    from dfine_tpu_torch.ops import deform_attn as tda
    from dfine_tpu_torch.ops.kernels.deform_attn import ms_deform_attn_fwd, ms_deform_attn_fwd_plain

    op, calls = tda.ms_deform_attn_op, []

    def record(value, flat, loc, att, pts):
        calls.append((value, tuple(zip(flat[::2], flat[1::2])), loc, att, tuple(pts)))
        return op(value, flat, loc, att, pts)

    tda.ms_deform_attn_op = record
    try:
        for f in frames:
            model(f)
    finally:
        tda.ms_deform_attn_op = op
    checks = []
    for value, shapes, loc, att, pts in calls:
        err = (ms_deform_attn_fwd(value, shapes, loc, att, pts)
               - ms_deform_attn_fwd_plain(value, shapes, loc, att, pts)).abs().max().item()
        checks.append({"levels": shapes, "value": str(value.dtype).split(".")[1],
                       "max_abs_err": err})
    return checks


def phase_serving_modes(res):
    """TorchModel in letterbox, rect (buckets made at load) and NMS mode."""
    from dfine_tpu_torch import TorchModel
    from dfine_tpu_torch.ops.preprocess import rect_bucket

    pth, frames = _serving_weights(res), _serve_frames()
    kw = dict(conf_thresh=0.5, half=True, enable_mask_head=True, device=DEV)
    out, failures = {}, []
    for mode, opts in (("letterbox", {"keep_ratio": True}), ("rect", {"rect": True}),
                       ("nms", {"use_nms": True})):
        t0 = time.perf_counter()
        model = TorchModel(SIZE, pth, NUM_CLASSES, IMG, IMG, **kw, **opts)
        out[mode] = {"load_seconds": time.perf_counter() - t0,
                     **_serve_timed(model, frames, MODE_FRAMES)}
        if out[mode]["deform_launches"] != DECODER_LAYERS * MODE_FRAMES:
            failures.append(f"{mode}: {out[mode]['deform_launches']} deform launches")
        res[f"mode_{mode}"] = model
    # a frame whose aspect is the canvas's: letterbox and rect see plain's input,
    # so their top-300 boxes (before any threshold) are plain's
    square = np.random.default_rng(12).integers(0, 256, (960, 960, 3), dtype=np.uint8)
    model = TorchModel(SIZE, pth, NUM_CLASSES, IMG, IMG, **kw)
    ref = model(square)[0]["all_boxes"]
    for mode in ("letterbox", "rect"):
        model.keep_ratio, model.rect = mode == "letterbox", mode == "rect"
        ours = model(square)[0]["all_boxes"]
        match = align_by_box(ref / 960.0, ours / 960.0)
        gap = float(np.abs(ours[match] - ref).max())
        out[mode]["square_frame_box_gap_px"] = gap
        if gap > 1.0:
            failures.append(f"{mode} boxes vs plain on a square frame: {gap} px")
    # the kernel against its plain version at the levels rect serving gave it
    # for the 1080x1920 and 1200x1600 frames
    checks = _served_deform_checks(res["mode_rect"], frames[-2:])
    out["rect"]["kernel_vs_plain"] = checks
    want = [_levels(rect_bucket(*f.shape[:2], (IMG, IMG))) for f in frames[-2:]]
    if sorted({c["levels"] for c in checks}) != sorted(want) or len(checks) != 2 * DECODER_LAYERS:
        failures.append(f"rect: deform levels {[c['levels'] for c in checks]}, want {want}")
    bad = [c for c in checks if not c["max_abs_err"] <= FWD_TOL]
    if bad:
        failures.append(f"rect: deform kernel vs plain beyond {FWD_TOL}: {bad}")
    # mask2poly (no cv2) on the first served masks that are not empty
    masks = [m for f in frames for m in res["mode_rect"](f)[0]["masks"] if m.any()][:5]
    t = time.perf_counter()
    polys = [TorchModel.mask2poly(m) for m in masks]
    poly_s = time.perf_counter() - t
    flat = [p for ps in polys for p in ps]
    if (masks and not flat) or any(len(p) < 3 or (p < 0).any() for p in flat):
        failures.append(f"mask2poly: {len(flat)} polygons from {len(masks)} masks")
    emit({"phase": "serving_modes", "model": f"{SIZE} det+seg bf16 {IMG}px, seed-1 .pth",
          "frames": f"{MODE_FRAMES} calls over 4 x 720p, 1080x1920, 1200x1600", **out,
          "mask2poly": {"masks": len(polys), "polygons": len(flat), "seconds": poly_s,
                        "points": [len(p) for p in flat][:10]}})
    res["serving_modes_counts"] = {m: out[m]["deform_launches"] for m in out}
    if failures:
        raise AssertionError("; ".join(failures))


def _card_vs_cpu(cpu, gpu, x, atol, tag, min_matched=MIN_MATCHED):
    """phase_model's rule on one input: queries matched 1:1 by box within
    BOX_ATOL (>= ``min_matched`` of them), logits and masks of the matched
    ones within ``atol`` (one number, or one for each of "pred_logits" and
    "pred_masks")."""
    atol = atol if isinstance(atol, dict) else {"pred_logits": atol, "pred_masks": atol}
    ours = _outputs(gpu, x)
    matched, errs = _matched_errors(_outputs(cpu, x), ours)
    finite = all(np.isfinite(v).all() for v in ours.values())
    if matched < min_matched or any(errs[k] > atol[k] for k in errs) or not finite:
        raise AssertionError(f"{tag}: matched {matched:.3f} (want {min_matched:.3f}), "
                             f"errors {errs} (atol {atol}), finite {finite}")
    return {"matched_frac": matched, "min_matched": min_matched,
            "logit_max_abs_err": errs["pred_logits"], "mask_max_abs_err": errs["pred_masks"],
            "atol": atol}


def _outputs(model, x):
    """One eval forward of ``model`` on ``x`` (moved to its device), as numpy."""
    import torch

    with torch.no_grad():
        return {k: v.float().cpu().numpy()
                for k, v in model(x.to(next(model.parameters()).device)).items()}


def _matched_errors(ref, ours):
    """The share of queries matched 1:1 by box within BOX_ATOL, and the
    largest logit and mask difference among them (inf if none matched)."""
    match = align_by_box(ref["pred_boxes"][0], ours["pred_boxes"][0])
    keep = np.abs(ours["pred_boxes"][0][match] - ref["pred_boxes"][0]).max(-1) <= BOX_ATOL
    errs = {k: float(np.abs(ours[k][0][match[keep]] - ref[k][0][keep]).max()) if keep.any()
            else float("inf") for k in ("pred_logits", "pred_masks")}
    return float(keep.mean()), errs


def _served_profile(model, frame):
    """One frame's call under the profiler (postprocess included: its cost
    follows the number kept), then the serving program alone (forward, top-k
    decode, mask cut; for AOTModel the graph replay) on that frame's input:
    its wall p50/p90 around a synchronize and its profile."""
    import torch

    model.conf_thresh = _keep_threshold(model, frame)
    prof = profile_window(lambda: model(frame), 5)
    with torch.inference_mode():
        x = model._prepare_inputs(frame)[0]

    def predict():
        with torch.inference_mode():
            model._predict(x)
        sync()

    for _ in range(3):
        predict()
    times = []
    for _ in range(MODE_FRAMES):
        t = time.perf_counter()
        predict()
        times.append(time.perf_counter() - t)
    p50, p90 = percentiles(times)
    pred = profile_window(predict, 5)
    return {"call_device_busy_ms": prof["device_busy_ms"],
            "call_device_activities": prof["device_activities_per_call"],
            "predict_p50_ms": p50, "predict_p90_ms": p90,
            "predict_device_busy_ms": pred["device_busy_ms"],
            "predict_device_activities": pred["device_activities_per_call"],
            "predict_idle_share_at_p50": 1.0 - pred["device_busy_ms"] / p50}


def phase_deploy(res):
    """The serving fold against the unfused model: fp32 on the card by
    phase_model's rule (``fold_for_serving``, "folded"); bf16 serving of the
    unfused model (a ``TorchModel`` that serves the model as built) and of
    the folded one (``TorchModel``), with device busy ms and activities a
    frame."""
    import torch

    from dfine_tpu_torch import TorchModel
    from dfine_tpu_torch.infer.base import load_weights
    from dfine_tpu_torch.infer.fuse import fold_for_serving
    from dfine_tpu_torch.models.dfine import build_model, set_compute_dtype

    class UnfusedModel(TorchModel):
        def _build(self, model_path):
            model = load_weights(build_model(self.model_name, self.n_outputs,
                                             self.enable_mask_head, device="cpu",
                                             cfg_overrides=self.cfg_overrides), model_path)
            self.model = set_compute_dtype(model, torch.bfloat16).to(self.device).eval()

    pth, frames = _serving_weights(res), _serve_frames()[:4]
    cpu = res["parity_model"]
    unfused = copy.deepcopy(cpu).to(DEV)
    x = torch.from_numpy(np.random.default_rng(2).uniform(size=(1, 3, IMG, IMG)).astype(np.float32))
    folded = fold_for_serving(copy.deepcopy(cpu), torch.float32).to(DEV)
    parity = {"folded": _card_vs_cpu(unfused, folded, x.to(DEV), DEPLOY_ATOL,
                                     "deploy fp32 folded vs unfused")}
    del unfused, folded
    out = {}
    for tag, cls in (("unfused", UnfusedModel), ("folded", TorchModel)):
        model = cls(SIZE, pth, NUM_CLASSES, IMG, IMG, conf_thresh=0.5, half=True,
                    enable_mask_head=True, device=DEV)
        out[tag] = {**_serve_timed(model, frames, MODE_FRAMES), **_served_profile(model, frames[0])}
        del model
    emit({"phase": "deploy", "parity_fp32": parity, "bf16_serving": out})
    res["deploy_counts"] = out["folded"]["deform_launches"]
    if out["folded"]["deform_launches"] != DECODER_LAYERS * MODE_FRAMES:
        raise AssertionError(f"deploy: {out['folded']['deform_launches']} deform launches")


def _moved_by_noise(cpu, x):
    """The CPU model's own reaction to its input perturbed by NOISE_REL (the
    size of the card's fp32 differences from the CPU): the share of
    queries whose box stays within BOX_ATOL, and the largest logit and mask
    change among them. An int8 (w8a8) or bf16-rounded (w8a16) model jumps
    where an activation crosses a rounding edge, so this bounds what two
    devices' fp32 differences may do to it."""
    import torch

    noise = torch.from_numpy(np.random.default_rng(9).standard_normal(x.shape).astype(np.float32))
    return _matched_errors(_outputs(cpu, x), _outputs(cpu, x * (1 + NOISE_REL * noise)))


def phase_int8(res):
    """w8a8 and w8a16 at fp32 compute, card against the same converted
    model on the CPU; bf16 serving of each; count_int8."""
    import torch

    from dfine_tpu_torch import Int8Model
    from dfine_tpu_torch.infer.int8 import convert_int8, count_int8, set_int8_mode
    from dfine_tpu_torch.models.layers import MultiHeadSelfAttention

    pth, frames = _serving_weights(res), _serve_frames()[:4]
    base = res["parity_model"]
    want = sum(isinstance(m, (torch.nn.Linear, MultiHeadSelfAttention)) for m in base.modules())
    cpu = convert_int8(copy.deepcopy(base))
    gpu = copy.deepcopy(cpu).to(DEV)
    x = torch.from_numpy(np.random.default_rng(2).uniform(size=(1, 3, IMG, IMG)).astype(np.float32))
    out, failures = {"quantized_layers": count_int8(cpu), "conversion_layers": want}, []
    if count_int8(cpu)[0] != want:
        failures.append(f"count_int8 {count_int8(cpu)} vs {want} layers converted")
    try:
        for mode, other in (("w8a8", "w8a16"), ("w8a16", "w8a8")):
            set_int8_mode(mode)
            own_matched, moved = _moved_by_noise(cpu, x)
            parity = {"cpu_under_noise": {"noise_rel": NOISE_REL, "matched_frac": own_matched,
                                          "max_abs_change": moved}}
            limits = {k: max(MODEL_ATOL, 2 * v) for k, v in moved.items()}
            min_matched = min(MIN_MATCHED, own_matched - 0.03)
            try:
                parity.update(_card_vs_cpu(cpu, gpu, x, limits, f"int8 {mode} card vs cpu",
                                           min_matched))
            except AssertionError as e:
                failures.append(str(e))
            # the limits must fail the card in the other mode, by WRONG_MODE_MARGIN
            ref = _outputs(cpu, x)
            set_int8_mode(other)
            matched, errs = _matched_errors(ref, _outputs(gpu, x))
            set_int8_mode(mode)
            over = {"unmatched": (1 - matched) / (1 - min_matched),
                    **{k: errs[k] / limits[k] for k in limits}}
            parity["card_in_" + other] = {"matched_frac": matched, "max_abs_err": errs,
                                          "over_limit": over}
            if max(over.values()) < WRONG_MODE_MARGIN:
                failures.append(f"int8 {mode}: the card in {other} reads {over} of the limits")
            model = Int8Model(SIZE, pth, NUM_CLASSES, IMG, IMG, conf_thresh=0.5, half=True,
                              enable_mask_head=True, device=DEV)
            if count_int8(model.model)[0] != want:
                failures.append(f"{mode}: Int8Model has {count_int8(model.model)} int8 layers")
            out[mode] = {"parity_fp32": parity, "bf16_serving": {
                **_serve_timed(model, frames, MODE_FRAMES), **_served_profile(model, frames[0])}}
            if out[mode]["bf16_serving"]["deform_launches"] != DECODER_LAYERS * MODE_FRAMES:
                failures.append(f"{mode}: deform launches {out[mode]['bf16_serving']}")
            del model
    finally:
        set_int8_mode("w8a16")
    emit({"phase": "int8", **out})
    res["int8_counts"] = {m: out[m]["bf16_serving"]["deform_launches"]
                          for m in ("w8a8", "w8a16") if m in out}
    if failures:
        raise AssertionError("; ".join(failures))


def _deform_in_profile(fn) -> int:
    return sum("ms_deform_attn_fwd_kernel" in n for n in _kernels_of(fn))


def phase_aot_graph(res):
    """AOTModel (one CUDA graph per bucket, one shared pool), plain and
    rect: the graph's outputs against the same model run eagerly on the
    same inputs, fp32; bf16 serving times, the deform launches a frame as
    the profiler names them, device busy and idle share, pool bytes."""
    import torch

    from dfine_tpu_torch import AOTModel
    from dfine_tpu_torch.infer.aot_model import pool_bytes
    from dfine_tpu_torch.infer.torch_model import decode

    from dfine_tpu_torch import TorchModel

    pth, frames = _serving_weights(res), _serve_frames()
    out, failures = {}, []
    eager = TorchModel(SIZE, pth, NUM_CLASSES, IMG, IMG, conf_thresh=0.5, half=True,
                       enable_mask_head=True, device=DEV)
    out["eager"] = {**_serve_timed(eager, frames, MODE_FRAMES),
                    **_served_profile(eager, frames[0])}
    del eager
    for tag, half, rect in (("plain_fp32", False, False), ("rect_fp32", False, True),
                            ("plain", True, False), ("rect", True, True)):
        t0 = time.perf_counter()
        model = AOTModel(SIZE, pth, NUM_CLASSES, IMG, IMG, conf_thresh=0.5, half=half,
                         enable_mask_head=True, device=DEV, rect=rect)
        r = {"load_seconds": time.perf_counter() - t0, "programs": len(model._programs),
             "pool_bytes": pool_bytes(model.pool),
             "deform_launches_held": [p.deform_launches for p in model._programs.values()]}
        if not half:  # replay against eager, on each frame's own input
            worst = {}
            for f in frames[-3:]:
                with torch.inference_mode():
                    x = model._prepare_inputs(f)[0]
                    g, e = model._predict(x), decode(model.model, x, model.num_top_queries)
                for k in g:
                    worst[k] = max(worst.get(k, 0.0), float((g[k].float() - e[k].float()).abs().max()))
            r["replay_vs_eager_max_abs"] = worst
            if max(worst.values()) > GRAPH_ATOL:
                failures.append(f"{tag}: graph vs eager {worst} > {GRAPH_ATOL}")
        else:
            r.update(_serve_timed(model, frames, MODE_FRAMES))
            r.update(_served_profile(model, frames[0]))
            per_frame = _deform_in_profile(lambda: model(frames[0]))
            r.update({"deform_launches_per_frame_profiled": per_frame,
                      "call_idle_share_at_p50": 1.0 - r["call_device_busy_ms"] / r["call_p50_ms"]})
            if per_frame != DECODER_LAYERS:
                failures.append(f"{tag}: profiler saw {per_frame} deform launches a frame")
        out[tag] = r
        del model
        torch.cuda.empty_cache()
    emit({"phase": "aot_graph", "graph_atol": GRAPH_ATOL, **out})
    res["aot_counts"] = {t: out[t]["deform_launches_per_frame_profiled"] for t in ("plain", "rect")}
    if failures:
        raise AssertionError("; ".join(failures))


_EXPORTED_RUN = r"""
import json, sys, time
import numpy as np
import torch
import dfine_tpu_torch
from dfine_tpu_torch import ExportedModel
from dfine_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
art, dyn_art, inp, frames_path, img, conf = sys.argv[1:7]
t0 = time.perf_counter()
served = ExportedModel("m", None, 80, int(img), int(img), conf_thresh=float(conf), half=True,
                       enable_mask_head=True, artifact_path=art)
load_s = time.perf_counter() - t0
x = torch.from_numpy(np.load(inp)).cuda()
with torch.inference_mode():
    dec = served._predict(x)
np.savez(inp + ".out.npz", **{k: v.float().cpu().numpy() for k, v in dec.items() if k != "masks"})
frames = list(np.load(frames_path)["frames"])
reset_launch_counts()
kept = [len(served(f)[0]["scores"]) for f in frames]
launches = launch_counts()["ms_deform_attn_fwd"]
dyn = torch.export.load(dyn_art).module()
shapes = {}
with torch.inference_mode():
    for b in (1, 3):
        shapes[b] = list(dyn(x.expand(b, -1, -1, -1).contiguous())["boxes"].shape)
print(json.dumps({"load_seconds": load_s, "kept": kept, "deform_launches": launches,
                  "dynamic_batch_boxes": shapes}))
"""


def phase_export(res):
    """export_model (.pt2 of the bf16 serving program of TorchModel's
    model, npz, the graph manifest) and a dynamic-batch .pt2; a fresh
    process imports dfine_tpu_torch, loads them and serves; its program
    outputs held against TorchModel's model on the same input."""
    import torch

    from dfine_tpu_torch import TorchModel
    from dfine_tpu_torch.export import ServingProgram, export_model

    pth, frames = _serving_weights(res), _serve_frames()[:4]
    out_dir = os.path.join(res["tmp"].name, "export")
    t0 = time.perf_counter()
    arts = export_model(SIZE, pth, NUM_CLASSES, out_dir, input_size=(IMG, IMG), half=True,
                        enable_mask_head=True, device=DEV)
    export_s = time.perf_counter() - t0
    dyn = export_model(SIZE, pth, NUM_CLASSES, os.path.join(out_dir, "dyn"), (IMG, IMG),
                       half=True, enable_mask_head=True, formats=("exported",),
                       dynamic_batch=True, device=DEV)["exported"]
    inp = os.path.join(out_dir, "x.npy")
    x = np.random.default_rng(2).uniform(size=(1, 3, IMG, IMG)).astype(np.float32)
    np.save(inp, x)
    np.savez(os.path.join(out_dir, "frames.npz"), frames=np.stack(frames))
    conf = res["mode_letterbox"].conf_thresh if "mode_letterbox" in res else 0.5
    proc = subprocess.run([sys.executable, "-c", _EXPORTED_RUN, str(arts["exported"]), str(dyn),
                           inp, os.path.join(out_dir, "frames.npz"), str(IMG), str(conf)],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"fresh process failed: {proc.stderr[-3000:]}")
    fresh = json.loads(proc.stdout.strip().splitlines()[-1])
    eager = TorchModel(SIZE, pth, NUM_CLASSES, IMG, IMG, half=True, enable_mask_head=True,
                       device=DEV).model
    with torch.inference_mode():
        ref = {k: v.float().cpu().numpy()
               for k, v in ServingProgram(eager)(torch.from_numpy(x).to(DEV)).items()}
    del eager
    with np.load(inp + ".out.npz") as z:
        ours = {k: z[k] for k in z.files}
    match = align_by_box(ref["boxes"][0], ours["boxes"][0])
    box_gap = np.abs(ours["boxes"][0][match] - ref["boxes"][0]).max(-1)
    keep = box_gap <= BOX_ATOL
    score_err = float(np.abs(ours["scores"][0][match[keep]] - ref["scores"][0][keep]).max())
    emit({"phase": "export", "export_seconds": export_s, "artifacts": sorted(arts),
          "pt2_bytes": os.path.getsize(arts["exported"]),
          "aot_manifest": open(arts["aot"]).read().strip().splitlines(),
          "fresh_process": fresh, "vs_eager": {"matched_frac": float(keep.mean()),
                                               "score_max_abs_err": score_err,
                                               "score_atol": EXPORT_SCORE_ATOL}})
    res["export_counts"] = fresh["deform_launches"]
    if keep.mean() < MIN_MATCHED or score_err > EXPORT_SCORE_ATOL:
        raise AssertionError(f"exported vs eager: matched {keep.mean():.3f}, scores {score_err}")
    if fresh["deform_launches"] != DECODER_LAYERS * len(frames):
        raise AssertionError(f"exported: {fresh['deform_launches']} deform launches")
    if fresh["dynamic_batch_boxes"] != {"1": [1, 300, 4], "3": [3, 300, 4]}:
        raise AssertionError(f"dynamic batch: {fresh['dynamic_batch_boxes']}")


def write_segment_dataset(root: str, n: int, n_train: int, hw, seed: int, repeat: int = 1) -> str:
    """A YOLO segment dataset under ``root/data/dataset``: ``n`` PNG frames
    of ``hw`` (a smooth background), each with 2-8 filled shapes over
    TRAINER_CLASSES classes (class 0 ellipses, 1 and 2 random polygons of 3-7
    vertices) and their polygon labels; the first ``n_train`` frames in
    train.csv, each listed ``repeat`` times, the rest in val.csv. Returns the
    dataset's directory."""
    from dfine_tpu_torch.data.image_io import write_png
    from dfine_tpu_torch.data.labels import fill_poly

    ds = os.path.join(root, "data", "dataset")
    for sub in ("images", "labels"):
        os.makedirs(os.path.join(ds, sub), exist_ok=True)
    rng = np.random.default_rng(seed)
    h, w = hw
    base = (np.linspace(30, 110, w)[None, :, None] + np.linspace(0, 50, h)[:, None, None]
            + np.asarray([0, 10, 20])[None, None, :]).astype(np.uint8)
    colours = np.asarray([(230, 60, 60), (60, 220, 60), (70, 90, 240)], np.uint8)
    names = []
    for i in range(n):
        img, lines = base.copy(), []
        for _ in range(int(rng.integers(2, 9))):
            cls = int(rng.integers(0, TRAINER_CLASSES))
            cx, cy = rng.uniform(0.15, 0.85, 2)
            rx, ry = rng.uniform(0.04, 0.15, 2)
            if cls == 0:
                ang, rad = np.linspace(0, 2 * np.pi, 32, endpoint=False), np.ones(32)
            else:
                k = int(rng.integers(3, 8))
                ang, rad = np.sort(rng.uniform(0, 2 * np.pi, k)), rng.uniform(0.6, 1.0, k)
            pts = np.stack([cx + rx * rad * np.cos(ang), cy + ry * rad * np.sin(ang)], -1)
            mask = np.zeros((h, w), np.uint8)
            fill_poly(mask, np.round(pts * (w, h)).astype(np.int32))
            img[mask.astype(bool)] = colours[cls]
            lines.append(f"{cls} " + " ".join(f"{v:.6f}" for v in pts.reshape(-1)))
        name = f"frame{i:03d}.png"
        write_png(os.path.join(ds, "images", name), img)
        with open(os.path.join(ds, "labels", f"frame{i:03d}.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
        names.append(name)
    for split, part in (("train", names[:n_train] * repeat), ("val", names[n_train:])):
        with open(os.path.join(ds, f"{split}.csv"), "w") as f:
            f.write("".join(f"{x}\n" for x in part))
    return ds


@contextlib.contextmanager
def captured_trainer_calls(trainer, calls: dict):
    """Keep, in ``calls``, copies of the inputs of the first sampling-kernel
    call of the trainer's eval (``"deform"``) and of the first default
    value-gradient scatter of its steps (``"scatter"``); every call still goes
    on to its kernel."""
    from dfine_tpu_torch.ops import deform_attn as tda

    op, kernel, decode = tda.ms_deform_attn_op, tda.rows_scatter_add, trainer.decode
    in_eval = []

    def deform(value, flat, loc, att, pts):
        if in_eval and "deform" not in calls:
            calls["deform"] = (value.clone(), tuple(zip(flat[::2], flat[1::2])), loc.clone(),
                               att.clone(), tuple(pts))
        return op(value, flat, loc, att, pts)

    def scatter(idx, contrib, hw):
        if "scatter" not in calls:
            calls["scatter"] = (idx.clone(), contrib.clone(), hw)
        return kernel(idx, contrib, hw)

    def eval_decode(images, model=None):
        in_eval.append(True)
        try:
            return decode(images, model)
        finally:
            in_eval.pop()

    tda.ms_deform_attn_op = deform
    tda.rows_scatter_add = tda._SCATTERS["pallas"] = scatter
    trainer.decode = eval_decode
    try:
        yield calls
    finally:
        tda.ms_deform_attn_op = op
        tda.rows_scatter_add = tda._SCATTERS["pallas"] = kernel
        del trainer.decode


@contextlib.contextmanager
def captured_sweep(calls: dict):
    """While ``apps.test_batching``'s sweep runs, keep in ``calls["deform"]``
    copies of the inputs of the first sampling-kernel call of each batch size
    made outside a graph capture (a graph's first warm-up call), keyed by
    ``calls["key"]`` where set, else by the batch; and in ``calls["graph"]``
    the APPS_MAX_BATCH graph's program, the batch of its first replay and
    that replay's outputs. Every call still goes on to its kernel."""
    import torch

    from dfine_tpu_torch.apps import test_batching as batching_app
    from dfine_tpu_torch.ops import deform_attn as tda

    op, program = tda.ms_deform_attn_op, batching_app.GraphProgram
    calls["deform"] = {}

    def deform(value, flat, loc, att, pts):
        key = calls.get("key", value.shape[0])
        if not torch.cuda.is_current_stream_capturing() and key not in calls["deform"]:
            calls["deform"][key] = (value.clone(), tuple(zip(flat[::2], flat[1::2])),
                                    loc.clone(), att.clone(), tuple(pts))
        return op(value, flat, loc, att, pts)

    class Recorded(program):
        def __init__(self, fn, shape, device, pool):
            super().__init__(fn, shape, device, pool)
            self.fn = fn

        def __call__(self, images):
            out = super().__call__(images)  # clones of the static outputs
            if images.shape[0] == APPS_MAX_BATCH and "graph" not in calls:
                calls["graph"] = (self.fn, images.clone(), out)
            return out

    tda.ms_deform_attn_op, batching_app.GraphProgram = deform, Recorded
    try:
        yield calls
    finally:
        tda.ms_deform_attn_op, batching_app.GraphProgram = op, program


def _trainer_run(trainer) -> dict:
    """``trainer.train()`` with every launch count set to 0 just before and
    read just after, and the tracer's step counters; fails on a caught
    crash (the trainer logs it and still runs its final eval) and on counts
    other than DECODER_LAYERS sampling launches a step run from Python (an
    eager step, each of a capture's warm-up steps and the capture itself;
    a replay launches none) and an eval batch, 3 x DECODER_LAYERS scatters
    such a step, and a graph per capture holding one step's launches."""
    from dfine_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from dfine_tpu_torch.train.train_step import GRAPH_WARMUP
    from dfine_tpu_torch.utils import profiling

    bs = trainer.cfg.train.batch_size
    profiling.drain()
    reset_launch_counts()  # the main path of this phase: the trainer's whole run
    t0 = time.perf_counter()
    with profiling.tracing(True):
        final = trainer.train()
    sync()
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    tracer = profiling.drain()["counters"]
    if trainer.failure is not None:
        raise AssertionError(f"trainer: the run failed: {trainer.failure!r}")
    steps = len(trainer.timing["step_s"])
    captures, replays, eager = (tracer.get(f"train.{k}", 0)
                                for k in ("graph_captures", "graph_replays", "eager_steps"))
    python = eager + (GRAPH_WARMUP + 1) * captures  # steps whose kernels Python launched
    eval_batches = sum(-(-e["images"] // bs) for e in trainer.timing["eval"])
    one = {"ms_deform_attn_fwd": DECODER_LAYERS, "ms_deform_attn_bwd": DECODER_LAYERS,
           "rows_scatter_add": DECODER_LAYERS * len(M_SHAPES),
           "rows_scatter_add_mxu": 0, "rows_scatter_add_tiled": 0, "hungarian_lap": 1}
    want = {k: v * python for k, v in one.items()}
    want["ms_deform_attn_fwd"] += DECODER_LAYERS * eval_batches
    graphs = [g.launches for g in getattr(trainer.train_step, "graphs", {}).values()]
    if (counts != want or replays + eager != steps or any(g != one for g in graphs)
            or (trainer.device.type == "cuda" and not trainer.dp_enabled and not replays)):
        raise AssertionError(f"trainer: launches {counts}, want {want} ({steps} steps: "
                             f"{captures} captures, {replays} replays, {eager} eager; "
                             f"{eval_batches} eval batches); graphs hold {graphs}, want {one}")
    return {"seconds": seconds, "steps": steps, "eval_batches": eval_batches,
            "captures": captures, "replays": replays, "eager_steps": eager,
            "launches": counts, "final": final}


def _step_numbers(step_s, wait_s) -> dict:
    """p50/p90 of the step and of the loader's wait before it, the mean
    wait, and the step plus its wait (what an epoch pays a step), in ms."""
    if not step_s:
        return {"steps": 0}
    step50, step90 = percentiles(step_s)
    wait50, wait90 = percentiles(wait_s)
    return {"steps": len(step_s), "step_p50_ms": step50, "step_p90_ms": step90,
            "loader_wait_p50_ms": wait50, "loader_wait_p90_ms": wait90,
            "loader_wait_mean_ms": float(np.mean(wait_s) * 1e3),
            "step_plus_wait_mean_ms": float(np.mean(np.add(step_s, wait_s)) * 1e3)}


def _trainer_numbers(trainer) -> dict:
    """The host timings a trainer kept: step and loader wait a step, over
    all steps, over the steps that ended while the loader was still making
    the epoch's batches ("loader_busy"), and over the epoch's tail after it
    had made the last one; eval ms an image by part (the per-epoch evals);
    checkpoint writes."""
    tm = trainer.timing
    busy = tm["loader_busy"]
    split = {name: _step_numbers([s for s, b in zip(tm["step_s"], busy) if b == want],
                                 [w for w, b in zip(tm["loader_wait_s"], busy) if b == want])
             for name, want in (("loader_busy", True), ("epoch_tail", False))}
    epoch_evals = [e for e in tm["eval"] if not e.get("extended")]
    n_img = sum(e["images"] for e in epoch_evals)
    return {**_step_numbers(tm["step_s"], tm["loader_wait_s"]), **split,
            "step_ms": [s * 1e3 for s in tm["step_s"]],
            "loader_wait_ms": [s * 1e3 for s in tm["loader_wait_s"]],
            "loader_busy_by_step": busy,
            "eval_ms_per_image": {k: sum(e[f"{k}_s"] for e in epoch_evals) * 1e3 / n_img
                                  for k in ("load", "device", "tail")},
            "eval_images": n_img,
            "checkpoints": [{"tag": c["tag"], "seconds": c["seconds"], "mb": c["bytes"] / 2**20}
                            for c in tm["checkpoint"]]}


def _finite_metrics(d) -> bool:
    if isinstance(d, dict):
        return all(_finite_metrics(v) for v in d.values())
    return not isinstance(d, (int, float)) or math.isfinite(d)


def phase_trainer(res):
    """The trainer entry point on the card (``Trainer(cfg).train()``, the
    body of ``python -m dfine_tpu_torch.apps.train``): the repo's config.yaml
    through the port's reader, m det+seg at 640 px, batch 8, bf16, 2 epochs
    on a synthetic segment dataset (TRAINER_FRAMES PNG frames at 720x1280,
    mosaic on in epoch 0), then a fresh trainer resumed from ``last`` for a
    third epoch, then ``TorchModel`` serving ``best``, held against the
    trainer's own eval model under the same serving fold on the same input
    (and its gap to the unfused eval printed); one sampling call of the trainer's
    eval and one scatter call of its step held against their plain
    versions."""
    import tempfile

    import torch

    from dfine_tpu_torch import TorchModel
    from dfine_tpu_torch.config import load_config
    from dfine_tpu_torch.data.image_io import decoder_name, read_image
    from dfine_tpu_torch.infer.fuse import fold_for_serving
    from dfine_tpu_torch.ops.kernels import ms_deform_attn_fwd, ms_deform_attn_fwd_plain
    from dfine_tpu_torch.ops.kernels import scatter_rows as sr
    from dfine_tpu_torch.postprocess import postprocess_predictions
    from dfine_tpu_torch.train.trainer import Trainer
    from dfine_tpu_torch.utils.checkpoint import read_state

    tmp = tempfile.TemporaryDirectory()
    root, failures = tmp.name, []
    t0 = time.perf_counter()
    ds = write_segment_dataset(root, TRAINER_FRAMES, TRAINER_TRAIN_FRAMES, TRAINER_HW, seed=3,
                               repeat=TRAINER_REPEAT)
    data_s = time.perf_counter() - t0
    run_dir = os.path.join(root, "run")
    overrides = [f"train.root={root}", f"train.path_to_save={run_dir}", f"model_name={SIZE}",
                 "task=segment", f"train.img_size=[{IMG}, {IMG}]",
                 f"train.batch_size={TRAINER_BATCH}", f"train.epochs={TRAINER_EPOCHS}",
                 "train.mosaic_augs.mosaic_prob=0.5", "train.mosaic_augs.no_mosaic_epochs=1",
                 "train.dtype=bfloat16", "train.use_wandb=False", "train.pretrained_model_path=",
                 "train.label_to_name={0: ellipse, 1: polygon, 2: blob}"]
    config = os.path.join(os.path.dirname(os.path.abspath(__file__)), "config.yaml")
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(load_config(config, overrides), device=DEV)
    calls: dict = {}
    with captured_trainer_calls(trainer, calls):
        first = _trainer_run(trainer)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    files = sorted(os.listdir(run_dir))
    missing = [f for f in ("last.ckpt", "best.ckpt", "best.meta.json", "metrics.csv",
                           "extended_metrics.csv", "config.yaml") if f not in files]
    with open(os.path.join(run_dir, "metrics.csv"), newline="") as f:
        losses = [float(r["loss"]) for r in csv.DictReader(f)]
    finite = all(math.isfinite(v) for v in losses) and _finite_metrics(first["final"])
    last = read_state(os.path.join(run_dir, "last.ckpt"))
    first_best = trainer.best_metric
    if missing or not finite or len(losses) != TRAINER_EPOCHS:
        failures.append(f"first run: missing {missing}, finite {finite}, {len(losses)} epochs")

    # the captured kernel calls against their plain versions
    value, shapes, loc, att, pts = calls["deform"]
    deform_err = (ms_deform_attn_fwd(value, shapes, loc, att, pts)
                  - ms_deform_attn_fwd_plain(value, shapes, loc, att, pts)).abs().max().item()
    idx, contrib, hw = calls["scatter"]
    ours, plain = sr.rows_scatter_add(idx, contrib, hw), sr.rows_scatter_add_plain(idx, contrib, hw)
    scatter_err = (ours - plain).abs().max().item()
    scatter_ok = torch.allclose(ours, plain, atol=SCATTER_ATOL, rtol=SCATTER_RTOL)
    del ours, plain
    if not deform_err <= FWD_TOL or not scatter_ok:
        failures.append(f"captured calls vs plain: deform {deform_err} (atol {FWD_TOL}), "
                        f"scatter {scatter_err} (atol {SCATTER_ATOL}, rtol {SCATTER_RTOL})")
    del calls

    # a fresh trainer resumed from last for one more epoch
    resumed = Trainer(load_config(config, overrides + ["train.resume=True",
                                                       f"train.epochs={TRAINER_EPOCHS + 1}"]),
                      device=DEV)
    resumed.load_checkpoint("last")  # as its train() does first: the carried state
    carried = {"step": resumed.state.step, "optimizer_count": resumed.state.optimizer.count,
               "best_metric": resumed.best_metric}
    want_carried = {"step": last["step"], "optimizer_count": last["count"],
                    "best_metric": first_best}
    second = _trainer_run(resumed)
    end = read_state(os.path.join(run_dir, "last.ckpt"))
    steps_per_epoch = first["steps"] // TRAINER_EPOCHS
    if (carried != want_carried or last["step"] != first["steps"]
            or resumed.start_epoch != TRAINER_EPOCHS or second["steps"] != steps_per_epoch
            or end["step"] != first["steps"] + steps_per_epoch
            or not _finite_metrics(second["final"])):
        failures.append(f"resume: carried {carried}, want {want_carried}; start epoch "
                        f"{resumed.start_epoch}; steps {first['steps']} + {second['steps']}; "
                        f"last step {end['step']}")

    # TorchModel serving best, against the trainer's eval model under the
    # same serving fold, on the same input (fp32)
    frame = read_image(os.path.join(ds, "images", "frame%03d.png" % TRAINER_TRAIN_FRAMES))
    served = TorchModel(SIZE, os.path.join(run_dir, "best.ckpt"), TRAINER_CLASSES, IMG, IMG,
                        conf_thresh=0.0, half=False, enable_mask_head=True, device=DEV)
    ema = resumed.eval_model().state_dict()  # the final eval reloaded best
    same_weights = all(torch.equal(v, ema[k]) for k, v in served.model.state_dict().items())
    ours = served(frame[..., ::-1])[0]
    x, proc, orig, _ = served._prepare_inputs(frame[..., ::-1])
    resumed.dtype = torch.float32
    folded = fold_for_serving(copy.deepcopy(resumed.eval_model()), torch.float32)

    def gaps(model):
        ref = postprocess_predictions(resumed.decode(x, model), proc[0], orig, 0.0, False)[0]
        return {"scores": float(np.abs(ours["scores"] - ref["scores"]).max()),
                "boxes_px": float(np.abs(ours["boxes"] - ref["boxes"]).max()),
                "labels_equal": bool(np.array_equal(ours["labels"], ref["labels"])),
                "mask_pixels_differing": float((ours["masks"] != ref["masks"]).mean())}

    serve_gap, unfused_gap = gaps(folded), gaps(None)  # the second one printed only
    del folded
    if not (same_weights and serve_gap["scores"] <= SERVE_SCORE_ATOL
            and serve_gap["boxes_px"] <= SERVE_BOX_ATOL_PX and serve_gap["labels_equal"]
            and serve_gap["mask_pixels_differing"] <= SERVE_MASK_SHARE):
        failures.append(f"serving best: same weights {same_weights}, gaps {serve_gap}")
    emit({"phase": "trainer", "model": f"{SIZE} det+seg {IMG}px, bf16, batch {TRAINER_BATCH}",
          "dataset": f"{TRAINER_FRAMES} PNG frames {TRAINER_HW[0]}x{TRAINER_HW[1]}, "
                     f"{TRAINER_TRAIN_FRAMES} train listed {TRAINER_REPEAT}x, "
                     f"{TRAINER_CLASSES} classes",
          "dataset_write_seconds": data_s,
          "run_seconds": first["seconds"], "steps": first["steps"],
          "eval_batches": first["eval_batches"], "launches": first["launches"],
          **_trainer_numbers(trainer), "peak_memory_gb": peak_gb,
          "metrics_csv_loss": losses, "final_val": first["final"]["val"],
          "best_metric": first_best, "files": files,
          "resume": {"carried": carried, "start_epoch": resumed.start_epoch,
                     "seconds": second["seconds"], "steps": second["steps"],
                     "eval_batches": second["eval_batches"], "launches": second["launches"],
                     "last_step": end["step"],
                     **{k: v for k, v in _trainer_numbers(resumed).items()
                        if k in ("loader_busy", "epoch_tail", "step_ms", "loader_wait_ms",
                                 "loader_busy_by_step")}},
          "serving_best": {**serve_gap, "same_weights": same_weights,
                           "vs_unfused_eval_unaligned": unfused_gap,
                           "atol": {"scores": SERVE_SCORE_ATOL, "boxes_px": SERVE_BOX_ATOL_PX,
                                    "mask_share": SERVE_MASK_SHARE}},
          "captured_vs_plain": {"ms_deform_attn_fwd": {"levels": shapes, "max_abs_err": deform_err,
                                                       "value": str(value.dtype)},
                                "rows_scatter_add": {"hw": hw, "max_abs_err": scatter_err}},
          "image_decoder": decoder_name(), "plot_writer": trainer.plot_writer})
    res["trainer_counts"] = {k: first["launches"][k] + second["launches"][k]
                             for k in first["launches"]}
    del trainer, resumed, served
    torch.cuda.empty_cache()
    # the apps phase runs on this experiment directory and dataset, then removes them
    res["trainer_run"] = {"tmp": tmp, "root": root, "config": config, "overrides": overrides}
    if failures:
        raise AssertionError("trainer: " + "; ".join(failures))


@contextlib.contextmanager
def captured_step_calls(calls: dict):
    """Keep, in ``calls``, copies of the inputs of the first sampling-kernel
    call (``"deform"``) and of the first default value-gradient scatter
    (``"scatter"``) made while the context is open; every call still goes on
    to its kernel."""
    from dfine_tpu_torch.ops import deform_attn as tda

    op, kernel = tda.ms_deform_attn_op, tda.rows_scatter_add

    def deform(value, flat, loc, att, pts):
        if "deform" not in calls:
            calls["deform"] = (value.clone(), tuple(zip(flat[::2], flat[1::2])), loc.clone(),
                               att.clone(), tuple(pts))
        return op(value, flat, loc, att, pts)

    def scatter(idx, contrib, hw):
        if "scatter" not in calls:
            calls["scatter"] = (idx.clone(), contrib.clone(), hw)
        return kernel(idx, contrib, hw)

    tda.ms_deform_attn_op = deform
    tda.rows_scatter_add = tda._SCATTERS["pallas"] = scatter
    try:
        yield calls
    finally:
        tda.ms_deform_attn_op = op
        tda.rows_scatter_add = tda._SCATTERS["pallas"] = kernel


def calls_vs_plain(calls: dict) -> dict:
    """The captured sampling and scatter calls, each run again through its
    kernel and its plain version: max abs errors and whether each is within
    its tolerance (FWD_TOL; SCATTER_ATOL / SCATTER_RTOL)."""
    import torch

    from dfine_tpu_torch.ops.kernels import ms_deform_attn_fwd, ms_deform_attn_fwd_plain
    from dfine_tpu_torch.ops.kernels import scatter_rows as sr

    value, shapes, loc, att, pts = calls["deform"]
    deform_err = (ms_deform_attn_fwd(value, shapes, loc, att, pts)
                  - ms_deform_attn_fwd_plain(value, shapes, loc, att, pts)).abs().max().item()
    idx, contrib, hw = calls["scatter"]
    ours, plain = sr.rows_scatter_add(idx, contrib, hw), sr.rows_scatter_add_plain(idx, contrib, hw)
    return {"ms_deform_attn_fwd": {"max_abs_err": deform_err, "ok": deform_err <= FWD_TOL,
                                   "value": str(value.dtype), "batch": value.shape[0]},
            "rows_scatter_add": {"max_abs_err": (ours - plain).abs().max().item(),
                                 "ok": torch.allclose(ours, plain, atol=SCATTER_ATOL,
                                                      rtol=SCATTER_RTOL), "rows": idx.shape[0]}}


def _dp_step_counts() -> dict:
    """The launches of one det+seg train step."""
    return {"ms_deform_attn_fwd": DECODER_LAYERS, "ms_deform_attn_bwd": DECODER_LAYERS,
            "rows_scatter_add": DECODER_LAYERS * len(M_SHAPES),
            "rows_scatter_add_mxu": 0, "rows_scatter_add_tiled": 0, "hungarian_lap": 1}


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _dp_world1(res, failures) -> dict:
    """The m det+seg step (bf16, batch 8, SyncBN forced) through the DP
    program in a one-rank NCCL group, against the plain step from the same
    weights on the same batch and CDN noise: SyncBN's statistics without a
    group are the whole batch's by the same formula, and at world 1 every
    collective is an identity, so the loss must agree as two plain steps do
    (within 1e-6) and each parameter's gradient within the bf16 limit of
    phase_train_bwd_variants (VARIANT_GRAD_REL plus twice the larger of
    CONTROLS more plain steps; the one-element tensors and those nought to
    rounding printed, not held). Then DP_STEPS timed DP steps with the
    four-group optimizer and as many with the flat one
    (``build_optimizer(flat=True)``: its gradient buffer all-reduced in
    place), in turns, the launch counts set to 0 before each and read after,
    with each one's device busy ms a step, and as many plain steps (SyncBN
    off: what one process trains with)."""
    import torch

    from dfine_tpu_torch.models.layers import set_bn_axis
    from dfine_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from dfine_tpu_torch.parallel import dp as par
    from dfine_tpu_torch.train.criterion import CriterionConfig
    from dfine_tpu_torch.train.train_step import make_train_step

    base = {k: v.clone() for k, v in res["train_seg_init"].items()}
    batch = make_train_batch(TRAIN_BATCH, seed=7, device=DEV, masks=True)
    noise = _noise(TRAIN_BATCH, seed=3).to(DEV)
    controls = [f"control{i}" for i in range(CONTROLS)]
    runs = {}
    set_bn_axis("dp")
    try:
        for run in ["plain", *controls, "dp"]:
            state, step = _train_setup(torch.bfloat16, seg=True)
            state.model.load_state_dict(base)
            state.ema.load_state_dict(base)
            if run == "dp":
                backend = par.init_multihost(f"localhost:{_free_port()}", 1, 0, device=DEV)
                step = par.make_dp_train_step(make_train_step(
                    CriterionConfig(num_classes=NUM_CLASSES,
                                    losses=("vfl", "boxes", "local", "masks")),
                    compute_dtype=torch.bfloat16, axis_name="dp"))
            _, m = step(state, batch, dn_noise=noise)
            sync()
            runs[run] = (float(m["loss"]), _unclipped_grads(state, m))
        flat_state, _ = _train_setup(torch.bfloat16, seg=True, flat=True)
        flat_state.model.load_state_dict(base)
        flat_state.ema.load_state_dict(base)
        timed = {"group": (state, [], []), "flat": (flat_state, [], [])}
        gen = torch.Generator(device=DEV).manual_seed(0)
        for st, _, _ in timed.values():
            for _ in range(TRAIN_WARMUP):
                step(st, batch, gen)
        sync()
        finite = True
        for _ in range(DP_STEPS):
            for st, step_s, counts in timed.values():  # in turns: group, flat
                reset_launch_counts()  # the main path of this run: one DP step
                t = time.perf_counter()
                _, m = step(st, batch, gen)
                sync()
                step_s.append(time.perf_counter() - t)
                counts.append(launch_counts())
                finite &= bool(np.isfinite([float(v) for v in m.values()]).all())
        busy = {k: profile_window(lambda: (step(st, batch, gen), sync()), 2)["device_busy_ms"]
                for k, (st, _, _) in timed.items()}
        _, times, per_step = timed["group"]
        _, flat_times, flat_per_step = timed["flat"]
    finally:
        set_bn_axis(None)
        par.shutdown()
    del state, step, flat_state, timed
    state, step = _train_setup(torch.bfloat16, seg=True)
    for _ in range(TRAIN_WARMUP):
        step(state, batch, gen)
    sync()
    plain_times = []
    for _ in range(DP_STEPS):
        t = time.perf_counter()
        step(state, batch, gen)
        sync()
        plain_times.append(time.perf_counter() - t)
    del state, step
    loss0, g0 = runs["plain"]
    control = {k: max(rel_norms(g0, runs[c][1], [k])[k] for c in controls) for k in g0}
    rms_all = _rms_all(g0)
    exempt = {k for k, g in g0.items() if g.numel() == 1
              or float(g.norm()) / math.sqrt(g.numel()) < ROUNDING_SHARE * rms_all}
    rel = rel_norms(g0, runs["dp"][1], [k for k in g0 if k not in exempt])
    share = {k: r / (VARIANT_GRAD_REL["bf16"] + 2 * control[k]) for k, r in rel.items()}
    p50, p90 = percentiles(times)
    out = {"backend": backend, "loss": runs["dp"][0], "plain_loss": loss0,
           "control_losses_equal": all(runs[c][0] == loss0 for c in controls),
           "n_checked": len(rel), "n_exempt": len(exempt), "max_rel": max(rel.values()),
           "max_share_of_limit": max(share.values()), "worst_share": _worst(share, 3),
           "step_p50_ms": p50, "step_p90_ms": p90, "device_busy_ms": busy["group"],
           "flat_step_p50_ms": percentiles(flat_times)[0],
           "flat_step_p90_ms": percentiles(flat_times)[1], "flat_device_busy_ms": busy["flat"],
           "plain_step_p50_ms": percentiles(plain_times)[0],
           "plain_step_p90_ms": percentiles(plain_times)[1], "launches_per_step": per_step[0],
           "flat_launches_per_step": flat_per_step[0], "metrics_finite": finite}
    if backend != "nccl":
        failures.append(f"world 1: backend {backend}, want nccl")
    if abs(runs["dp"][0] - loss0) > 1e-6 * abs(loss0):
        failures.append(f"world 1: loss {runs['dp'][0]} vs the plain step's {loss0}")
    bad = {k: v for k, v in share.items() if not v <= 1.0}
    if bad:
        failures.append(f"world 1: {len(bad)} gradients beyond their limits: {_worst(bad)}")
    if any(c != _dp_step_counts() for c in per_step + flat_per_step) or not finite:
        failures.append(f"world 1: launches {per_step}, flat {flat_per_step}, finite {finite}")
    res["dp_world1_counts"] = per_step[0]
    return out


_DP_RANK = r"""
import sys, time
import torch

import chip_smoke as cs
from dfine_tpu_torch.models.dfine import build_model
from dfine_tpu_torch.models.layers import set_bn_axis
from dfine_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
from dfine_tpu_torch.parallel import dp as par
from dfine_tpu_torch.train.criterion import CriterionConfig
from dfine_tpu_torch.train.optim import OptimConfig, build_optimizer
from dfine_tpu_torch.train.train_step import TrainState, make_train_step
from dfine_tpu_torch.utils.checkpoint import state_dict_of

rank, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
backend = par.init_multihost(f"localhost:{port}", 2, rank, device=cs.DEV)  # both on card 0
model = build_model(cs.SIZE, cs.NUM_CLASSES, True, device=cs.DEV, cfg_overrides=cs.DP_OVERRIDES)
state = TrainState.create(model, build_optimizer(model, OptimConfig()))
step = par.make_dp_train_step(make_train_step(
    CriterionConfig(num_classes=cs.NUM_CLASSES, losses=cs.DP_LOSSES),
    compute_dtype=torch.float32, axis_name="dp"))
batch = par.shard_batch(cs.make_train_batch(cs.TRAIN_BATCH, seed=7, device=cs.DEV, masks=True))
set_bn_axis("dp")
calls = {}
with cs.captured_step_calls(calls):
    reset_launch_counts()  # the main path of this rank: one DP step
    _, m = step(state, batch)
    cs.sync()
    counts = launch_counts()
first = {"metrics": {k: float(v) for k, v in m.items()}, "state": state_dict_of(state),
         "counts": counts, "rows": batch["images"].shape[0]}
times, per_step = [], []
for _ in range(cs.DP_STEPS):
    reset_launch_counts()
    t = time.perf_counter()
    step(state, batch)
    cs.sync()
    times.append(time.perf_counter() - t)
    per_step.append(launch_counts())
del state
model = build_model(cs.SIZE, cs.NUM_CLASSES, True, device=cs.DEV, cfg_overrides=cs.DP_OVERRIDES)
flat_state = TrainState.create(model, build_optimizer(model, OptimConfig(), flat=True))
reset_launch_counts()  # the main path of this rank's flat run: one DP step
_, fm = step(flat_state, batch)
cs.sync()
flat = {"metrics": {k: float(v) for k, v in fm.items()}, "counts": launch_counts(),
        "model": {k: v.detach().cpu() for k, v in flat_state.model.state_dict().items()}}
torch.save({**first, "backend": backend, "step_s": times, "per_step": per_step,
            "vs_plain": cs.calls_vs_plain(calls), "flat": flat}, f"{out}/rank{rank}.pt")
par.shutdown()
print(f"RANK{rank}_OK")
"""


def _run_ranks(code: str, argv_of, timeout: int):
    """Two processes running ``code`` (``python -c``) from the checkout's
    root, rank r with ``argv_of(r)``; fails unless both exit 0. Returns
    their outputs and the seconds until both ended."""
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-c", code, *argv_of(r)], cwd=here,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    seconds = time.perf_counter() - t0
    bad = [(r, p.returncode, err[-3000:]) for r, (p, (_, err)) in enumerate(zip(procs, outs))
           if p.returncode != 0]
    if bad:
        raise AssertionError(f"ranks failed: {bad}")
    return outs, seconds


def _far_share(got: dict, ref: dict) -> tuple:
    """The parameters of ``got`` against ``ref`` (state dicts): the largest
    gap, and the share of parameter elements beyond DP_PARAM_RTOL /
    DP_PARAM_ATOL; the BatchNorm statistics' largest gap beyond rtol 1e-4,
    atol 1e-5, and whether their counters are equal."""
    import torch

    far, n_el, gap, stats_far, counters = 0, 0, 0.0, 0.0, True
    for k, v in got.items():
        r = ref[k].to(v.device)
        if k.endswith("num_batches_tracked"):
            counters &= torch.equal(v, r)
        elif k.endswith(("running_mean", "running_var")):
            stats_far = max(stats_far, float(((v - r).abs() - 1e-4 * r.abs() - 1e-5).max()))
        else:
            gap = max(gap, float((v - r).abs().max()))
            far += int((~torch.isclose(v, r, rtol=DP_PARAM_RTOL, atol=DP_PARAM_ATOL)).sum())
            n_el += v.numel()
    return gap, far / n_el, stats_far, counters


def _dp_gloo(res, failures) -> dict:
    """Two ranks sharing the card over gloo (the backend choice sees one
    UUID twice): the m det+seg DP step (fp32, SyncBN) on 2 x 4 rows of the
    8-row batch, against the single-process step on all 8 rows (SyncBN's
    formula over the whole batch) from the same weights; both ranks
    bit-equal after it; each rank's launches of its compared step and of
    DP_STEPS timed ones, and its first sampling and scatter calls against
    their plain versions. Then the same with the flat optimizer
    (``build_optimizer(flat=True)``): each rank's one DP step against the
    single-process flat step on the 8 rows, by the same rules."""
    import tempfile

    import torch

    from dfine_tpu_torch.models.dfine import build_model
    from dfine_tpu_torch.models.layers import set_bn_axis
    from dfine_tpu_torch.train.criterion import CriterionConfig
    from dfine_tpu_torch.train.optim import OptimConfig, build_optimizer
    from dfine_tpu_torch.train.train_step import TrainState, make_train_step

    with tempfile.TemporaryDirectory() as out:
        port = _free_port()
        _, seconds = _run_ranks(_DP_RANK, lambda r: (str(r), str(port), out), 900)
        ranks = [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
                 for r in range(2)]
    model = build_model(SIZE, NUM_CLASSES, True, device=DEV, cfg_overrides=DP_OVERRIDES)
    state = TrainState.create(model, build_optimizer(model, OptimConfig()))
    step = make_train_step(CriterionConfig(num_classes=NUM_CLASSES, losses=DP_LOSSES),
                           compute_dtype=torch.float32)
    set_bn_axis("dp")
    try:
        _, m = step(state, make_train_batch(TRAIN_BATCH, seed=7, device=DEV, masks=True))
    finally:
        set_bn_axis(None)
    sync()
    ref = {k: v.detach() for k, v in state.model.state_dict().items()}
    loss, gnorm = float(m["loss"]), float(m["grad_norm"])
    del state, model
    model = build_model(SIZE, NUM_CLASSES, True, device=DEV, cfg_overrides=DP_OVERRIDES)
    flat_state = TrainState.create(model, build_optimizer(model, OptimConfig(), flat=True))
    set_bn_axis("dp")
    try:
        _, fm = step(flat_state, make_train_batch(TRAIN_BATCH, seed=7, device=DEV, masks=True))
    finally:
        set_bn_axis(None)
    sync()
    flat_ref = {k: v.detach() for k, v in flat_state.model.state_dict().items()}
    flat_loss, flat_gnorm = float(fm["loss"]), float(fm["grad_norm"])
    del flat_state, model
    a, b = (r["state"] for r in ranks)
    bit_equal = all(torch.equal(v, b[part][k]) for part in ("model", "ema")
                    for k, v in a[part].items())
    out = {"backend": [r["backend"] for r in ranks], "seconds": seconds,
           "single_loss": loss, "single_grad_norm": gnorm, "ranks_bit_equal": bit_equal,
           "rows_per_rank": [r["rows"] for r in ranks]}
    for i, r in enumerate(ranks):
        gap, far, stats_far, counters = _far_share(r["state"]["model"], ref)
        p50, p90 = percentiles(r["step_s"])
        out[f"rank{i}"] = {"loss": r["metrics"]["loss"], "grad_norm": r["metrics"]["grad_norm"],
                           "param_max_gap": gap, "param_far_share": far,
                           "bn_stats_beyond_tol": stats_far, "counters_equal": counters,
                           "launches": r["counts"], "launches_per_timed_step": r["per_step"][0],
                           "step_p50_ms": p50, "step_p90_ms": p90, "vs_plain": r["vs_plain"]}
        if r["backend"] != "gloo":
            failures.append(f"gloo rank {i}: backend {r['backend']}")
        if not (abs(r["metrics"]["loss"] - loss) <= DP_LOSS_RTOL * abs(loss)
                and abs(r["metrics"]["grad_norm"] - gnorm) <= DP_GNORM_RTOL * abs(gnorm)):
            failures.append(f"gloo rank {i}: loss {r['metrics']['loss']} / grad norm "
                            f"{r['metrics']['grad_norm']} vs single {loss} / {gnorm}")
        if gap > 2 * DP_LR + 2e-6 or far > DP_FAR_SHARE or stats_far > 0 or not counters:
            failures.append(f"gloo rank {i}: parameters {out[f'rank{i}']}")
        if r["counts"] != _dp_step_counts() or any(c != _dp_step_counts() for c in r["per_step"]):
            failures.append(f"gloo rank {i}: launches {r['counts']}, {r['per_step']}")
        if not all(v["ok"] for v in r["vs_plain"].values()):
            failures.append(f"gloo rank {i}: kernels vs plain {r['vs_plain']}")
        f = r["flat"]
        gap, far, stats_far, counters = _far_share(f["model"], flat_ref)
        out[f"rank{i}_flat"] = {"loss": f["metrics"]["loss"],
                                "grad_norm": f["metrics"]["grad_norm"], "param_max_gap": gap,
                                "param_far_share": far, "bn_stats_beyond_tol": stats_far,
                                "counters_equal": counters, "launches": f["counts"]}
        if not (abs(f["metrics"]["loss"] - flat_loss) <= DP_LOSS_RTOL * abs(flat_loss)
                and abs(f["metrics"]["grad_norm"] - flat_gnorm) <= DP_GNORM_RTOL * abs(flat_gnorm)):
            failures.append(f"gloo rank {i} flat: loss {f['metrics']['loss']} / grad norm "
                            f"{f['metrics']['grad_norm']} vs single {flat_loss} / {flat_gnorm}")
        if gap > 2 * DP_LR + 2e-6 or far > DP_FAR_SHARE or stats_far > 0 or not counters:
            failures.append(f"gloo rank {i} flat: parameters {out[f'rank{i}_flat']}")
        if f["counts"] != _dp_step_counts():
            failures.append(f"gloo rank {i} flat: launches {f['counts']}")
    flat_equal = all(torch.equal(v, ranks[1]["flat"]["model"][k])
                     for k, v in ranks[0]["flat"]["model"].items())
    out.update(single_flat_loss=flat_loss, single_flat_grad_norm=flat_gnorm,
               flat_ranks_bit_equal=flat_equal)
    if not flat_equal:
        failures.append("gloo flat: the ranks' parameters or buffers differ")
    if not bit_equal:
        failures.append("gloo: the ranks' parameters or buffers differ")
    res["dp_gloo_counts"] = [r["counts"] for r in ranks]
    return out


_DP_TRAINER = r"""
import os, sys, time
import torch

import chip_smoke as cs
import dfine_tpu_torch.apps.train as app
from dfine_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
from dfine_tpu_torch.parallel import dp as par
from dfine_tpu_torch.train import trainer as tr

rank, out, run_dir = int(sys.argv[1]), sys.argv[2], os.path.realpath(sys.argv[3])
argv = sys.argv[4:] + [f"train.dp.multihost.process_id={rank}"]
writes, gathered, seen = [], [], {}


def audit(event, args):
    # every file this process opens for writing in the run directory
    if event == "open" and isinstance(args[0], str):
        flags = args[2] if isinstance(args[2], int) else 0
        if os.path.realpath(args[0]).startswith(run_dir) and (
                any(c in (args[1] or "") for c in "wax+")
                or flags & (os.O_WRONLY | os.O_RDWR | os.O_CREAT)):
            writes.append(args[0])


sys.addaudithook(audit)
save = torch.save  # writes through its own file writer, which the hook does not see


def counted_save(obj, f, *args, **kwargs):
    audit("open", (str(f), "wb", 0))
    return save(obj, f, *args, **kwargs)


torch.save = counted_save
gather = par.gather_objects
par.gather_objects = lambda local: gathered.append(gather(local)) or gathered[-1]


class Kept(tr.Trainer):
    def _train_epochs(self):
        super()._train_epochs()
        seen.update(world=self.world, dp=self.dp_enabled, sync_bn=self.sync_bn,
                    backend=par.backend(), step=self.state.step,
                    model={k: v.cpu() for k, v in self.state.model.state_dict().items()},
                    step_s=self.timing["step_s"])

    def train(self):
        seen["final"] = super().train()
        seen["evals"] = len(self.timing["eval"])  # the epochs' and the final one
        return seen["final"]


app.Trainer = Kept
reset_launch_counts()  # the main path of this rank: the whole run
t0 = time.perf_counter()
app.main(argv, device=None if cs.DEV == "cuda" else cs.DEV)  # the card, as a user runs it
cs.sync()
seen.update(seconds=time.perf_counter() - t0, counts=launch_counts(), writes=writes,
            ids=[sorted(i for i, _ in g) for g in gathered if g and isinstance(g[0], tuple)])
save(seen, f"{out}/rank{rank}.pt")
print(f"RANK{rank}_OK")
"""


def _dp_trainer(res, failures) -> dict:
    """``python -m dfine_tpu_torch.apps.train``'s main in two processes on
    the card with ``train.dp.multihost`` (each its own process_id; gloo),
    on the trainer phase's dataset with each train frame listed once, batch
    DP_TRAINER_BATCH, one epoch: both ranks' final parameters equal; every
    eval's gather holds each val frame once; the final val metrics equal a
    single-process ``Trainer.evaluate`` of the written ``last.ckpt`` (best
    is last after one epoch); rank 1 wrote no file; ``best`` serves through
    ``TorchModel``; each rank's launches."""
    import shutil
    import tempfile

    import torch

    from dfine_tpu_torch import TorchModel
    from dfine_tpu_torch.config import load_config
    from dfine_tpu_torch.data.image_io import read_image
    from dfine_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from dfine_tpu_torch.train.trainer import Trainer

    run = res["trainer_run"]
    root, config = run["root"], run["config"]
    ds = os.path.join(root, "data", "dataset")
    with open(os.path.join(ds, "train.csv")) as f:
        names = list(dict.fromkeys(f.read().split()))
    with open(os.path.join(ds, "train.csv"), "w") as f:  # each train frame once
        f.write("".join(f"{x}\n" for x in names))
    with open(os.path.join(ds, "val.csv")) as f:
        n_val = len(f.read().split())
    run_dir = os.path.join(root, "run_dp")
    base = [o for o in run["overrides"] if not o.startswith(("train.path_to_save=",
                                                              "train.batch_size=",
                                                              "train.epochs="))]
    base += [f"train.batch_size={DP_TRAINER_BATCH}", "train.epochs=1",
             f"train.eval_preds_path={run_dir}/previews"]
    port = _free_port()
    argv = [config, *base, f"train.path_to_save={run_dir}", "train.dp.enabled=True",
            "train.dp.n_devices=1", "train.dp.multihost.enabled=True",
            "train.dp.multihost.num_processes=2",
            f"train.dp.multihost.coordinator_address=localhost:{port}"]
    with tempfile.TemporaryDirectory() as out:
        outs, seconds = _run_ranks(_DP_TRAINER, lambda r: (str(r), out, run_dir, *argv), 900)
        ranks = [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
                 for r in range(2)]
    a, b = ranks
    equal = all(torch.equal(v, b["model"][k]) for k, v in a["model"].items())
    steps = len(a["step_s"])
    batches = -(-n_val // DP_TRAINER_BATCH)
    want = [{"ms_deform_attn_fwd": DECODER_LAYERS * (steps + a["evals"] * len(
                range(r, batches, 2))),
             "ms_deform_attn_bwd": DECODER_LAYERS * steps,
             "rows_scatter_add": DECODER_LAYERS * len(M_SHAPES) * steps,
             "rows_scatter_add_mxu": 0, "rows_scatter_add_tiled": 0, "hungarian_lap": steps}
            for r in range(2)]
    # a single-process eval of the written last.ckpt
    single_dir = os.path.join(root, "run_dp_single")
    os.makedirs(single_dir)
    shutil.copyfile(os.path.join(run_dir, "last.ckpt"), os.path.join(single_dir, "last.ckpt"))
    single = Trainer(load_config(config, base + [f"train.path_to_save={single_dir}"]),
                     device=DEV)
    single.load_checkpoint("last")
    ref = single.evaluate("val", extended=True)
    ref.pop("extended_metrics", None)
    got = a["final"]["val"]
    eval_gap = {k: abs(v - ref[k]) / max(abs(ref[k]), 1e-12) for k, v in got.items()
                if isinstance(v, float)}
    del single
    # best, served
    frame = read_image(os.path.join(ds, "images", "frame%03d.png" % TRAINER_TRAIN_FRAMES))
    served = TorchModel(SIZE, os.path.join(run_dir, "best.ckpt"), TRAINER_CLASSES, IMG, IMG,
                        conf_thresh=0.0, half=False, enable_mask_head=True, device=DEV)
    reset_launch_counts()
    pred = served(frame[..., ::-1])[0]
    sync()
    serve_counts = launch_counts()
    served_ok = bool(np.isfinite(pred["scores"]).all()) and len(pred["scores"]) > 0
    del served
    out = {"backend": [r["backend"] for r in ranks], "seconds": seconds, "steps": steps,
           "world": a["world"], "dp": a["dp"], "sync_bn": a["sync_bn"],
           "ranks_equal": equal, "eval_ids": a["ids"], "final_val": got,
           "eval_rel_gap_to_single": max(eval_gap.values()) if eval_gap else None,
           "rank1_writes": b["writes"], "launches": [r["counts"] for r in ranks],
           "served_best": {"kept": len(pred["scores"]), "finite": served_ok,
                           "launches": serve_counts},
           **{f"rank{i}_step_p50_ms": percentiles(r["step_s"])[0] for i, r in enumerate(ranks)},
           **{f"rank{i}_seconds": r["seconds"] for i, r in enumerate(ranks)}}
    if [r["backend"] for r in ranks] != ["gloo", "gloo"] or not (a["dp"] and a["world"] == 2):
        failures.append(f"trainer: backends {out['backend']}, dp {a['dp']}, world {a['world']}")
    if not equal or a["step"] != b["step"]:
        failures.append("trainer: the ranks' final parameters differ")
    if not a["ids"] or any(ids != list(range(n_val)) for r in ranks for ids in r["ids"]):
        failures.append(f"trainer: gathered eval ids {a['ids']} / {b['ids']}")
    if set(got) != set(ref) or not all(g <= 1e-6 for g in eval_gap.values()) or any(
            got[k] != ref[k] for k in got if not isinstance(got[k], float)):
        failures.append(f"trainer: final val {got} vs single-process eval of last {ref}")
    if b["writes"] or not a["writes"]:
        failures.append(f"trainer: writes rank 0 {len(a['writes'])}, rank 1 {b['writes']}")
    if [r["counts"] for r in ranks] != want:
        failures.append(f"trainer: launches {[r['counts'] for r in ranks]}, want {want}")
    if (not served_ok or serve_counts["ms_deform_attn_fwd"] != DECODER_LAYERS
            or serve_counts["ms_deform_attn_bwd"]):
        failures.append(f"trainer: serving best {out['served_best']}")
    res["dp_trainer_counts"] = [r["counts"] for r in ranks]
    return out


def phase_dp(res):
    """Data parallelism (``dfine_tpu_torch.parallel``) on the one card: the
    DP program at world 1 over NCCL, two gloo ranks sharing the card against
    the single-process step, and the trainer's entry point in two processes
    (see ``_dp_world1``, ``_dp_gloo``, ``_dp_trainer``). Two ranks on one
    card measure no scaling: the gloo runs are a correctness path."""
    import torch

    t0, failures = time.perf_counter(), []
    world1 = _dp_world1(res, failures)
    torch.cuda.empty_cache()
    gloo = _dp_gloo(res, failures)
    torch.cuda.empty_cache()
    trainer = _dp_trainer(res, failures)
    emit({"phase": "dp", "model": f"{SIZE} det+seg {IMG}px", "world1_nccl_bf16": world1,
          "gloo_2_ranks_fp32": gloo, "trainer_2_processes": trainer,
          "tolerances": {"loss_rtol": DP_LOSS_RTOL, "grad_norm_rtol": DP_GNORM_RTOL,
                         "param_rtol": DP_PARAM_RTOL, "param_atol": DP_PARAM_ATOL,
                         "param_max_gap": 2 * DP_LR + 2e-6, "param_far_share": DP_FAR_SHARE},
          "seconds": time.perf_counter() - t0})
    if failures:
        raise AssertionError("dp: " + "; ".join(failures))


def keep_threshold(scores, keep: int, spans=(), low=None):
    """A confidence threshold for ``scores``, one array a frame (any order;
    a frame may have none), among those that keep (score >= threshold)
    between ``low`` (``keep // 2`` by default) and ``keep`` detections in
    the busiest frame.
    ``spans``, one [N, 2] array a frame, are the (low, high) scores one
    detection gets from two backends (``paired_spans``); a threshold inside
    a span (low < threshold <= high) keeps the detection in one backend and
    drops it in the other. The threshold is the middle of the widest gap
    between consecutive distinct values of the scores and the spans' ends
    inside the fewest spans (none where such a gap exists), so that no
    score and no span end lies closer to it than half that gap (less the
    float32 rounding of the middle). Returns (threshold, gap, the nearest
    value below it, the nearest above, the spans it lies in), the
    threshold as a float32 strictly between the two. Raises ValueError
    where no threshold keeps that many (too few scores, or a tie across
    the window)."""
    low = keep // 2 if low is None else low
    frames = [np.sort(np.asarray(f, np.float32).ravel()) for f in scores]
    sp = np.concatenate([np.zeros((0, 2), np.float32),
                         *(np.asarray(x, np.float32).reshape(-1, 2) for x in spans)])
    distinct = np.unique(np.concatenate([np.zeros(0, np.float32), *frames, sp.ravel()]))
    lo, hi = distinct[:-1], distinct[1:]  # a threshold in (lo, hi] keeps the scores >= hi
    busiest = np.zeros(len(hi), int)
    for f in frames:
        busiest = np.maximum(busiest, len(f) - np.searchsorted(f, hi, side="left"))
    ok = (busiest >= low) & (busiest <= keep)
    if not ok.any():
        raise ValueError(f"no threshold keeps {low}-{keep} detections in the busiest "
                         f"frame ({len(distinct)} distinct scores in {len(frames)} frames)")
    # the spans over (lo, hi): low <= lo and high >= hi, i.e. high > lo
    inside = (np.searchsorted(np.sort(sp[:, 0]), lo, side="right")
              - np.searchsorted(np.sort(sp[:, 1]), lo, side="right"))
    fewest = inside[ok].min()
    gaps = np.where(ok & (inside == fewest), hi.astype(np.float64) - lo, -1.0)
    k = int(np.argmax(gaps))  # the widest, the lowest of equal ones
    threshold = np.float32((float(lo[k]) + float(hi[k])) / 2)
    if not lo[k] < threshold < hi[k]:
        raise ValueError(f"no float32 lies between the scores {lo[k]} and {hi[k]}")
    return float(threshold), float(gaps[k]), float(lo[k]), float(hi[k]), int(fewest)


def widened_threshold(scores, spans, windows):
    """``keep_threshold`` over each keep window (low, high) of ``windows`` in
    turn, until one holds a gap that no span straddles; where none does,
    the window whose threshold lies inside the fewest spans (the first of
    equal ones). Returns ``keep_threshold``'s tuple and the window used.
    Raises ValueError where no window has a threshold at all."""
    best = None
    for low, high in windows:
        try:
            got = keep_threshold(scores, high, spans, low=low)
        except ValueError:
            continue
        if best is None or got[4] < best[0][4]:
            best = (got, (low, high))
        if got[4] == 0:
            break
    if best is None:
        raise ValueError(f"no keep window of {windows} has a threshold")
    return best


def infer_threshold(scores, frames: int):
    """``apps.infer``'s threshold and source frames from the scores, one
    array a frame, that the backend it builds (eager ``TorchModel``, bf16)
    served on the val frames: ``keep_threshold``'s threshold keeping 1 to
    APPS_KEEP in the busiest frame, and the ``frames`` frames with the most
    detections at it (the first of equal ones). Returns (threshold, frame
    indices, detections a chosen frame at the threshold)."""
    conf = keep_threshold(scores, APPS_KEEP, low=1)[0]
    at = [int((np.asarray(f, np.float32) >= conf).sum()) for f in scores]
    chosen = sorted(range(len(at)), key=lambda i: -at[i])[:frames]
    return conf, chosen, [at[i] for i in chosen]


def straddling(ref, ours, conf: float):
    """One (ref boxes [K, 4], our boxes [K, 4], lowest score) a frame of the
    detections that two backends' (boxes [N, 4], scores [N]) of the same
    frames pair by box (``align_by_box``) with their two scores on two
    sides of ``conf``, the lowest score of those pairs (None where a frame
    has none)."""
    out = []
    for (rb, rs), (ob, os_) in zip(ref, ours):
        rb, ob = (np.asarray(b, np.float64).reshape(-1, 4) for b in (rb, ob))
        rs, os_ = (np.asarray(x, np.float32).ravel() for x in (rs, os_))
        cross = np.zeros(len(rs), bool)
        match = align_by_box(rb, ob) if len(rs) and len(os_) else np.full(len(rs), -1)
        paired = match >= 0
        cross[paired] = (rs[paired] >= conf) != (os_[match[paired]] >= conf)
        theirs = os_[match[cross]]
        low = float(min(rs[cross].min(), theirs.min())) if cross.any() else None
        out.append((rb[cross], ob[match[cross]], low))
    return out


class EitherWay:
    """A serving backend as ``apps.bench.test_model`` calls it, frame by
    frame (the frames of ``straddling``'s list, in order), answering at
    ``conf`` with each detection of a straddling pair taken as kept
    (``kept``) or as dropped, alike in both backends: where they are kept,
    the frame is served at its lowest straddling score (so that they are
    there; the masks binarise at that threshold, in both backends) and
    every other detection under ``conf`` dropped. A detection is one of the
    pair by its box (within BOX_L1 of the L1 distance: a frame served twice
    gives the same boxes)."""

    BOX_L1 = 1e-2
    PER_DETECTION = ("boxes", "scores", "labels", "masks")  # all_* hold every query

    def __init__(self, model, straddle, side: int, conf: float, kept: bool):
        self.model, self.straddle, self.side = model, straddle, side
        self.conf, self.kept, self.frame = conf, kept, 0

    def __call__(self, img):
        boxes_of_pairs, low = self.straddle[self.frame][self.side], self.straddle[self.frame][2]
        self.frame += 1
        self.model.conf_thresh = self.conf if low is None or not self.kept else min(self.conf, low)
        (det,) = self.model(img)
        boxes = np.asarray(det["boxes"], np.float64).reshape(-1, 4)
        pair = np.zeros(len(boxes), bool)
        if len(boxes) and len(boxes_of_pairs):
            dist = np.abs(boxes[:, None, :] - boxes_of_pairs[None, :, :]).sum(-1)
            pair = dist.min(1) <= self.BOX_L1
        keep = np.where(pair, self.kept, np.asarray(det["scores"]) >= self.conf)
        return [{k: (np.asarray(v)[keep] if k in self.PER_DETECTION else v)
                 for k, v in det.items()}]


def paired_spans(ref, ours):
    """One [N, 2] array a frame of the (low, high) scores that each
    detection gets from two backends: ``ref`` and ``ours`` hold one (boxes
    [N, 4], scores [N]) a frame, each backend's detections of the same
    frames; a ref detection paired with one of ours by box
    (``align_by_box``) spans the two scores, and a detection of either
    without a pair spans its own score alone."""
    out = []
    for (rb, rs), (ob, os_) in zip(ref, ours):
        rb, ob = (np.asarray(b, np.float64).reshape(-1, 4) for b in (rb, ob))
        rs, os_ = (np.asarray(x, np.float32).ravel() for x in (rs, os_))
        match = align_by_box(rb, ob) if len(rs) else np.zeros(0, int)
        alone = np.ones(len(os_), bool)
        alone[match[match >= 0]] = False
        theirs = np.where(match >= 0, os_[np.clip(match, 0, None)] if len(os_) else rs, rs)
        out.append(np.sort(np.concatenate([np.stack([rs, theirs], 1),
                                           np.stack([os_[alone], os_[alone]], 1)]), 1))
    return out


def threshold_drift(ref, ours, conf: float, window: float) -> dict:
    """How two backends' scores differ near the confidence threshold
    ``conf``: ``ref`` and ``ours`` hold one (boxes [N, 4], scores [N]) a
    frame, each backend's detections of the same frames served at
    ``conf - window`` or lower. Every ref detection of a frame is paired
    with one of ours by box (``align_by_box``); over the ref detections
    within ``window / 2`` of ``conf`` ("near"): the pairs' largest |score
    difference| ("drift") and box L1 distance, the pairs on two sides of
    ``conf`` ("crossings"), the near detections without a pair; and ref's
    score nearest to ``conf`` as its distance ("margin"): where the drift is
    under it, no detection of ref changes side."""
    out = {"near": 0, "drift": 0.0, "box_l1_max": 0.0, "crossings": 0, "unpaired": 0,
           "margin": float("inf")}
    for (rb, rs), (ob, os_) in zip(ref, ours):
        rb, ob = (np.asarray(b, np.float64).reshape(-1, 4) for b in (rb, ob))
        rs, os_ = (np.asarray(x, np.float64).ravel() for x in (rs, os_))
        if not rs.size:
            continue
        out["margin"] = min(out["margin"], float(np.abs(rs - conf).min()))
        near = np.abs(rs - conf) <= window / 2
        match = align_by_box(rb, ob)[near]
        paired = match >= 0
        out["near"] += int(near.sum())
        out["unpaired"] += int((~paired).sum())
        if paired.any():
            r_s, o_s = rs[near][paired], os_[match[paired]]
            out["drift"] = max(out["drift"], float(np.abs(o_s - r_s).max()))
            out["box_l1_max"] = max(out["box_l1_max"], float(
                np.abs(ob[match[paired]] - rb[near][paired]).sum(-1).max()))
            out["crossings"] += int(((r_s >= conf) != (o_s >= conf)).sum())
    return out


def val_decoded(trainer):
    """``trainer``'s own decode of each val frame (its eval path), with the
    frame's ground truth."""
    import torch

    ds = trainer.loader.dataset("val", mode="val")
    decoded = []
    for i in range(len(ds)):
        sample, gt = ds.load_for_eval(i)
        x = torch.from_numpy(sample["image"][None]).to(DEV).permute(0, 3, 1, 2)
        decoded.append((trainer.decode(x), gt))
    return decoded


def relabel_val(trainer, decoded, conf: float):
    """Write, as each val frame's labels, its detections in ``decoded``
    (``val_decoded``) at or above ``conf`` (a frame may keep none: its
    label file is empty), each as the largest polygon of its own mask (its
    box where the mask has none), so that the fp F1, which matches masks,
    is near 1 and int8 can lose some of it. Returns the rows written a
    frame."""
    from dfine_tpu_torch.infer.contours import contour_area, mask2poly
    from dfine_tpu_torch.postprocess import postprocess_predictions

    ds = trainer.loader.dataset("val", mode="val")
    kept = []
    for i, (dec, gt) in enumerate(decoded):
        (pred,) = postprocess_predictions(dec, trainer.img_size, [gt["orig_size"]], conf, False)
        h, w = gt["orig_size"]
        rows = []
        for (x1, y1, x2, y2), c, m in zip(pred["boxes"], pred["labels"], pred["masks"]):
            polys = mask2poly(m)
            poly = (max(polys, key=contour_area) if polys else
                    np.asarray([(x1, y1), (x2, y1), (x2, y2), (x1, y2)], np.float32))
            rows.append(f"{c} " + " ".join(f"{v:.6f}" for v in (poly / [w, h]).reshape(-1)))
        with open(ds._paths(i)[1], "w") as f:
            f.write("".join(r + "\n" for r in rows))
        kept.append(len(rows))
    if not sum(kept):
        raise AssertionError(f"relabel: nothing above {conf} in any val frame")
    return kept


@contextlib.contextmanager
def counted(launches: dict, name: str):
    """Every launch count set to 0 on entry; the counts on exit kept in
    ``launches[name]``."""
    from dfine_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    reset_launch_counts()
    try:
        yield
    finally:
        sync()
        launches[name] = launch_counts()


def _want_deform(counts: dict, n: int, name: str) -> None:
    """``counts`` holds n sampling launches and no backward, scatter or
    solver launch."""
    want = {"ms_deform_attn_fwd": n, "ms_deform_attn_bwd": 0, "rows_scatter_add": 0,
            "rows_scatter_add_mxu": 0, "rows_scatter_add_tiled": 0, "hungarian_lap": 0}
    if counts != want:
        raise AssertionError(f"{name}: launches {counts}, want {want}")


_INFER_RUN = r"""
import json, runpy, sys
from dfine_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
sys.argv = ["dfine_tpu_torch.apps.infer"] + sys.argv[1:]
reset_launch_counts()
runpy.run_module("dfine_tpu_torch.apps.infer", run_name="__main__", alter_sys=True)
print("LAUNCHES " + json.dumps(launch_counts()))
"""


def phase_apps(res):
    """The apps a user runs after training (``python -m dfine_tpu_torch.apps.
    <name>`` and ``etl.<name>``), each through its ``main`` on the trainer
    phase's experiment directory and dataset (train.csv cut to each train
    frame once), with the launch counts set to 0 before each and read after.
    First ``apps.export``; then the val frames are relabelled with ``best``'s
    own fp32 detections (``relabel_val``) at ``keep_threshold``'s threshold
    over their scores, outside every span of a detection's eager and
    ``.pt2`` scores on bench's frames where it can be, and
    ``train.conf_thresh`` set to it."""
    import shutil
    from pathlib import Path

    import torch

    from dfine_tpu_torch import ExportedModel, Int8Model, TorchModel
    from dfine_tpu_torch.apps import bench as bench_app
    from dfine_tpu_torch.apps import check_errors as check_app
    from dfine_tpu_torch.apps import export as export_app
    from dfine_tpu_torch.apps import quant as quant_app
    from dfine_tpu_torch.apps import test_batching as batching_app
    from dfine_tpu_torch.apps.common import experiment_dir, label_names, serving_kwargs
    from dfine_tpu_torch.config import cli_config, load_config
    from dfine_tpu_torch.data.image_io import decoder_name, read_bgr, write_png
    from dfine_tpu_torch.data.loader import Loader
    from dfine_tpu_torch.data.labels import parse_yolo_label_file, polygons_to_masks
    from dfine_tpu_torch.etl import coco_yolo, mask_tools, preprocess, split
    from dfine_tpu_torch.infer.fuse import fold_for_serving
    from dfine_tpu_torch.infer.int8 import Int8Linear, count_int8
    from dfine_tpu_torch.ops.kernels.deform_attn import ms_deform_attn_fwd, ms_deform_attn_fwd_plain
    from dfine_tpu_torch.train.trainer import Trainer

    run = res.pop("trainer_run")
    root, failures, launches, t_phase = run["root"], [], {}, time.perf_counter()
    try:
        ds = os.path.join(root, "data", "dataset")
        with open(os.path.join(ds, "train.csv")) as f:
            train_names = list(dict.fromkeys(f.read().split()))
        with open(os.path.join(ds, "train.csv"), "w") as f:
            f.write("".join(f"{n}\n" for n in train_names))
        with open(os.path.join(ds, "val.csv")) as f:
            val_names = f.read().split()
        # fp32 evals: best's own fp32 detections label the val frames, so
        # that quant's fp F1 is near 1
        overrides = run["overrides"] + ["train.num_workers=4", "train.dtype=float32"]
        tr = Trainer(load_config(run["config"], overrides), device=DEV)
        tr.load_checkpoint("best")
        base_argv = [run["config"]] + overrides
        run_dir = os.path.join(root, "run")
        t0 = time.perf_counter()
        with counted(launches, "export"):
            artifacts = export_app.main(base_argv, device=DEV)
        manifest = dict(line.split(": ", 1) for line in
                        open(artifacts["aot"]).read().splitlines())
        emit({"phase": "apps", "app": "export", "seconds": time.perf_counter() - t0,
              "artifacts": {k: str(os.path.relpath(v, run_dir)) for k, v in artifacts.items()},
              "pt2_mb": os.path.getsize(artifacts["exported"]) / 2**20, "aot_manifest": manifest,
              "launches": launches["export"]})
        if sorted(artifacts) != ["aot", "exported"] or manifest.get("deform_launches") != "4":
            failures.append(f"export: {sorted(artifacts)}, manifest {manifest}")

        # the relabel threshold: over best's own fp32 scores of the val
        # frames, in the widest gap that no detection's eager and .pt2 scores
        # straddle (bench compares the two), in the first keep window of
        # APPS_KEEP_WINDOWS that has one; each backend served at
        # APPS_DRIFT_WINDOW under the lowest threshold that keeps the widest
        # window's most in every frame, on bench's frames
        decoded = val_decoded(tr)
        ref_scores = [d["scores"][0].float().cpu().numpy() for d, _ in decoded]
        most = APPS_KEEP_WINDOWS[-1][1]
        floor = max((float(np.sort(f)[::-1][most]) for f in ref_scores if len(f) > most),
                    default=0.0)
        cfg = cli_config(base_argv)
        weights = str(experiment_dir(cfg) / "best.ckpt")
        bench_ds = Loader(Path(cfg.train.data_path), cfg.train, task=cfg.task).dataset(
            "val", mode="bench")
        lo = {**serving_kwargs(cfg, DEV), "conf_thresh": floor - APPS_DRIFT_WINDOW}

        def serve(model):
            out = []
            for i in range(len(bench_ds)):
                (det,) = model(read_bgr(bench_ds._paths(i)[0]))
                out.append((np.asarray(det["boxes"]), np.asarray(det["scores"])))
            return out
        backends = {"pt2": ExportedModel(cfg.model_name, weights,
                                         artifact_path=str(artifacts["exported"]), **lo),
                    "eager": TorchModel(cfg.model_name, weights, **lo)}
        served = {k: serve(m) for k, m in backends.items()}
        spans = paired_spans(served["eager"], served["pt2"])
        (conf, gap, below, above, contested), window = widened_threshold(
            ref_scores, spans, APPS_KEEP_WINDOWS)
        kept = relabel_val(tr, decoded, conf)
        tr.conf_thresh = conf
        # infer's source and threshold: from the eager backend's own scores,
        # the model infer serves, not from the fp32 ones under conf (on an
        # H100 every bf16 score of the frames kept most at conf once fell
        # under it, and infer wrote no crop)
        infer_conf, infer_frames, infer_dets = infer_threshold(
            [s for _, s in served["eager"]], APPS_INFER_FRAMES)
        test_dir = os.path.join(root, "data", "test")
        os.makedirs(test_dir)
        for i in infer_frames:
            shutil.copy(bench_ds._paths(i)[0], test_dir)
        argv = base_argv + [f"train.conf_thresh={conf}"]
        emit({"phase": "apps", "step": "relabel", "conf_thresh": conf,
              "keep_window": window, "keep_windows": APPS_KEEP_WINDOWS,
              "threshold_gap": {"gap": gap, "nearest_below": below, "nearest_above": above,
                                "eager_pt2_spans": int(sum(len(x) for x in spans)),
                                "spans_straddling": contested},
              "labels_per_val_frame": kept, "train_frames": len(train_names)})

        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", _INFER_RUN] + base_argv
                              + [f"train.conf_thresh={infer_conf}"], capture_output=True,
                              text=True, timeout=600, cwd=os.path.dirname(os.path.abspath(__file__)))
        infer_s = time.perf_counter() - t0
        out_dir = os.path.join(root, "output", "infer")
        written = {d: sorted(os.listdir(os.path.join(out_dir, d))) if
                   os.path.isdir(os.path.join(out_dir, d)) else []
                   for d in ("images", "annotations", "crops")}
        got = [ln for ln in proc.stdout.splitlines() if ln.startswith("LAUNCHES ")]
        launches["infer"] = json.loads(got[0][len("LAUNCHES "):]) if got else None
        poly_lines = sum(open(os.path.join(out_dir, "annotations", a)).read().count("\n")
                         for a in written["annotations"])  # one a contour of an instance
        emit({"phase": "apps", "app": "infer", "subprocess": "python -m dfine_tpu_torch.apps.infer",
              "returncode": proc.returncode, "seconds": infer_s,
              "files": {k: len(v) for k, v in written.items()}, "polygon_lines": poly_lines,
              "labels_txt": open(os.path.join(out_dir, "labels.txt")).read().split()
              if proc.returncode == 0 else None,
              "launches": launches["infer"], "frames": APPS_INFER_FRAMES,
              "conf_thresh": infer_conf, "eager_detections_a_frame": infer_dets,
              "stderr_tail": proc.stderr[-1500:] if proc.returncode else ""})
        n = APPS_INFER_FRAMES
        if (proc.returncode != 0 or len(written["images"]) != n or len(written["annotations"]) != n
                or not poly_lines or not written["crops"] or launches["infer"] is None):
            failures.append(f"infer: rc {proc.returncode}, files {written}")
        else:  # the serving smoke check at load, then each frame
            _want_deform(launches["infer"], DECODER_LAYERS * (n + 1), "infer")

        t0 = time.perf_counter()
        with counted(launches, "bench"):
            rows = bench_app.main(argv, device=DEV)
        bench_s = time.perf_counter() - t0
        by = {r["backend"]: r for r in rows}
        # where the threshold lies inside spans (no window had a free gap),
        # each detection of a straddling eager/.pt2 pair counts on both
        # sides: bench's F1 of both backends with those all kept and with
        # them all dropped, and the .pt2's share taken either way
        metrics = ("f1", "precision", "recall", "iou")
        rows_ok = (list(by) == ["torch-eager", "torch-cuda-graph", "torch-export"]
                   and all(by["torch-eager"][k] == by["torch-cuda-graph"][k] for k in metrics))
        either, straddle = {}, straddling(served["eager"], served["pt2"], conf)
        if rows_ok and contested:
            for kept in (True, False):
                either["kept" if kept else "dropped"] = {
                    name: bench_app.test_model(EitherWay(backends[name], straddle, side, conf,
                                                         kept), bench_ds, label_names(cfg),
                                               cfg.train.iou_thresh)["f1"]
                    for name, side in (("eager", 0), ("pt2", 1))}
            share_ok = all(e["pt2"] >= APPS_EXPORT_F1_SHARE * e["eager"] for e in either.values())
        else:
            share_ok = rows_ok and (by["torch-export"]["f1"]
                                    >= APPS_EXPORT_F1_SHARE * by["torch-eager"]["f1"])
        del backends
        emit({"phase": "apps", "app": "bench", "seconds": bench_s, "rows": rows,
              "launches": launches["bench"], "val_frames": len(val_names),
              "export_f1_share_min": APPS_EXPORT_F1_SHARE,
              "straddling_pairs": sum(len(x[0]) for x in straddle),
              "f1_either_way": either or None})
        nv = len(val_names)
        # eager and .pt2: 4 a call (the smoke check at load, then each frame);
        # the CUDA graph: 4 in each of its 2 warm-up calls and its capture (a
        # replay runs them on the card without the wrapper)
        _want_deform(launches["bench"], DECODER_LAYERS * (2 * (nv + 1) + 3), "bench")
        if not share_ok:
            failures.append(f"bench: {rows}, either way {either}")
        # the scores near the threshold, detection by detection: the .pt2
        # against eager, which serves its model (held within EXPORT_SCORE_ATOL,
        # and to the same F1 exactly wherever no eager score lies within that
        # drift of conf); the largest eager/.pt2 score gap of any detection
        # of bench's frames beside it
        same = threshold_drift(served["eager"], served["pt2"], conf, APPS_DRIFT_WINDOW)
        f1_implied = same["drift"] < same["margin"]
        eager_f1 = by.get("torch-eager", {}).get("f1")
        emit({"phase": "apps", "step": "threshold_drift", "conf_thresh": conf,
              "half_gap": gap / 2, "window": APPS_DRIFT_WINDOW,
              "score_atol": EXPORT_SCORE_ATOL, "pt2_vs_eager": same,
              "eager_pt2_score_gap_max": max((float((x[:, 1] - x[:, 0]).max())
                                              for x in spans if len(x)), default=0.0),
              "pt2_f1_equal_to_eager": by.get("torch-export", {}).get("f1") == eager_f1,
              "f1_equality_implied": f1_implied})
        if same["drift"] > EXPORT_SCORE_ATOL or same["unpaired"]:
            failures.append(f"bench: .pt2 against eager near conf {same}")
        if f1_implied and by.get("torch-export", {}).get("f1") != eager_f1:
            failures.append(f"bench: .pt2 F1 {by.get('torch-export')} against eager's {eager_f1}")

        t0 = time.perf_counter()
        with counted(launches, "check_errors"):
            errors = check_app.main(argv, device=DEV)
        crops = sum(len(files) for _, _, files in
                    os.walk(os.path.join(root, "output", "check_errors")))
        emit({"phase": "apps", "app": "check_errors", "seconds": time.perf_counter() - t0,
              "counts": errors, "crops": crops, "launches": launches["check_errors"]})
        _want_deform(launches["check_errors"],
                     DECODER_LAYERS * (1 + len(train_names) + len(val_names)), "check_errors")
        if crops != sum(c["fp"] + c["fn"] for c in errors.values()):
            failures.append(f"check_errors: {crops} crops for {errors}")

        quants = {}
        for name, extra in (("config_max_drop", []),
                            ("forced_full_revert", ["export.int8_max_drop=-1"]),
                            ("all_int8", ["export.int8_max_drop=1"])):
            t0 = time.perf_counter()
            with counted(launches, f"quant_{name}"):
                out = quant_app.main(argv + extra, device=DEV)
            quants[name] = out
            evals = 2 + len(out["rounds"])
            emit({"phase": "apps", "app": "quant", "run": name, "overrides": extra,
                  "seconds": time.perf_counter() - t0,
                  **{k: out[k] for k in ("fp_f1", "int8_f1", "drop", "accepted", "count_int8",
                                         "rounds")},
                  "reverted": len(out["reverted"]), "first_reverted": out["reverted"][:5],
                  "artifact_written": "path" in out,
                  "evals": evals, "launches": launches[f"quant_{name}"]})
            _want_deform(launches[f"quant_{name}"],
                         DECODER_LAYERS * evals * -(-len(val_names) // TRAINER_BATCH),
                         f"quant {name}")
        forced, gated, whole = (quants[k] for k in ("forced_full_revert", "config_max_drop",
                                                    "all_int8"))
        # an artifact is written on accept unless every kernel was reverted
        if (forced["count_int8"][0] != 0 or forced["int8_f1"] != forced["fp_f1"]
                or not gated["accepted"] or ("path" in gated) != (gated["count_int8"][0] > 0)
                or not whole["accepted"] or whole["reverted"] or "path" not in whole):
            failures.append(f"quant: forced {forced['count_int8']} F1 {forced['int8_f1']} vs "
                            f"{forced['fp_f1']}; gated accepted {gated['accepted']} "
                            f"{gated['count_int8']}; all int8 {whole['count_int8']}")

        # Int8Model serving the all-int8 run's export_int8.npz: the modules
        # that run evaluated, integers and scales, and through the same eval
        # the F1 of that run's int8 model under the same serving fold
        t0 = time.perf_counter()
        with counted(launches, "int8_model"):
            served = Int8Model(SIZE, str(whole["path"]), TRAINER_CLASSES, IMG, IMG,
                               conf_thresh=conf, half=False, enable_mask_head=True, device=DEV)
            f1 = tr.evaluate("val", model=served.model)["f1"]
        last = {n: m for n, m in whole["model"].named_modules() if isinstance(m, Int8Linear)}
        ours = {n: m for n, m in served.model.named_modules() if isinstance(m, Int8Linear)}
        same = last.keys() == ours.keys() and all(
            torch.equal(a, b) for n in last
            for a, b in zip(last[n].int8_weight(), ours[n].int8_weight()))
        served_count = count_int8(served.model)
        int8_s = time.perf_counter() - t0
        folded = fold_for_serving(copy.deepcopy(whole["model"]), torch.float32)
        folded_f1 = tr.evaluate("val", model=folded.eval())["f1"]
        del folded
        emit({"phase": "apps", "app": "Int8Model", "seconds": int8_s,
              "npz_mb": os.path.getsize(whole["path"]) / 2**20,
              "count_int8": served_count, "quant_count_int8": whole["count_int8"],
              "same_int8_modules": same, "f1": f1, "quant_folded_f1": folded_f1,
              "quant_f1": whole["int8_f1"], "launches": launches["int8_model"]})
        # the smoke check at load, then one eval batch
        _want_deform(launches["int8_model"], DECODER_LAYERS * (1 + -(-len(val_names) //
                                                                     TRAINER_BATCH)), "Int8Model")
        if (not same or not served_count[0] or served_count != tuple(whole["count_int8"])
                or f1 != folded_f1):
            failures.append(f"Int8Model: {served_count} int8, same modules {same}, "
                            f"F1 {f1} vs {folded_f1} (folded quant model)")
        del served, last, ours, tr
        for out in quants.values():
            del out["model"]

        t0 = time.perf_counter()
        sweep_calls: dict = {}
        with captured_sweep(sweep_calls):
            with counted(launches, "test_batching"):
                batch_rows = batching_app.sweep(SIZE, TRAINER_CLASSES, (IMG, IMG),
                                                APPS_BATCH_IMAGES, batching_app.BATCH_SIZES, DEV)
            sweep_s = time.perf_counter() - t0
            # the largest batch's graph against its program run eagerly on
            # the batch of its first replay (whose first sampling call is kept too)
            program, images, graph_out = sweep_calls.pop("graph")
            sweep_calls["key"] = f"eager_{APPS_MAX_BATCH}"
            with torch.inference_mode():
                eager_out = program(images)
        graph_vs_eager = {k: float((graph_out[k].float() - eager_out[k].float()).abs().max())
                          for k in graph_out}
        deform_vs_plain = {}
        with torch.inference_mode():
            for key, (v, shapes, loc, att, pts) in sweep_calls["deform"].items():
                deform_vs_plain[str(key)] = (ms_deform_attn_fwd(v, shapes, loc, att, pts)
                                             - ms_deform_attn_fwd_plain(v, shapes, loc, att, pts)
                                             ).abs().max().item()
        del program, images, graph_out, eager_out, sweep_calls
        best = max(batch_rows, key=lambda r: r["throughput_img_s"])
        emit({"phase": "apps", "app": "test_batching", "seconds": sweep_s,
              "n_images": APPS_BATCH_IMAGES, "rows": batch_rows, "optimum": best["batch_size"],
              "launches": launches["test_batching"],
              f"graph_{APPS_MAX_BATCH}_vs_eager_max_abs": graph_vs_eager,
              "first_deform_call_vs_plain_max_abs": deform_vs_plain})
        # each batch size's graph: 4 in each warm-up call and in its capture
        _want_deform(launches["test_batching"],
                     3 * DECODER_LAYERS * len(batching_app.BATCH_SIZES), "test_batching")
        want_keys = {str(b) for b in batching_app.BATCH_SIZES} | {f"eager_{APPS_MAX_BATCH}"}
        if (set(deform_vs_plain) != want_keys or max(deform_vs_plain.values()) > FWD_TOL
                or max(graph_vs_eager.values()) > GRAPH_ATOL):
            failures.append(f"test_batching: sampling calls vs plain {deform_vs_plain} "
                            f"(atol {FWD_TOL}), graph vs eager {graph_vs_eager} "
                            f"(atol {GRAPH_ATOL})")
        torch.cuda.empty_cache()

        # the etl tools on a copy of the dataset (the card's Python has no cv2)
        t0 = time.perf_counter()
        copy_root = os.path.join(root, "etl")
        etl_ds = os.path.join(copy_root, "data", "dataset")
        shutil.copytree(ds, etl_ds)
        etl_argv = [run["config"], f"train.root={copy_root}", "train.num_workers=4",
                    f"train.label_to_name={{0: ellipse, 1: polygon, 2: blob}}",
                    "task=segment"]
        splits = split.main(etl_argv)
        coco_yolo.main(["yolo2coco"] + etl_argv)
        with open(os.path.join(etl_ds, "coco.json")) as f:
            coco = json.load(f)
        back = os.path.join(copy_root, "labels_back")
        coco_yolo.main(["coco2yolo", os.path.join(etl_ds, "coco.json"), back, "--segment"])
        masks_dir = os.path.join(copy_root, "masks")
        os.makedirs(masks_dir)
        for name in val_names:
            stem = os.path.splitext(name)[0]
            _, _, polys = parse_yolo_label_file(os.path.join(ds, "labels", stem + ".txt"), True)
            m = polygons_to_masks([p * (TRAINER_HW[1], TRAINER_HW[0]) for p in polys], *TRAINER_HW)
            union = m.max(0) if len(m) else np.zeros(TRAINER_HW, np.uint8)  # a frame without labels
            write_png(os.path.join(masks_dir, stem + ".png"), union * 255)
        mask_tools.main(["png_mask_to_yolo", masks_dir, os.path.join(copy_root, "mask_labels")])
        mask_rows = sum(open(os.path.join(copy_root, "mask_labels", f)).read().count("\n")
                        for f in os.listdir(os.path.join(copy_root, "mask_labels")))
        dups = mask_tools.remove_dups(os.path.join(etl_ds, "images"), dry_run=True)
        errors = preprocess.main(etl_argv)
        jpgs = [f for f in os.listdir(os.path.join(etl_ds, "images")) if f.endswith(".jpg")]
        emit({"phase": "apps", "tools": "etl", "seconds": time.perf_counter() - t0,
              "split": {k: len(v) for k, v in splits.items()},
              "coco": {"images": len(coco["images"]), "annotations": len(coco["annotations"])},
              "coco2yolo_files": len(os.listdir(back)), "png_mask_rows": mask_rows,
              "duplicates_found": len(dups), "preprocess_errors": errors, "jpgs": len(jpgs),
              "image_decoder": decoder_name()})
        n_frames = TRAINER_FRAMES
        if (sum(len(v) for v in splits.values()) != n_frames or len(coco["images"]) != n_frames
                or not mask_rows or errors or len(jpgs) != n_frames):
            failures.append("etl: see its line")
    finally:
        run["tmp"].cleanup()
    res["apps_counts"] = launches
    res["apps_seconds"] = time.perf_counter() - t_phase
    emit({"phase": "apps", "seconds": res["apps_seconds"]})
    if failures:
        raise AssertionError("apps: " + "; ".join(failures))


# ------------------------------------------ the widened tail, extra levels --


@contextlib.contextmanager
def launch_widths(acc: dict):
    """Count, in ``acc[(kernel, D)]``, every call of the sampling op, of the
    backward and of the value-gradient scatter chosen by ``set_deform_bwd``
    made while the context is open, by the head dim of its value; each call
    still goes on to its kernel (and its wrapper's own count)."""
    from dfine_tpu_torch.ops import deform_attn as tda

    op, scatters, default = tda.ms_deform_attn_op, dict(tda._SCATTERS), tda.rows_scatter_add
    bwd = tda.ms_deform_attn_bwd

    def sampling(value, flat, loc, att, pts):
        key = ("ms_deform_attn_fwd", int(value.shape[3]))
        acc[key] = acc.get(key, 0) + 1
        return op(value, flat, loc, att, pts)

    def backward(value, *args):
        key = ("ms_deform_attn_bwd", int(value.shape[3]))
        acc[key] = acc.get(key, 0) + 1
        return bwd(value, *args)

    def counted_scatter(fn):
        def call(idx, contrib, hw):
            key = (fn.__name__, int(contrib.shape[-1]))
            acc[key] = acc.get(key, 0) + 1
            return fn(idx, contrib, hw)
        return call

    shims = {k: counted_scatter(fn) for k, fn in scatters.items()}
    # the backward picks the f32 payload by the identity of rows_scatter_add
    tda.ms_deform_attn_op, tda.rows_scatter_add = sampling, shims["pallas"]
    tda.ms_deform_attn_bwd = backward
    tda._SCATTERS.update(shims)
    try:
        yield acc
    finally:
        tda.ms_deform_attn_op, tda.rows_scatter_add = op, default
        tda.ms_deform_attn_bwd = bwd
        tda._SCATTERS.update(scatters)


def _by_width(acc: dict) -> dict:
    return {f"{k}_d{d}": n for (k, d), n in sorted(acc.items())}


def _tests_on_path() -> None:
    """The tests' shared input cases (numpy only) importable."""
    tests = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)


def _deform_cases_checks(dev) -> list:
    """The sampling kernel against its plain version on the cases shared
    with the CPU tests (``tests/test_torch_port_deform_cases.py``: pixel
    edges, one level, head dims 16 and 64, four levels, off the map), bf16
    and f32."""
    import torch

    _tests_on_path()
    from test_torch_port_deform_cases import DEFORM_CASES, deform_case

    from dfine_tpu_torch.ops.kernels.deform_attn import ms_deform_attn_fwd, ms_deform_attn_fwd_plain

    checks = []
    for case in DEFORM_CASES:
        value, shapes, loc, att, pts = deform_case(case)
        for dtype in (torch.float32, torch.bfloat16):
            v = torch.from_numpy(value).to(dev, dtype)
            l, a = torch.from_numpy(loc).to(dev), torch.from_numpy(att).to(dev)
            err = (ms_deform_attn_fwd(v, shapes, l, a, pts)
                   - ms_deform_attn_fwd_plain(v, shapes, l, a, pts)).abs().max().item()
            checks.append({"case": case, "d": int(value.shape[-1]),
                           "value": str(dtype).split(".")[1], "max_abs_err": err})
            if not err <= FWD_TOL:
                raise AssertionError(f"deform fwd case {case} {dtype}: max err {err}")
    return checks


def _scatter_cases_checks(dev, d) -> list:
    """The three scatters at head dim ``d`` on the edge cases shared with
    the CPU tests (``tests/test_torch_port_scatter_cases.py``): the f32 one
    within SCATTER_ATOL/RTOL of its plain version, ``_mxu`` within the bf16
    tolerance (atol 1e-3, rtol 1e-4 where a destination sums hundreds of
    entries, as tests/test_torch_port_cuda.py holds it), ``_tiled`` bit for
    bit against its plain version on the CPU."""
    import torch

    _tests_on_path()
    from test_torch_port_scatter_cases import EDGE_CASES, scatter_case

    from dfine_tpu_torch.ops.kernels import scatter_rows as sr

    checks = []
    for case in EDGE_CASES:
        idx_np, contrib_np, hw = scatter_case(case, d)
        idx = torch.from_numpy(idx_np).to(dev)
        contrib = torch.from_numpy(contrib_np).to(dev)
        out = sr.rows_scatter_add(idx, contrib, hw)
        torch.testing.assert_close(out, sr.rows_scatter_add_plain(idx, contrib, hw),
                                   atol=SCATTER_ATOL, rtol=SCATTER_RTOL)
        many = case in ("clustered", "dense_duplicates")
        mxu = sr.rows_scatter_add_mxu(idx, contrib, hw)
        torch.testing.assert_close(mxu, sr.rows_scatter_add_bf16_plain(idx, contrib, hw),
                                   atol=1e-3 if many else BF16_SCATTER_ATOL,
                                   rtol=1e-4 if many else BF16_SCATTER_RTOL)
        tiled = sr.rows_scatter_add_tiled(idx, contrib, hw).cpu()
        if not torch.equal(tiled, sr.rows_scatter_add_bf16_plain(idx.cpu(), contrib.cpu(), hw)):
            raise AssertionError(f"rows_scatter_add_tiled at D = {d}, case {case}: "
                                 "not bit-equal to the CPU")
        checks.append({"case": case, "d": d,
                       "f32_max_abs_err": float((out - sr.rows_scatter_add_plain(
                           idx, contrib, hw)).abs().max()),
                       "mxu_max_abs_err": float((mxu - sr.rows_scatter_add_bf16_plain(
                           idx, contrib, hw)).abs().max()), "tiled_bit_equal_cpu": True})
    return checks


def _wide_kernels(res):
    """Each kernel at head dim 64 (the wide layers' value) against its plain
    version: the sampling kernel, bf16 and f32, on the shared cases and at
    the wide layer's train shape (timed beside its plain version and its
    bound); the three scatters at the train step's shapes (``_scatter`` at
    D = 64: times, ``index_add_``, bound) and on the shared edge cases."""
    import torch

    from dfine_tpu_torch.ops.kernels.deform_attn import ms_deform_attn_fwd, ms_deform_attn_fwd_plain

    dev = torch.device(DEV)
    checks = _deform_cases_checks(dev)
    errs = []
    for dtype in (torch.float32, torch.bfloat16):
        v, l, a = _deform_inputs(dev, TRAIN_BATCH, WIDE_HEAD_DIM, M_SHAPES, M_POINTS, dtype, 8,
                                 q=TRAIN_QUERIES)
        err = (ms_deform_attn_fwd(v, M_SHAPES, l, a, M_POINTS)
               - ms_deform_attn_fwd_plain(v, M_SHAPES, l, a, M_POINTS)).abs().max().item()
        checks.append({"train_shape": True, "d": WIDE_HEAD_DIM,
                       "value": str(dtype).split(".")[1], "max_abs_err": err})
        errs.append(err)
        if not err <= FWD_TOL:
            raise AssertionError(f"deform fwd D = 64 at the train shape {dtype}: max err {err}")
    # timed as the wide layers run it: bf16 value, locations in the map
    v, l, a = _deform_inputs(dev, TRAIN_BATCH, WIDE_HEAD_DIM, M_SHAPES, M_POINTS,
                             torch.bfloat16, 6, 0.0, 1.0, q=TRAIN_QUERIES)
    bound_ms, bound_by = _deform_bound(v, l, a)
    res["deform_d64"] = {
        "max_abs_err": max(c["max_abs_err"] for c in checks),
        **timings("", lambda: ms_deform_attn_fwd(v, M_SHAPES, l, a, M_POINTS), 100),
        **timings("plain_", lambda: ms_deform_attn_fwd_plain(v, M_SHAPES, l, a, M_POINTS), 10),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "value_mb": v.numel() * v.element_size() / 1e6, "checks": checks}
    emit({"phase": "kernel_ms_deform_attn_fwd_d64",
          "shape": f"m@640 wide layer: B={TRAIN_BATCH} Q={TRAIN_QUERIES} D={WIDE_HEAD_DIM} "
                   "bf16 value", **res["deform_d64"]})
    del v, l, a
    for name in ("rows_scatter_add", "rows_scatter_add_mxu", "rows_scatter_add_tiled"):
        _scatter(res, name, d=WIDE_HEAD_DIM)
    res["scatter_cases_d64"] = _scatter_cases_checks(dev, WIDE_HEAD_DIM)
    emit({"phase": "scatter_cases_d64", "checks": res["scatter_cases_d64"]})
    torch.cuda.empty_cache()


def _wide_in_situ(state, step, batch, gen) -> dict:
    """The three scatters and ``index_add_`` on the inputs that one more
    wide train step gives the default backward at D = 64 (the wide layers'
    6 calls): ``rows_scatter_add`` against its plain version, ``_mxu``
    against the bf16 plain version (atol 1e-3, rtol 1e-4: hot pixels sum
    hundreds of entries), ``_tiled`` bit for bit against the CPU; ms summed
    over the step by CUDA events."""
    import torch

    from dfine_tpu_torch.ops.kernels import scatter_rows as sr

    with captured_scatters([]) as calls:
        step(state, batch, gen)
        sync()
    wide = [c for c in calls if c[1].shape[-1] == WIDE_HEAD_DIM]
    if len(calls) != DECODER_LAYERS * len(M_SHAPES) or len(wide) != WIDE_LAYERS * len(M_SHAPES):
        raise AssertionError(f"wide in situ: {len(calls)} scatter calls, {len(wide)} at D = 64")
    total = dict.fromkeys(("rows_scatter_add", "rows_scatter_add_mxu", "rows_scatter_add_tiled",
                           "library"), 0.0)
    err = {"rows_scatter_add": 0.0, "rows_scatter_add_mxu": 0.0}
    for idx, contrib, hw in wide:
        r, d = idx.shape[0], contrib.shape[-1]
        c16 = contrib.bfloat16()
        safe = torch.where((idx >= 0) & (idx < hw), idx, hw).long()
        flat = (torch.arange(r, device=DEV)[:, None] * (hw + 1) + safe).reshape(-1)
        payload = {"rows_scatter_add": contrib, "rows_scatter_add_mxu": c16,
                   "rows_scatter_add_tiled": c16}
        for n, x in payload.items():
            total[n] += cuda_ms(lambda n=n, x=x: getattr(sr, n)(idx, x, hw), 20)
        total["library"] += cuda_ms(lambda: torch.zeros((r * (hw + 1), d), device=DEV)
                                    .index_add_(0, flat, contrib.reshape(-1, d)), 20)
        out, ref = sr.rows_scatter_add(idx, contrib, hw), sr.rows_scatter_add_plain(idx, contrib,
                                                                                   hw)
        torch.testing.assert_close(out, ref, atol=SCATTER_ATOL, rtol=SCATTER_RTOL)
        err["rows_scatter_add"] = max(err["rows_scatter_add"], float((out - ref).abs().max()))
        out, ref = sr.rows_scatter_add_mxu(idx, c16, hw), sr.rows_scatter_add_bf16_plain(idx, c16,
                                                                                         hw)
        torch.testing.assert_close(out, ref, atol=1e-3, rtol=1e-4)
        err["rows_scatter_add_mxu"] = max(err["rows_scatter_add_mxu"],
                                          float((out - ref).abs().max()))
        if not torch.equal(sr.rows_scatter_add_tiled(idx, c16, hw).cpu(),
                           sr.rows_scatter_add_bf16_plain(idx.cpu(), c16.cpu(), hw)):
            raise AssertionError(f"wide in situ, hw {hw}: rows_scatter_add_tiled not bit-equal")
    return {"ms_per_step": total, "max_abs_err": err, "calls": len(wide)}


def phase_wide_tail(res):
    """Path (A): D-FINE-m detect with ``decoder.layer_scale`` 2 past
    ``eval_idx`` 1 (layers 2-3 at d = 512, FFN 2048, head dim 64). The
    kernels at D = 64 against their plain versions; then the train step
    (bf16, batch 8, G = 100): TRAIN_WARMUP steps (the first captures the
    step's CUDA graph, its launches by kernel and head dim counted: 2 + 2
    sampling, 6 + 6 scatter launches a step), TRAIN_STEPS replays timed,
    the launches the graph holds, p50/p90, device ms and idle share of one
    step, peak memory; the scatters on one more eager step's own D = 64
    inputs; the first
    step in fp32 card against CPU (phase_train_parity's rules); and
    ``TorchModel`` serving the trained weights from a ``.pth``, eval
    stopping at ``eval_idx`` (2 sampling launches a frame, all at D = 32)."""
    import tempfile

    import torch

    from dfine_tpu_torch import TorchModel
    from dfine_tpu_torch.models.dfine import build_model
    from dfine_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from dfine_tpu_torch.train.train_step import GRAPH_WARMUP

    _wide_kernels(res)

    model = build_model(SIZE, NUM_CLASSES, False, device=DEV, cfg_overrides=WIDE_OVERRIDES)
    init = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    state, step = _train_setup(torch.bfloat16, model=model)
    batch = make_train_batch(TRAIN_BATCH, seed=7, device=DEV)
    gen = torch.Generator(device=DEV).manual_seed(0)
    capture_widths = {}  # the first call: its warm-up steps and the capture run the Python
    with launch_widths(capture_widths):
        step(state, batch, gen)
    for _ in range(TRAIN_WARMUP - 1):
        step(state, batch, gen)
    sync()
    want = {"ms_deform_attn_fwd": DECODER_LAYERS, "ms_deform_attn_bwd": DECODER_LAYERS,
            "rows_scatter_add": DECODER_LAYERS * len(M_SHAPES),
            "rows_scatter_add_mxu": 0, "rows_scatter_add_tiled": 0, "hungarian_lap": 1}
    narrow = DECODER_LAYERS - WIDE_LAYERS
    want_widths = {("ms_deform_attn_fwd", HEAD_DIM): narrow,
                   ("ms_deform_attn_fwd", WIDE_HEAD_DIM): WIDE_LAYERS,
                   ("ms_deform_attn_bwd", HEAD_DIM): narrow,
                   ("ms_deform_attn_bwd", WIDE_HEAD_DIM): WIDE_LAYERS,
                   ("rows_scatter_add", HEAD_DIM): narrow * len(M_SHAPES),
                   ("rows_scatter_add", WIDE_HEAD_DIM): WIDE_LAYERS * len(M_SHAPES)}
    times, per_step, metrics = [], [], []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(TRAIN_STEPS):
        reset_launch_counts()  # the main path of this phase: one replayed wide train step
        t = time.perf_counter()
        _, m = step(state, batch, gen)
        sync()
        times.append(time.perf_counter() - t)
        per_step.append(launch_counts())
        metrics.append({k: float(v) for k, v in m.items()})
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    graph_launches = _graph_launches(step)
    # what TRAIN_STEPS more replays ran on the card, counted in its device trace;
    # by head dim, what the capture call launched from Python (its GRAPH_WARMUP
    # warm-up steps and the capture)
    res["wide_counts"] = replayed_launches(lambda: step(state, batch, gen), TRAIN_STEPS)
    res["wide_capture_widths"] = capture_widths
    p50, p90 = percentiles(times)
    finite = all(np.isfinite(list(m_.values())).all() for m_ in metrics)
    first_wide = DECODER_LAYERS - WIDE_LAYERS
    wide_layer = state.model.decoder.decoder.layers[first_wide]
    wide_moved = sum(int(not torch.equal(init[f"decoder.decoder.layers.{first_wide}.{k}"]
                                         .to(DEV), v))
                     for k, v in wide_layer.named_parameters())
    prof = profile_window(lambda: (step(state, batch, gen), sync()), 1, top=12)
    emit({"phase": "wide_tail_train", "model": f"{SIZE} detect {IMG}px, layer_scale 2 past "
          "eval_idx 1, bf16 autocast, fp32 params", "overrides": WIDE_OVERRIDES,
          "batch": TRAIN_BATCH, "gt_slots": TRAIN_G, "steps": TRAIN_STEPS,
          "step_p50_ms": p50, "step_p90_ms": p90, "peak_memory_gb": peak_gb,
          "device_busy_ms": prof["device_busy_ms"],
          "idle_share_at_p50": 1.0 - prof["device_busy_ms"] / p50,
          "metrics_first": metrics[0], "metrics_last": metrics[-1],
          "graph_launches": graph_launches, "python_launches_per_replay": per_step[0],
          "launches_in_profiled_replays": res["wide_counts"],
          "capture_call_launches_by_width": _by_width(capture_widths),
          "wide_layer_params_moved": wide_moved, "losses_finite": finite})
    emit({"phase": "wide_tail_train_profile", "what": "one wide train step", **prof})
    failures = []
    capture_want = {k: n * (GRAPH_WARMUP + 1) for k, n in want_widths.items()}
    replays_want = {k: n * TRAIN_STEPS for k, n in want.items()}
    if (graph_launches != want or res["wide_counts"] != replays_want
            or any(any(c.values()) for c in per_step)
            or capture_widths != capture_want or not finite):
        failures.append(f"graph launches {graph_launches} (want {want}), in {TRAIN_STEPS} "
                        f"profiled replays {res['wide_counts']} (want {replays_want}), Python "
                        f"launches in a replay {per_step[0]}, by width in the capture call "
                        f"{_by_width(capture_widths)} (want {_by_width(capture_want)}), "
                        f"finite {finite}")
    if wide_moved != len(list(wide_layer.parameters())):
        failures.append(f"only {wide_moved} tensors of the wide layer {first_wide} moved")

    step.graphs.clear()  # the scatters' inputs come from an eager step
    state.optimizer.zero_grad()
    torch.cuda.empty_cache()
    res["wide_in_situ"] = _wide_in_situ(state, step.eager, batch, gen)
    emit({"phase": "wide_tail_in_situ", "what": "the D = 64 scatter inputs of one wide train "
          "step: ms summed over the step, by CUDA events; library = index_add_ of the f32 "
          "payload", **res["wide_in_situ"]})

    # TorchModel serving the trained weights (a reference-style .pth)
    tmp = tempfile.TemporaryDirectory()
    pth = os.path.join(tmp.name, "wide.pth")
    torch.save({"model": {k: v.detach().cpu() for k, v in state.model.state_dict().items()}}, pth)
    del state, step, batch, model
    torch.cuda.empty_cache()
    frames = _frames(4)
    tm = TorchModel(SIZE, pth, NUM_CLASSES, IMG, IMG, conf_thresh=0.0, half=True,
                    device=DEV, cfg_overrides=WIDE_OVERRIDES)
    for f in frames:
        tm(f)
    acc, ts = {}, []
    with launch_widths(acc):
        reset_launch_counts()
        for i in range(MODE_FRAMES):
            t = time.perf_counter()
            (out,) = tm(frames[i % len(frames)])
            ts.append(time.perf_counter() - t)
            if not (np.isfinite(out["boxes"]).all() and len(out["scores"])):
                failures.append("served: no finite detections")
        launches = launch_counts()["ms_deform_attn_fwd"]
    q50, q90 = percentiles(ts)
    if acc != {("ms_deform_attn_fwd", HEAD_DIM): WIDE_EVAL_LAYERS * MODE_FRAMES}:
        failures.append(f"served launches {_by_width(acc)}")
    del tm
    tmp.cleanup()
    emit({"phase": "wide_tail_serving", "frames": MODE_FRAMES, "what": "TorchModel bf16 720p "
          "BGR frames, weights of the wide train run, eval stops at eval_idx",
          "call_p50_ms": q50, "call_p90_ms": q90, "deform_launches": launches,
          "by_width": _by_width(acc)})
    try:
        _card_vs_cpu_step(res, "wide_tail_parity", init, seg=False, overrides=WIDE_OVERRIDES)
    except AssertionError as e:
        failures.append(str(e))
    if failures:
        raise AssertionError("wide_tail: " + "; ".join(failures))


def phase_extra_level(res):
    """Path (B): D-FINE-m det+seg with a fourth level (``decoder.num_levels``
    4, points (3, 6, 3, 3)): a stride-2 ConvBN over the last encoder map,
    10 x 10 at 640 px. ``TorchModel`` serves MODE_FRAMES 720p frames (bf16,
    4 sampling launches a frame, over 4 levels), the sampling kernel against
    its plain version on one served frame's inputs; one train step at batch
    8 (bf16, masks; 4 sampling and 16 scatter launches); the model fp32 on
    the card against the CPU (phase_model's rule, weights re-drawn from seed
    1); the 4-level ``AOTModel`` (fp32) replayed against the same model run
    eagerly, then served in bf16 (the extra level's BatchNorm folded)."""
    import torch

    from dfine_tpu_torch import AOTModel, TorchModel
    from dfine_tpu_torch.infer.fuse import FoldedBatchNorm2d
    from dfine_tpu_torch.infer.torch_model import decode
    from dfine_tpu_torch.models.dfine import build_model
    from dfine_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    failures, out = [], {}
    frames = _frames(4)
    tm = TorchModel(SIZE, None, NUM_CLASSES, IMG, IMG, conf_thresh=0.5, half=True,
                    enable_mask_head=True, device=DEV, cfg_overrides=EXTRA_OVERRIDES)
    levels = tm.model.decoder.decoder.layers[0].cross_attn.num_points_list
    out["serving"] = _serve_timed(tm, frames, MODE_FRAMES)
    checks = _served_deform_checks(tm, frames[:1])
    out["served_deform_checks"] = checks
    if out["serving"]["deform_launches"] != DECODER_LAYERS * MODE_FRAMES:
        failures.append(f"served deform launches {out['serving']['deform_launches']}")
    if (len(checks) != DECODER_LAYERS
            or any(len(c["levels"]) != EXTRA_LEVELS for c in checks)
            or max(c["max_abs_err"] for c in checks) > FWD_TOL):
        failures.append(f"served sampling calls vs plain: {checks}")
    del tm

    model = build_model(SIZE, NUM_CLASSES, True, device=DEV, cfg_overrides=EXTRA_OVERRIDES)
    state, step = _train_setup(torch.bfloat16, model=model, seg=True)
    batch = make_train_batch(TRAIN_BATCH, seed=7, device=DEV, masks=True)
    gen = torch.Generator(device=DEV).manual_seed(0)
    step(state, batch, gen)  # the capture
    p0 = {k: v.detach().clone() for k, v in model.named_parameters()}
    reset_launch_counts()  # the main path of this phase: one replayed 4-level train step
    t = time.perf_counter()
    _, m = step(state, batch, gen)
    sync()
    step_ms = (time.perf_counter() - t) * 1e3
    python_launches = launch_counts()
    counts = _graph_launches(step)
    # one more replay's launches, counted in the card's device trace
    res["extra_counts"] = replayed = replayed_launches(lambda: step(state, batch, gen), 1)
    moved = sum(int(not torch.equal(p0[k], v)) for k, v in model.named_parameters())
    want = {"ms_deform_attn_fwd": DECODER_LAYERS, "ms_deform_attn_bwd": DECODER_LAYERS,
            "rows_scatter_add": DECODER_LAYERS * EXTRA_LEVELS,
            "rows_scatter_add_mxu": 0, "rows_scatter_add_tiled": 0, "hungarian_lap": 1}
    finite = all(np.isfinite(float(v)) for v in m.values())
    extra_moved = not torch.equal(p0[f"decoder.input_proj.{EXTRA_LEVELS - 1}.conv.weight"],
                                  model.decoder.input_proj[EXTRA_LEVELS - 1].conv.weight)
    out["train"] = {"batch": TRAIN_BATCH, "step_ms": step_ms, "graph_launches": counts,
                    "launches_in_a_profiled_replay": replayed,
                    "python_launches_per_replay": python_launches,
                    "metrics": {k: float(v) for k, v in m.items()}, "params_moved": moved,
                    "n_params": len(p0), "extra_level_conv_moved": extra_moved}
    if (counts != want or replayed != want or any(python_launches.values()) or not finite
            or not extra_moved or moved < 0.9 * len(p0)):
        failures.append(f"train: graph launches {counts} (want {want}), in a profiled replay "
                        f"{replayed}, Python launches in the replay {python_launches}, finite "
                        f"{finite}, {moved} of {len(p0)} moved, extra level moved {extra_moved}")
    del state, step, batch, model
    torch.cuda.empty_cache()

    cpu = build_model(SIZE, NUM_CLASSES, True, device="cpu", cfg_overrides=EXTRA_OVERRIDES)
    randomize_(cpu, seed=1)
    gpu = copy.deepcopy(cpu).to(DEV)
    x = torch.from_numpy(np.random.default_rng(2).uniform(size=(1, 3, IMG, IMG))
                         .astype(np.float32))
    try:
        out["fp32_card_vs_cpu"] = _card_vs_cpu(cpu, gpu, x, MODEL_ATOL, "extra_level fp32")
    except AssertionError as e:
        failures.append(str(e))
    del cpu, gpu

    aot = {}
    for tag, half in (("fp32", False), ("bf16", True)):
        model = AOTModel(SIZE, None, NUM_CLASSES, IMG, IMG, conf_thresh=0.5, half=half,
                         enable_mask_head=True, device=DEV, cfg_overrides=EXTRA_OVERRIDES)
        if half:  # the extra level's BatchNorm folded into its conv, served in bf16
            folded = type(model.model.decoder.input_proj[-1].norm) is FoldedBatchNorm2d
            r = {"extra_level_bn_folded": folded, **_serve_timed(model, frames, MODE_FRAMES)}
            if not folded:
                failures.append("bf16: the extra level's BatchNorm was not folded")
        else:
            worst = {}
            for f in frames[:2]:
                with torch.inference_mode():
                    xi = model._prepare_inputs(f)[0]
                    g, e = model._predict(xi), decode(model.model, xi, model.num_top_queries)
                for k in g:
                    worst[k] = max(worst.get(k, 0.0),
                                   float((g[k].float() - e[k].float()).abs().max()))
            r = {"replay_vs_eager_max_abs": worst, "graph_atol": GRAPH_ATOL}
            if max(worst.values()) > GRAPH_ATOL:
                failures.append(f"AOTModel 4 levels: graph vs eager {worst} > {GRAPH_ATOL}")
        aot[tag] = r
        del model
        torch.cuda.empty_cache()
    out["aot"] = aot
    emit({"phase": "extra_level", "model": f"{SIZE} det+seg {IMG}px, {EXTRA_LEVELS} levels",
          "overrides": EXTRA_OVERRIDES, "points": list(levels), **out})
    if failures:
        raise AssertionError("extra_level: " + "; ".join(failures))


def _tail_ms(tail) -> dict:
    """The optimizer tail ``tail`` (a step on the gradients in place, then
    the EMA) timed by CUDA events, its device ms by the profiler, and its
    device activities a call (None where every profiler window was
    dropped)."""
    acts = _kernels_of(tail)
    return {**timings("", tail, 20), "device_activities": len(acts) or None}


def phase_flat_optim(res):
    """Path (C): ``build_optimizer(flat=True)`` against the four-group
    ``Optimizer`` on path (A)'s model with the trainer's l options (freeze
    mask, per-group peaks, ``b_accum_steps`` 2), from the same gradients:
    each micro-step's backward runs on the four-group model, and its
    gradients and BatchNorm statistics are copied to the flat one. After 3
    optimizer steps every parameter and EMA element within FLAT_ATOL.
    Then the tail of one optimizer step (clip, AdamW, EMA) of each, timed in
    this call, with its device activities."""
    import torch

    from dfine_tpu_torch.models.dfine import build_model
    from dfine_tpu_torch.train.flat_optim import ema_update_flat
    from dfine_tpu_torch.train.optim import (EMA_BASE, OptimConfig, build_optimizer, ema_update,
                                             freeze_mask)
    from dfine_tpu_torch.train.train_step import write_rates

    cfg = OptimConfig(per_group_max_lr=True, b_accum_steps=2)
    model = build_model(SIZE, NUM_CLASSES, False, device=DEV, cfg_overrides=WIDE_OVERRIDES)
    mask = freeze_mask(model, freeze_backbone_norm=True, freeze_stem=True)
    state, step = _train_setup(torch.bfloat16, model=model, optim=cfg, update_mask=mask)
    flat_model = copy.deepcopy(model)
    flat_opt = build_optimizer(flat_model, cfg, flat=True)
    flat_ema = copy.deepcopy(state.ema)
    batch = make_train_batch(TRAIN_BATCH, seed=7, device=DEV)
    gen = torch.Generator(device=DEV).manual_seed(0)
    opt = state.optimizer

    # the four-group step, with the flat optimizer fed its gradients before it steps
    group_step = opt.step

    def both_steps():
        with torch.no_grad():
            for p, q in zip(model.parameters(), flat_model.parameters()):
                q.requires_grad_(p.requires_grad)
                if p.grad is not None:
                    q.grad.copy_(p.grad)
            for b, c in zip(model.buffers(), flat_model.buffers()):
                c.copy_(b)
        flat_opt.step()
        if flat_opt.mini_step == 0:
            ema_update_flat(flat_ema, flat_model, flat_opt.count)
        return group_step()

    opt.step = both_steps
    try:
        for _ in range(FLAT_STEPS * cfg.b_accum_steps):
            step(state, batch, gen)
    finally:
        opt.step = group_step
    sync()
    worst = {"params": 0.0, "ema": 0.0}
    for part, a, b in (("params", model.state_dict(), flat_model.state_dict()),
                       ("ema", state.ema.state_dict(), flat_ema.state_dict())):
        for k, t in a.items():
            if t.is_floating_point():
                worst[part] = max(worst[part], float((t - b[k]).abs().max()))
    counts_equal = (opt.count, opt.mini_step) == (flat_opt.count, flat_opt.mini_step)
    frozen_same = all(torch.equal(model.get_parameter(k), flat_model.get_parameter(k))
                      for k, keep in mask.items() if not keep)

    # one optimizer step's tail of each, without accumulation, in this call
    for p in model.parameters():
        if p.requires_grad and p.grad is None:
            p.grad = torch.zeros_like(p)
    tails = {}
    one = OptimConfig(per_group_max_lr=True)
    group = build_optimizer(model, one)
    momentum = torch.empty(2, device=DEV)

    def group_tail():  # as the train step runs it: the rates written, AdamW, the EMA
        write_rates(group, momentum, EMA_BASE)
        group.step()
        ema_update(state.ema, model, momentum)

    tails["groups"] = _tail_ms(group_tail)
    flat = build_optimizer(flat_model, one, flat=True)
    flat.grad_flat.copy_(torch.cat([p.grad.reshape(-1) if p.grad is not None
                                    else torch.zeros(p.numel(), device=DEV)
                                    for p in model.parameters()]))

    def flat_tail():
        flat.step()
        ema_update_flat(flat_ema, flat_model, max(flat.count, 1))

    tails["flat"] = _tail_ms(flat_tail)
    tails["groups_again"] = _tail_ms(group_tail)
    n_params = sum(p.numel() for p in model.parameters())
    res["flat_tails"] = tails
    emit({"phase": "flat_optim", "model": f"{SIZE} detect {IMG}px, layer_scale 2, "
          "freeze_mask(norms, stem), per_group_max_lr, b_accum_steps 2",
          "optimizer_steps": FLAT_STEPS, "max_abs_diff": worst, "atol": FLAT_ATOL,
          "counts_equal": counts_equal, "frozen_bit_equal": frozen_same,
          "n_params": n_params, "param_tensors": len(list(model.parameters())),
          "tail": tails})
    del state, step, model, flat_model, flat_ema, batch
    torch.cuda.empty_cache()
    if max(worst.values()) > FLAT_ATOL or not counts_equal or not frozen_same:
        raise AssertionError(f"flat_optim: {worst} beyond {FLAT_ATOL}, counts equal "
                             f"{counts_equal}, frozen equal {frozen_same}")


def in_situ_ms(res, kernel: str):
    """ms a launch of ``kernel`` in the default train step's profile (all its
    instances), or None where that step does not launch it."""
    rows = [v for k, v in res["train_in_situ"].items() if kernel in k]
    n = sum(v["count_per_call"] for v in rows)
    return sum(v["ms_per_launch"] * v["count_per_call"] for v in rows) / n if n else None


def dp_launches(res, name: str) -> dict:
    """``name``'s launches in phase_dp: one DP step at world 1 (NCCL), each
    gloo rank's compared step, each trainer rank's whole run."""
    return {"world1_nccl_step": res["dp_world1_counts"][name],
            "gloo_rank_step": [c[name] for c in res["dp_gloo_counts"]],
            "trainer_rank_run": [c[name] for c in res["dp_trainer_counts"]]}


def wide_launches(res, name: str) -> dict:
    """``name``'s launches on path (A), the wide train run: in the profiled
    replays, and by head dim in the capture call (launched from Python)."""
    return {"profiled_replays": res["wide_counts"][name],
            **{f"capture_call_d{d}": res["wide_capture_widths"].get((name, d), 0)
               for d in (HEAD_DIM, WIDE_HEAD_DIM)}}


def d64_fields(r: dict, library: bool = True) -> dict:
    """A kernel's numbers at head dim 64 (the wide layers' shapes)."""
    return {"d64_ms": r["ms"], "d64_plain_ms": r["plain_ms"], "d64_bound_ms": r["bound_ms"],
            "d64_bound_by": r["bound_by"], "d64_max_abs_err": r["max_abs_err"],
            "d64_library_ms": r["library_ms"] if library else None}


def kernel_line(res):
    d = res["deform"]
    bwd_main = (res.get("bwd_build") or {}).get("main") or {}
    # (name, pallas_call line, launch counts, path, kernel symbol)
    scatters = (("rows_scatter_add", 85, "train_counts",
                 f"train, {TRAIN_STEPS} replays at batch {TRAIN_BATCH}, counted in the "
                 "profiler's device trace (ms: one backward)",
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
         "train_graph_launches_per_step": res["train_graph_launches"]["ms_deform_attn_fwd"],
         "train_seg_launches": res["train_seg_counts"]["ms_deform_attn_fwd"],
         "train_l_launches": res["train_l_counts"]["ms_deform_attn_fwd"],
         "trainer_launches": res["trainer_counts"]["ms_deform_attn_fwd"],
         "dp_launches": dp_launches(res, "ms_deform_attn_fwd"),
         "train_shape_ms": res["deform_train"]["ms"],
         "train_in_situ_ms": in_situ_ms(res, "ms_deform_attn_fwd_kernel"),
         "empty_launch_ms": d["empty_launch_ms"],
         "max_abs_err": d["max_abs_err"], "ms": d["ms"], "plain_ms": d["plain_ms"],
         "bound_ms": d["bound_ms"], "bound_by": d["bound_by"], "library_ms": None,
         "path": f"serving, {SERVE_FRAMES} frames",
         "serving_modes_launches": {**res["serving_modes_counts"], "frames": MODE_FRAMES},
         "deploy_launches": res["deploy_counts"], "int8_launches": res["int8_counts"],
         "aot_graph_launches_per_frame_profiled": res["aot_counts"],
         "export_launches": {"fresh_process": res["export_counts"], "frames": 4},
         "apps_launches": {app: c["ms_deform_attn_fwd"] for app, c in res["apps_counts"].items()},
         **d64_fields(res["deform_d64"], library=False),
         "wide_launches": wide_launches(res, "ms_deform_attn_fwd"),
         "extra_level_launches": res["extra_counts"]["ms_deform_attn_fwd"]},
    ] + [
        {"name": name, "route": "cuda", "source": "dfine_tpu_torch/csrc/rows_scatter_add_tile.cu",
         "replaces": f"dfine_tpu/ops/pallas/scatter_rows.py:{line}",
         "launches": res[counts][name], "max_abs_err": res[name]["max_abs_err"],
         "train_graph_launches_per_step": res["train_graph_launches"][name],
         "train_seg_launches": res["train_seg_counts"][name],
         "train_l_launches": res["train_l_counts"][name],
         "trainer_launches": res["trainer_counts"][name],
         "dp_launches": dp_launches(res, name),
         "apps_launches": sum(c[name] for c in res["apps_counts"].values()),
         "ms": res[name]["ms"], "plain_ms": res[name]["plain_ms"],
         "bound_ms": res[name]["bound_ms"], "bound_by": res[name]["bound_by"],
         "library_ms": res[name]["library_ms"], "path": path,
         "train_in_situ_ms": in_situ_ms(res, symbol),
         "step_inputs_ms": res["in_situ"][name],
         **d64_fields(res[f"{name}_d64"]),
         "d64_step_inputs_ms": res["wide_in_situ"]["ms_per_step"][name],
         "d64_step_inputs_library_ms": res["wide_in_situ"]["ms_per_step"]["library"],
         "wide_launches": wide_launches(res, name),
         "extra_level_launches": res["extra_counts"][name]}
        for name, line, counts, path, symbol in scatters
    ] + [
        {"name": "ms_deform_attn_bwd", "route": "cuda",
         "source": "dfine_tpu_torch/csrc/ms_deform_attn_bwd.cu",
         # the custom VJP's closed form (XLA device code): no Pallas counterpart
         "replaces": "dfine_tpu/ops/deform_attn.py:306",
         "launches": res["train_counts"]["ms_deform_attn_bwd"],
         "train_graph_launches_per_step": res["train_graph_launches"]["ms_deform_attn_bwd"],
         "path": f"train, {TRAIN_STEPS} replays at batch {TRAIN_BATCH}, counted in the "
                 f"profiler's device trace (ms: one call at m@640, "
                 f"B = {GRAD_BATCH}, Q = {QUERIES}, D = {HEAD_DIM}, bf16 value, f32 payload)",
         "gradient_launches": res["gradient_counts"]["ms_deform_attn_bwd"],
         "train_seg_launches": res["train_seg_counts"]["ms_deform_attn_bwd"],
         "train_l_launches": res["train_l_counts"]["ms_deform_attn_bwd"],
         "mxu_launches": res["mxu_counts"]["ms_deform_attn_bwd"],
         "tiled_launches": res["tiled_counts"]["ms_deform_attn_bwd"],
         "trainer_launches": res["trainer_counts"]["ms_deform_attn_bwd"],
         "dp_launches": dp_launches(res, "ms_deform_attn_bwd"),
         "wide_launches": wide_launches(res, "ms_deform_attn_bwd"),
         "extra_level_launches": res["extra_counts"]["ms_deform_attn_bwd"],
         "serving_launches": res["serving_counts"]["ms_deform_attn_bwd"],
         "apps_launches": sum(c["ms_deform_attn_bwd"] for c in res["apps_counts"].values()),
         "max_abs_err": max(r["max_abs_err"] for r in res["deform_bwd"].values()),
         "idx_equal": all(r["idx_equal"] for r in res["deform_bwd"].values()),
         "contrib_bit_equal": all(r["contrib_bit_equal"] for r in res["deform_bwd"].values()),
         **{k: res["deform_bwd"][f"d{HEAD_DIM}_float32_payload"][k] for k in (
             "ms", "plain_ms", "bound_ms", "bound_by", "share_of_bound", "activities_per_call",
             "plain_activities_per_call", "graph_nodes_per_call", "plain_graph_nodes_per_call")},
         "library_ms": None,  # no single PyTorch call computes it
         "variants": {k: {f: r[f] for f in ("ms", "plain_ms", "bound_ms", "bound_by",
                                            "share_of_bound", "max_abs_err")}
                      for k, r in res["deform_bwd"].items() if "frozen" not in k},
         "train_in_situ_ms": in_situ_ms(res, "ms_deform_attn_bwd_kernel"),
         "train_step_turns": res["train_bwd_turns"],
         # the main instance (bf16 value, f32 payload, D = 32) as ptxas built it
         "registers": bwd_main.get("registers"),
         "stack_frame_bytes": bwd_main.get("stack_frame_bytes"),
         "instances_clean": (res.get("bwd_build") or {}).get("clean")},
        {"name": "batch_norm_train", "route": "cuda",
         "source": "dfine_tpu_torch/csrc/batch_norm_train.cu",
         "replaces": None,  # flax's BatchNorm is XLA's: the library's one call is the yardstick
         "launches": res["train_bn_counts"],
         "train_seg_launches": res["train_seg_bn_counts"],
         "path": f"train, {TRAIN_STEPS} replays at batch {TRAIN_BATCH}, counted in the "
                 "profiler's device trace (ms: one step's BatchNorms, forward and backward)",
         **{k: res["batch_norm"]["steps"]["m_detect"][k]
            for k in ("calls_per_step", "in_situ_ms", "alone_ms", "bound_ms", "library_ms")},
         "plain_ms": res["batch_norm"]["steps"]["m_detect"]["chain_ms"],
         "worst": res["batch_norm"]["worst"]},
        {"name": "hungarian_lap", "route": "cuda",
         "source": "dfine_tpu_torch/csrc/hungarian_lap.cu",
         "replaces": "dfine_tpu/ops/hungarian.py:48",  # XLA _solve_one: no Pallas counterpart
         "launches": res["train_counts"]["hungarian_lap"],
         "train_graph_launches_per_step": res["train_graph_launches"]["hungarian_lap"],
         "path": f"train, {TRAIN_STEPS} replays at batch {TRAIN_BATCH}, counted in the "
                 f"profiler's device trace (ms: one step's S x B "
                 "problems)",
         "train_seg_launches": res["train_seg_counts"]["hungarian_lap"],
         "train_l_launches": res["train_l_counts"]["hungarian_lap"],
         "trainer_launches": res["trainer_counts"]["hungarian_lap"],
         "dp_launches": dp_launches(res, "hungarian_lap"),
         "wide_launches": wide_launches(res, "hungarian_lap"),
         "extra_level_launches": res["extra_counts"]["hungarian_lap"],
         "max_abs_err": res["hungarian"]["max_abs_err"], "ms": res["hungarian"]["ms"],
         "plain_ms": res["hungarian"]["plain_ms"], "bound_ms": res["hungarian"]["bound_ms"],
         "bound_by": res["hungarian"]["bound_by"], "library_ms": None,
         "scipy_host_ms": res["hungarian"]["scipy_host_ms"],
         **{k: res["hungarian"][k] for k in ("steps_slowest", "steps_total", "ms_per_step",
                                              "no_pending_ms", "empty_launch_ms",
                                              "butterfly_step_ms", "latency_floor_ms")},
         "train_in_situ_ms": in_situ_ms(res, "hungarian_lap_kernel"),
         "train_event_span_ms_per_step": res["train_solver"]["event_span_ms"]},
    ]}


def _importable(name: str) -> bool:
    import importlib

    try:
        importlib.import_module(name)
        return True
    except ImportError:
        return False


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
    emit({"optional_packages_importable": {n: _importable(n) for n in OPTIONAL_PACKAGES}})

    res, failed = {}, []
    for fn in (phase_build, phase_deform_fwd, phase_scatter, phase_scatter_mxu,
               phase_scatter_tiled, phase_core_backward, phase_core_bwd_kernel, phase_model,
               phase_serving,
               phase_gradient, phase_train, phase_hungarian,
               phase_scatter_in_situ,
               phase_train_bwd_variants,
               phase_train_parity, phase_train_seg, phase_batch_norm, phase_train_seg_parity,
               phase_train_l_frozen, phase_wide_tail, phase_extra_level, phase_flat_optim,
               phase_serving_modes, phase_deploy, phase_int8, phase_aot_graph, phase_export,
               phase_trainer, phase_dp, phase_apps):
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
