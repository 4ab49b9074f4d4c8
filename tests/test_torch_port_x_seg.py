"""D-FINE-x with the mask head (``perfbench/configs/dfine_x_seg_640.json``)
against the benchmark's plain reference (``perfbench/reference``), on the
CPU in float32 at size x, 160 px, batch 2, on weights drawn by
``perfbench.weights`` under the configuration's own rule: the eval
forward (the conv+BN ``input_proj`` of every level, logits, boxes, mask
logits) with the decode and the postprocess with masks, three train steps
(losses, gradients, the AdamW update with x's per-group peaks and a frozen
stem and backbone norms, the EMA), and the configuration file against the
program's registry.

Both sides compute the same float32 formulas in a different order (the
program's fused and reshaped ops against the reference's plain ones), so
each comparison allows what reordered float32 sums give at this depth:
the tolerances below say which."""

import copy
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from dfine_tpu_torch.configs import model_config
from perfbench import judge, weights
from perfbench.kinds import serve_stream, train_steps
from perfbench.reference import model as ref_model
from perfbench.reference import train as ref_train
from perfbench.reference.denoising import CdnNoise as RefCdnNoise
from perfbench.reference.optim import Optimizer as RefOptimizer
from perfbench.reference.optim import ema_update as ref_ema_update
from perfbench.reference.optim import freeze_mask as ref_freeze_mask

ROOT = Path(__file__).resolve().parents[1]
CONFIG = ROOT / "perfbench" / "configs" / "dfine_x_seg_640.json"
SEED = 2147483900
HW = 160
FRAME_HW = (180, 320)
KEEP = 7
# batch 2, 10 target slots, a ring of 3 batches with 2-6 valid boxes an image
MIX = {"batch": 2, "gt_slots": 10, "boxes_per_image": [2, 3, 4, 6, 1, 5],
       "ring_batches": 3}


@pytest.fixture(scope="module")
def cfg():
    cfg = json.loads(CONFIG.read_text())
    cfg.update(input_size=[HW, HW], serve_dtype="float32", train_compute_dtype="float32")
    return cfg


@pytest.fixture(scope="module")
def drawn(cfg):
    return weights.for_config(cfg, weights.shapes_of(ref_model.build(cfg, "meta")), SEED, "cpu")


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """The largest element gap over the reference's largest magnitude."""
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _hooked(model, names):
    """{name: output of the module ``name`` in the last forward}."""
    got = {}
    for name in names:
        model.get_submodule(name).register_forward_hook(
            lambda m, i, o, name=name: got.__setitem__(name, o))
    return got


def test_config_file_is_the_registrys_x():
    cfg = json.loads(CONFIG.read_text())
    x = model_config("x")
    for section in ("backbone", "encoder", "decoder", "criterion", "matcher"):
        assert json.loads(json.dumps(x[section])) == cfg[section], section
    serve_stream.check_registry(cfg)
    assert (cfg["program_size"], cfg["num_classes"], cfg["mask_head"]) == ("x", 80, True)
    assert cfg["input_size"] == [640, 640] and cfg["reduced"] == []
    from dfine_tpu_torch.config import load_yaml

    lrs = load_yaml((ROOT / "config.yaml").read_text())["train"]["lrs"]["x"]
    assert (cfg["optim"]["base_lr"], cfg["optim"]["backbone_lr"]) == (
        lrs["base_lr"], lrs["backbone_lr"])
    assert cfg["optim"]["per_group_max_lr"] and cfg["freeze"] == {"backbone_norm": True,
                                                                  "stem": True}
    # the decoder's input_proj is a conv+BN at every level only at x
    assert all(c != x["decoder"]["hidden_dim"] for c in x["decoder"]["feat_channels"])


def test_eval_forward_decode_and_masks(cfg, drawn):
    from dfine_tpu_torch.models.dfine import build_model
    from dfine_tpu_torch.postprocess import postprocess_predictions, topk_decode
    from perfbench.reference import postprocess as ref_post

    ref = ref_model.build(cfg, "cpu")
    ref.load_state_dict(drawn, strict=True)
    prog = build_model("x", cfg["num_classes"], True, device="cpu").eval()
    prog.load_state_dict(drawn, strict=True)
    names = [f"decoder.input_proj.{i}" for i in range(3)] + ["decoder.pixel_decoder",
                                                             "decoder.mask_head"]
    assert all(isinstance(prog.get_submodule(n), torch.nn.Sequential) for n in names[:3])
    ours_in, theirs_in = _hooked(prog, names), _hooked(ref, names)
    x = weights.images(weights.generator(SEED, "cpu", stream=1), 2, (HW, HW), "cpu")
    with torch.no_grad():
        ours, theirs = prog(x), ref(x)
    # the same conv and BatchNorm on the same encoder output: equal on the
    # CPU, a few float32 ulps where another conv algorithm were taken
    for n in names[:3]:
        assert _rel(ours_in[n], theirs_in[n]) < 1e-6, n
    # after 6 decoder layers the deformable sampling (the program's gather
    # against the reference's grid_sample) and the reordered sums move an
    # element by up to ~1.5e-6 of the largest (logits 4.5e-7, boxes 1.2e-7,
    # mask logits 1.4e-6 on this seed)
    assert _rel(ours["pred_logits"], theirs["pred_logits"]) < 2e-5
    assert _rel(ours["pred_boxes"], theirs["pred_boxes"]) < 2e-5
    logits = [torch.einsum("bqc,bchw->bqhw", got["decoder.mask_head"],
                           got["decoder.pixel_decoder"]) for got in (ours_in, theirs_in)]
    assert _rel(*logits) < 2e-5
    assert _rel(ours["pred_masks"], theirs["pred_masks"]) < 2e-5

    # the decode and the served answer: each frame's threshold keeps KEEP,
    # halfway between the reference's KEEP-th and next score
    dec_o = topk_decode(ours["pred_logits"], ours["pred_boxes"], masks=ours["pred_masks"])
    dec_t = ref_post.topk_decode(theirs["pred_logits"], theirs["pred_boxes"], 300,
                                 masks=theirs["pred_masks"])
    for b in range(2):
        s = dec_t["scores"][b]
        thr = float((s[KEEP - 1] + s[KEEP]) / 2)
        assert float(s[KEEP - 1] - s[KEEP]) > 1e-5  # no tie at the threshold
        (got,) = postprocess_predictions({k: v[b:b + 1] for k, v in dec_o.items()},
                                         (HW, HW), [FRAME_HW], conf_thresh=thr)
        (want,) = ref_post.postprocess_predictions({k: v[b:b + 1] for k, v in dec_t.items()},
                                                   (HW, HW), [FRAME_HW], conf_thresh=thr)
        assert len(got["scores"]) == len(want["scores"]) == KEEP
        order_o, order_t = np.argsort(got["scores"]), np.argsort(want["scores"])
        np.testing.assert_array_equal(got["labels"][order_o], want["labels"][order_t])
        np.testing.assert_allclose(got["scores"][order_o], want["scores"][order_t], atol=1e-5)
        np.testing.assert_allclose(got["boxes"][order_o], want["boxes"][order_t], atol=1e-2)
        assert got["masks"].shape == (KEEP, *FRAME_HW) and got["masks"].dtype == np.uint8
        # a pixel flips only where its probability sits within rounding of
        # the threshold: a few pixels of the 7 x 57,600
        flipped = (got["masks"][order_o] != want["masks"][order_t]).mean()
        assert flipped < 1e-3, flipped
        assert 0 < want["masks"].mean() < 1  # the masks have shapes


def _reference_steps(cfg, w, batches):
    """The reference's three steps (``ref_train.readings``' loop), keeping
    the tensors: the losses, the first clipped gradient (AdamW's first
    moment over 1 - beta1) after step 1, the parameters and the EMA after
    step 3."""
    model = ref_model.build(cfg, "cpu")
    model.load_state_dict(w, strict=True)
    frozen = [k for k, keep in ref_freeze_mask(model, True, True).items() if not keep]
    ema = copy.deepcopy(model).eval().requires_grad_(False)
    opt = RefOptimizer(model, ref_train.optim_config(cfg))
    crit = ref_train.criterion_config(cfg)
    names = {p: k for k, p in model.named_parameters()}
    beta1 = opt.adamw.defaults["betas"][0]
    losses, grad = [], {}
    for i, batch in enumerate(batches):
        for k in frozen:
            model.get_parameter(k).requires_grad_(False)
        model.train()
        opt.zero_grad()
        out = model(batch["images"], batch["targets"], RefCdnNoise(*batch["noise"]))
        loss = ref_train.criterion_forward(out, batch["targets"], crit)["total"]
        loss.backward()
        opt.step()
        ref_ema_update(ema, model, opt.count, cfg["ema_base"])
        losses.append(float(loss.detach()))
        if i == 0:
            grad = {names[p]: s["exp_avg"].clone() / (1 - beta1)
                    for p, s in opt.adamw.state.items()}
    return {"losses": losses, "grad": grad, "frozen": set(frozen),
            "params": {k: p.detach().clone() for k, p in model.named_parameters()},
            "ema": {k: p.clone() for k, p in ema.named_parameters()},
            "lrs": [g["lr"] for g in opt.adamw.param_groups]}


def _program_steps(cfg, w, batches):
    state, step = train_steps.program_state(cfg, w, "cpu")
    opt = state.optimizer
    names = {p: k for k, p in state.model.named_parameters()}
    beta1 = opt.adamw.defaults["betas"][0]
    losses, grad = [], {}
    for i, batch in enumerate(batches):
        _, m = train_steps.call(step, state, batch)
        losses.append(float(m["loss"]))
        if i == 0:
            grad = {names[p]: s["exp_avg"].clone() / (1 - beta1)
                    for p, s in opt.adamw.state.items()}
    frozen = {k for k, p in state.model.named_parameters() if not p.requires_grad}
    return {"losses": losses, "grad": grad, "frozen": frozen,
            "params": {k: p.detach().clone() for k, p in state.model.named_parameters()},
            "ema": {k: p.detach().clone() for k, p in state.ema.named_parameters()},
            "lrs": [float(g["lr"]) for g in opt.adamw.param_groups]}


def test_three_train_steps(cfg, drawn):
    batches = train_steps.ring(cfg, MIX, SEED, "cpu")
    assert "masks" in batches[0]["targets"]
    theirs = _reference_steps(cfg, drawn, batches)
    ours = _program_steps(cfg, drawn, batches)

    # the same frozen leaves: the stem and every backbone norm, and they stay put
    assert ours["frozen"] == theirs["frozen"] and theirs["frozen"]
    assert any(k.startswith("backbone.stem") for k in ours["frozen"])
    for k in ours["frozen"]:
        assert torch.equal(ours["params"][k], drawn[k]), k
        assert k not in ours["grad"] and k not in theirs["grad"]
    # the per-group rates after three steps (x's per-group peaks on the
    # warm-up): the program holds each in a float32 tensor
    np.testing.assert_allclose(ours["lrs"], theirs["lrs"], rtol=1e-6)
    assert len(set(theirs["lrs"])) > 1

    # the losses: float32 sums of some 10^5 terms, reordered (1.7e-7 here)
    np.testing.assert_allclose(ours["losses"], theirs["losses"], rtol=2e-5)

    # the first clipped gradient, leaf by leaf, on the scale of the leaf's
    # own norm or the median leaf's: reordered sums through the backward of
    # B5 (the deform backward's scatter sums its rows in another order),
    # at most 2.6e-6 on this seed
    assert set(ours["grad"]) == set(theirs["grad"])
    med = float(np.median([g.norm() for g in theirs["grad"].values()]))
    gaps = {k: float((ours["grad"][k] - g).norm() / max(float(g.norm()), med))
            for k, g in theirs["grad"].items()}
    assert max(gaps.values()) < 1e-4, max(gaps.items(), key=lambda kv: kv[1])

    # the update after three steps and the EMA, each leaf's change on its
    # own norm, over the leaves whose reference gradient is at least a
    # thousandth of the median leaf's (the rest, BatchNorm biases before a
    # train-mode BatchNorm and the like, move by round-off alone, as
    # ``perfbench.judge`` has it). After three warm-up steps a backbone
    # leaf (rate 6e-8 a step) has moved some 1e-5 of its weight, so one
    # float32 ulp of the weight is up to 1 % of its change, and the two
    # sides round it apart; the EMA rounds the weight once more in its
    # blend (on this seed medians 6.9e-4 and 1.4e-3, the widest leaf 0.013
    # and 0.021)
    live = [k for k, g in theirs["grad"].items() if float(g.norm()) >= judge.NOUGHT_SHARE * med]
    for side, median_tol in (("params", 3e-3), ("ema", 5e-3)):
        gaps = {}
        for k in live:
            want, got = theirs[side][k] - drawn[k], ours[side][k] - drawn[k]
            gaps[k] = float((got - want).norm() / want.norm().clamp_min(1e-30))
        assert np.median(list(gaps.values())) < median_tol, side
        assert max(gaps.values()) < 0.05, (side, max(gaps.items(), key=lambda kv: kv[1]))
