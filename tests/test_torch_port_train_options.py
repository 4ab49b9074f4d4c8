"""The train step's options against the JAX package on the CPU, fp32, on the
same numpy inputs: the focal loss with and without label smoothing, the
``agnostic`` and ``one2many`` query selections (model outputs and
criterion), the softmax class cost, one-to-many matching, ``freeze_mask``
at size l, and micro-steps with gradient accumulation, a freeze mask and
the l/x per-group learning-rate peaks against the JAX step, with the
per-group schedules against optax at every step.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_port_helpers import (align_by_box, check_step, jax_template_shapes, map_tree,
                                     patch_jax_dn_key, port_model_from, port_view,
                                     random_outputs, random_targets, random_variables)

SIZE, IMG, NUM_CLASSES, B, G = "n", 320, 5, 2, 4
DN_KEY_SEED = 5


def _t(x):
    return torch.from_numpy(np.array(x))


def _batch(seed):
    rng = np.random.default_rng(seed)
    images = rng.uniform(size=(B, IMG, IMG, 3)).astype(np.float32)
    targets = {"labels": rng.integers(0, NUM_CLASSES, (B, G)).astype(np.int32),
               "boxes": rng.uniform(0.25, 0.6, (B, G, 4)).astype(np.float32),
               "valid": np.asarray([[1, 1, 1, 0], [1, 1, 0, 0]], bool)}
    return images, targets


def _torch_batch(images, targets):
    return {"images": torch.from_numpy(images.transpose(0, 3, 1, 2).copy()),
            "targets": {k: torch.from_numpy(v.copy()) for k, v in targets.items()}}


def _criteria(out, tgt, losses, weights=None, **kw):
    """JAX's and the port's criterion_forward on the same numpy outputs."""
    from dfine_tpu.train.criterion import CriterionConfig as JCfg
    from dfine_tpu.train.criterion import criterion_forward as jax_criterion
    from dfine_tpu.train.criterion import default_weight_dict

    from dfine_tpu_torch.train.criterion import CriterionConfig, criterion_forward

    wd = {**default_weight_dict(), **(weights or {})}
    static = {k: out.pop(k) for k in ("dn_meta", "enc_meta")}
    ref = jax.jit(lambda o, t: jax_criterion({**o, **static}, t, JCfg(
        num_classes=5, losses=losses, weight_dict=wd, **kw)))(
        map_tree(out, jnp.asarray), map_tree(tgt, jnp.asarray))
    out.update(static)
    ours = criterion_forward(map_tree(out, _t), map_tree(tgt, _t), CriterionConfig(
        num_classes=5, losses=losses, weight_dict=wd, **kw))
    return ours, ref


# ------------------------------------------------------- focal, agnostic --


@pytest.mark.parametrize("label_smoothing", [0.0, 0.1])
@pytest.mark.parametrize("enc_classes", [None, 1], ids=["default", "agnostic"])
def test_focal_and_agnostic_criterion_match_jax(label_smoothing, enc_classes):
    """criterion_forward with ``focal`` beside the default losses, with and
    without label smoothing, and with a class-agnostic encoder set (width 1,
    padded to C with -20 columns, matched as class 0): the same loss names,
    each term at rtol 1e-5 (atol 1e-6)."""
    out = random_outputs(3, enc_classes=enc_classes)
    ours, ref = _criteria(out, random_targets(13), ("vfl", "focal", "boxes", "local"),
                          {"loss_focal": 1.0}, label_smoothing=label_smoothing)
    assert set(ours) == set(ref)
    assert {"loss_focal", "loss_focal_aux_1", "loss_focal_pre", "loss_focal_enc_0"} <= set(ours)
    for k, v in ref.items():
        np.testing.assert_allclose(float(ours[k]), float(v), rtol=1e-5, atol=1e-6, err_msg=k)


# ------------------------------------------------------ query selections --


@pytest.mark.parametrize("method", ["one2many", "agnostic"])
def test_query_selection_matches_jax(method, monkeypatch):
    """The train-mode model (n, 320 px) with the ``method`` selection, as the
    JAX model gives it: the width-1 encoder head of ``agnostic`` crosses
    the weight bridge strictly; final, aux, pre and encoder sets aligned by
    box on the final layer (>= 98 % of queries matched, 1:1 for
    ``agnostic``; ``one2many`` selects an anchor once for each of its
    classes that make the top-k, and a repeated query's rows are equal, so
    there each row is matched to a row of the same box within 1e-4) with
    boxes atol 5e-4 and logits atol 2e-3 (test_torch_parity.py:80-83), the
    DN sets in their fixed order; ``enc_meta`` alike. The criterion of each side on its
    own outputs: the same loss names, each term at rtol 1e-3 (atol 1e-5):
    the outputs agree to 2e-3, not to rounding."""
    from dfine_tpu.train.criterion import CriterionConfig as JCfg
    from dfine_tpu.train.criterion import criterion_forward as jax_criterion

    from dfine_tpu_torch.train.criterion import CriterionConfig, criterion_forward

    overrides = (("decoder.query_select_method", method),)
    jmodel, shapes = jax_template_shapes(SIZE, NUM_CLASSES, False, IMG, overrides)
    variables = random_variables(shapes, seed=23)
    noise = patch_jax_dn_key(monkeypatch, DN_KEY_SEED, B, G, NUM_CLASSES)
    images, targets = _batch(4)
    ref, ref_losses = jax.jit(lambda v, x, t: (lambda o: (o, jax_criterion(
        o, t, JCfg(num_classes=NUM_CLASSES))))(jmodel.apply(
            v, x, t, train=True, rngs={"dn": jax.random.key(0)}, mutable=["batch_stats"])[0]))(
        variables, jnp.asarray(images), jax.tree.map(jnp.asarray, targets))
    port = port_model_from(variables, SIZE, NUM_CLASSES, False, overrides).train()
    batch = _torch_batch(images, targets)
    with torch.no_grad():
        ours = port(batch["images"], batch["targets"], dn_noise=noise)
        our_losses = criterion_forward(ours, batch["targets"],
                                       CriterionConfig(num_classes=NUM_CLASSES))

    width = 1 if method == "agnostic" else NUM_CLASSES
    assert port.decoder.enc_score_head.weight.shape[0] == width
    assert ours["enc_aux_outputs"][0]["pred_logits"].shape[-1] == width
    assert ours["enc_meta"] == {"class_agnostic": method == "agnostic"}
    tol = {"pred_boxes": dict(atol=5e-4, rtol=1e-3), "pred_logits": dict(atol=2e-3, rtol=1e-2)}
    for bi in range(B):
        ref_boxes, our_boxes = np.asarray(ref["pred_boxes"])[bi], ours["pred_boxes"][bi].numpy()
        if method == "one2many":
            cost = np.abs(ref_boxes[:, None] - our_boxes[None]).sum(-1)
            match, keep = cost.argmin(1), cost.min(1) <= 1e-4
            assert len(np.unique(our_boxes, axis=0)) < len(our_boxes)  # repeated anchors
        else:
            match, keep = align_by_box(ref_boxes, our_boxes)
        assert keep.mean() >= 0.98, f"only {keep.mean():.3f} of queries matched"
        pairs = ([(ref, ours)] + list(zip(ref["aux_outputs"], ours["aux_outputs"]))
                 + [(ref["pre_outputs"], ours["pre_outputs"])]
                 + list(zip(ref["enc_aux_outputs"], ours["enc_aux_outputs"])))
        for r, o in pairs:
            for k in tol:
                np.testing.assert_allclose(o[k][bi].numpy()[match[keep]],
                                           np.asarray(r[k])[bi][keep], **tol[k], err_msg=k)
    for r, o in zip(ref["dn_outputs"], ours["dn_outputs"]):
        for k in tol:
            np.testing.assert_allclose(o[k].numpy(), np.asarray(r[k]), **tol[k], err_msg=k)
    assert set(our_losses) == set(ref_losses)
    for k, v in ref_losses.items():
        np.testing.assert_allclose(float(our_losses[k]), float(v), rtol=1e-3, atol=1e-5,
                                   err_msg=k)


# --------------------------------------------------------------- matcher --


def test_softmax_class_cost_matches_jax():
    """``use_focal_loss=False``: costs of stacked sets at atol 1e-5, rtol
    1e-6 (the same fp32 formula)."""
    from dfine_tpu import matcher as jm

    from dfine_tpu_torch import matcher as tm

    rng = np.random.default_rng(6)
    s, b, q, c = 3, 2, 12, 5
    logits = rng.normal(0, 2, (s, b, q, c)).astype(np.float32)
    boxes = rng.uniform(0.1, 0.9, (s, b, q, 4)).astype(np.float32)
    tgt = random_targets(4)
    ref = jax.vmap(lambda lg, bx: jm.matching_cost(
        lg, bx, jnp.asarray(tgt["labels"]), jnp.asarray(tgt["boxes"]), jnp.asarray(tgt["valid"]),
        jm.MatcherConfig(use_focal_loss=False)))(jnp.asarray(logits), jnp.asarray(boxes))
    ours = tm.matching_cost(_t(logits), _t(boxes), _t(tgt["labels"])[None].expand(s, -1, -1),
                            _t(tgt["boxes"]), _t(tgt["valid"]),
                            tm.MatcherConfig(use_focal_loss=False))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-6)
    focal = tm.matching_cost(_t(logits), _t(boxes), _t(tgt["labels"])[None].expand(s, -1, -1),
                             _t(tgt["boxes"]), _t(tgt["valid"]), tm.MatcherConfig())
    assert not torch.allclose(focal, ours)


def test_one_to_many_matches_jax():
    """``match_one_to_many`` against the JAX solver on stacked problems with
    pad rows (tests/test_matcher.py:181-): per round, the optimal cost over
    each problem's valid rows agrees (rtol 1e-5) on the cost with the
    earlier rounds' queries blocked; each valid row's k queries are
    distinct, and no query serves two valid rows; pad rows are -1."""
    from dfine_tpu.matcher import match_one_to_many as jax_one_to_many

    from dfine_tpu_torch.matcher import match_one_to_many

    rng = np.random.default_rng(11)
    s, b, g, q, k = 2, 3, 5, 40, 3
    cost = rng.normal(size=(s, b, g, q)).astype(np.float32)
    valid = np.ones((b, g), bool)
    valid[1, 3:] = False
    valid[2, 0] = False
    cost = np.where(valid[None, :, :, None], cost, 0.0).astype(np.float32)
    ref = np.asarray(jax.jit(lambda c, v: jax_one_to_many(c, v, k))(jnp.asarray(cost),
                                                                   jnp.asarray(valid)))
    ours = match_one_to_many(_t(cost), _t(valid), k).numpy()
    assert ours.shape == ref.shape == (s, b, k, g)
    assert all((ours[si, bi, :, ~valid[bi]] == -1).all() for si in range(s) for bi in range(b))
    for si in range(s):
        for bi in range(b):
            v = valid[bi]
            cb, cr = cost[si, bi].copy(), cost[si, bi].copy()
            picked = ours[si, bi][:, v]  # [k, n_valid]
            assert len(set(picked.ravel().tolist())) == picked.size
            for r in range(k):
                rows = np.flatnonzero(v)
                np.testing.assert_allclose(cb[rows, ours[si, bi, r, v]].sum(),
                                           cr[rows, ref[si, bi, r, v]].sum(), rtol=1e-5)
                cb[:, ours[si, bi, r, v]] += 1e6
                cr[:, ref[si, bi, r, v]] += 1e6
    # round 1 is the ordinary matching
    from dfine_tpu_torch.matcher import hungarian

    np.testing.assert_array_equal(ours[:, :, 0], hungarian(_t(cost), _t(valid)).numpy())


@pytest.mark.parametrize("pads", ["constant_0", "constant_3", "varying"])
def test_one_to_many_pad_rows(pads):
    """The port solves every round over each image's valid rows
    (``hungarian`` with ``tgt_valid``), the reduced problem the reference
    solves and ``solve_matchings`` documents (dfine_tpu/matcher.py:172-173);
    JAX's ``match_one_to_many`` calls ``hungarian(c)`` with no row mask
    (:153), so its pad rows compete for queries (ROADMAP Queue 3 item 3).
    Each round of the port equals JAX's solver on the reduced problem (the
    earlier rounds' queries blocked by +1e6), element for element, pad rows
    -1, with scipy's optimum over the valid rows. Where the pad rows cost
    the same on every query the valid rows' queries equal JAX's
    ``match_one_to_many``'s; where their costs vary, JAX gives some valid
    rows other queries, and some of its rounds cost the valid rows more
    than the reduced optimum of that round's (JAX-blocked) costs."""
    from scipy.optimize import linear_sum_assignment

    from dfine_tpu.matcher import match_one_to_many as jax_one_to_many
    from dfine_tpu.ops.hungarian import hungarian as jax_hungarian

    from dfine_tpu_torch.matcher import match_one_to_many

    rng = np.random.default_rng(11)
    s, b, g, q, k = 2, 3, 5, 40, 3
    cost = rng.normal(size=(s, b, g, q)).astype(np.float32)
    valid = np.ones((b, g), bool)
    valid[1, 3:] = False
    valid[2, 0] = False
    pad = (rng.normal(-1.0, 2.0, cost.shape) if pads == "varying"
           else np.full(cost.shape, float(pads.split("_")[1])))
    cost = np.where(valid[None, :, :, None], cost, pad).astype(np.float32)
    ours = match_one_to_many(_t(cost), _t(valid), k).numpy()

    def rounds(matches):
        """Each (set, image, round): the valid rows' total of ``matches`` and
        the reduced optimum (scipy), on that round's costs, the earlier
        rounds' queries of valid rows blocked by +1e6."""
        c, out = cost.copy(), np.zeros((s, b, k, 2))
        for r in range(k):
            for si in range(s):
                for bi in range(b):
                    rows = np.flatnonzero(valid[bi])
                    if rows.size:
                        sub = c[si, bi][rows].astype(np.float64)
                        cols = matches[si, bi, r, rows]
                        out[si, bi, r] = sub[np.arange(rows.size), cols].sum(), \
                            sub[linear_sum_assignment(sub)].sum()
                        c[si, bi][:, cols] += np.float32(1e6)
        return out

    # the reduced problem, round by round, by JAX's own solver with the mask
    solve, c = jax.jit(jax_hungarian), cost.copy()
    for r in range(k):
        ref = np.asarray(solve(jnp.asarray(c), jnp.asarray(valid)))
        np.testing.assert_array_equal(ours[:, :, r], ref, err_msg=f"round {r}")
        blocked = np.zeros((s, b, q + 1), bool)
        np.put_along_axis(blocked, np.where(ref >= 0, ref, q), True, -1)
        c = c + np.where(blocked[:, :, None, :q], np.float32(1e6), np.float32(0))
    ours_totals = rounds(ours)
    np.testing.assert_allclose(ours_totals[..., 0], ours_totals[..., 1], rtol=1e-6)
    jax_o2m = np.asarray(jax.jit(lambda c_, v: jax_one_to_many(c_, v, k))(jnp.asarray(cost),
                                                                         jnp.asarray(valid)))
    on_valid = np.broadcast_to(valid[None, :, None, :], ours.shape)
    if pads != "varying":
        np.testing.assert_array_equal(ours[on_valid], jax_o2m[on_valid])
        return
    assert (ours[on_valid] != jax_o2m[on_valid]).any()
    jax_totals = rounds(jax_o2m)
    excess = jax_totals[..., 0] - jax_totals[..., 1]
    assert (excess > -1e-4).all() and (excess > 1e-3).any()


# ----------------------------------------------------- freeze, schedule --


def test_freeze_mask_matches_jax_at_l():
    """``freeze_mask`` of the port's l model (built on the meta device, no
    weights) against JAX ``freeze_mask`` on a shape-only l template, leaf
    by leaf through the weight bridge's name map, for the three settings
    the trainer can give; every JAX leaf is covered once."""
    from flax import traverse_util

    from dfine_tpu.train.optim import freeze_mask as jax_freeze_mask

    from dfine_tpu_torch.models.dfine import DFINE
    from dfine_tpu_torch.train.optim import freeze_mask
    from dfine_tpu_torch.utils.checkpoint import flax_key

    _, shapes = jax_template_shapes("l", 80, True)
    with torch.device("meta"):
        port = DFINE("l", 80, True)
    for norm, stem in ((True, True), (True, False), (False, True)):
        ref = traverse_util.flatten_dict(jax_freeze_mask(shapes["params"], norm, stem), sep="/")
        ours = freeze_mask(port, norm, stem)
        paths = {name: flax_key(name, p.dim())[0][len("params/"):]
                 for name, p in port.named_parameters()}
        assert sorted(paths.values()) == sorted(ref)
        assert {name: ref[paths[name]] for name in ours} == ours
        assert 0 < sum(not v for v in ours.values()) < len(ours)


@pytest.mark.parametrize("per_group", [False, True])
def test_group_schedules_match_optax(per_group):
    """Each group's learning rate at every optimizer step of a short run
    with ``b_accum_steps = 2`` (so over epochs * steps / 2 optimizer steps),
    the backbone groups on ``onecycle(2 * backbone_lr)`` with
    ``per_group_max_lr``, else on ``onecycle(2 * base_lr)`` as the others,
    against optax's schedules of the JAX optimizer, rtol 1e-5 (optax
    evaluates in float32); the parameters move only on every second
    micro-step."""
    from dfine_tpu.train.optim import OptimConfig as JCfg
    from dfine_tpu.train.optim import onecycle as jax_onecycle

    from dfine_tpu_torch.models.dfine import build_model
    from dfine_tpu_torch.train.optim import OptimConfig, build_optimizer

    kw = dict(epochs=3, steps_per_epoch=8, pct_start=0.2, per_group_max_lr=per_group,
              b_accum_steps=2)
    jcfg = JCfg(**kw)
    sched = {"backbone": jax_onecycle(2 * (jcfg.backbone_lr if per_group else jcfg.base_lr),
                                      jcfg),
             "rest": jax_onecycle(2 * jcfg.base_lr, jcfg)}
    model = build_model("n", 3, device="cpu")
    opt = build_optimizer(model, OptimConfig(**kw))
    probe = model.decoder.enc_bbox_head.layers[0].weight
    for micro in range(3 * 8 + 2):
        for p in opt.params:
            p.grad = torch.full_like(p, 1e-3)
        before = probe.detach().clone()
        opt.write_lr()
        opt.step()
        assert opt.mini_step == (micro + 1) % 2
        assert torch.equal(before, probe) == bool(opt.mini_step)
        if opt.mini_step:  # no optimizer step: the rates stay as they were set
            continue
        for group in opt.adamw.param_groups:
            which = "backbone" if group["group"].startswith("backbone") else "rest"
            np.testing.assert_allclose(group["lr"], float(sched[which](opt.count - 1)),
                                       rtol=1e-5, atol=1e-12, err_msg=(micro, group["group"]))
    assert opt.count == 13


# ------------------------------------------- accumulation + freeze steps --


def test_accumulated_frozen_micro_steps_match_jax(monkeypatch):
    """Two micro-steps of the n detect step with ``b_accum_steps = 2``, a
    freeze mask (backbone norms and stem) and ``per_group_max_lr``, the
    trainer's options for l and x, and like them without LAB
    (``backbone.use_lab`` off: a LAB scalar's gradient is one sum over a
    feature map that a train-mode BatchNorm re-normalizes, and in the mean
    of two micro-batches it cancels to rounding), against
    the JAX step (optax.MultiSteps) on the same two batches, weights and DN
    noise. After the first: the parameters and the EMA bit-unchanged on the
    port's side and unchanged on JAX's, the BatchNorm statistics updated as
    JAX's (atol 1e-5, rtol 1e-4), every metric as JAX's (rtol 1e-4,
    grad_norm, the micro-batch's own, 1e-3). After the second, the
    optimizer steps on the mean of the two gradients: ``check_step``'s
    rules, each frozen parameter bit-unchanged."""
    from dfine_tpu.train.criterion import CriterionConfig as JCrit
    from dfine_tpu.train.optim import OptimConfig as JOpt
    from dfine_tpu.train.optim import build_optimizer as jax_optimizer
    from dfine_tpu.train.optim import freeze_mask as jax_freeze_mask
    from dfine_tpu.train.train_step import TrainState as JState
    from dfine_tpu.train.train_step import make_train_step as jax_step

    from dfine_tpu_torch.train.criterion import CriterionConfig
    from dfine_tpu_torch.train.optim import OptimConfig, build_optimizer, freeze_mask
    from dfine_tpu_torch.train.train_step import TrainState, make_train_step

    overrides = (("backbone.use_lab", False),)
    jmodel, shapes = jax_template_shapes(SIZE, NUM_CLASSES, False, IMG, overrides)
    variables = random_variables(shapes, seed=23)
    noise = patch_jax_dn_key(monkeypatch, DN_KEY_SEED, B, G, NUM_CLASSES)
    kw = dict(per_group_max_lr=True, b_accum_steps=2)
    jmask = jax_freeze_mask(variables["params"], True, True)
    tx = jax_optimizer(variables["params"], JOpt(**kw), update_mask=jmask)
    jstep = jax.jit(jax_step(jmodel, tx, JCrit(num_classes=NUM_CLASSES), update_mask=jmask,
                             b_accum_steps=2))
    port = port_model_from(variables, SIZE, NUM_CLASSES, False, overrides)
    assert not [k for k, _ in port.named_parameters() if ".lab." in k]
    mask = freeze_mask(port, True, True)
    frozen = {k for k, keep in mask.items() if not keep}
    state = TrainState.create(port, build_optimizer(port, OptimConfig(**kw)))
    step = make_train_step(CriterionConfig(num_classes=NUM_CLASSES), compute_dtype=torch.float32,
                           update_mask=mask)
    init = port_view(port, variables)
    jstate = JState.create(variables, tx)
    for micro, seed in enumerate((4, 8)):
        images, targets = _batch(seed)
        jstate, jmetrics = jstep(jstate, {"images": jnp.asarray(images),
                                          "targets": jax.tree.map(jnp.asarray, targets)},
                                 jax.random.key(0))
        state, metrics = step(state, _torch_batch(images, targets), dn_noise=noise)
        if micro == 0:
            assert state.optimizer.mini_step == 1 and state.optimizer.count == 0
            for k, v in jmetrics.items():
                rtol = 1e-3 if k == "grad_norm" else 1e-4
                np.testing.assert_allclose(float(metrics[k]), float(v), rtol=rtol, err_msg=k)
            after = port_view(port, {"params": jstate.params, "batch_stats": jstate.batch_stats})
            for (key, t), e in zip(port.state_dict().items(), state.ema.state_dict().values()):
                if key not in init:
                    continue
                if key.endswith(("running_mean", "running_var")):
                    np.testing.assert_allclose(t.numpy(), after[key], atol=1e-5, rtol=1e-4,
                                               err_msg=key)
                    assert np.array_equal(e.numpy(), init[key]), key
                else:
                    assert np.array_equal(t.numpy(), init[key]), key
                    assert np.array_equal(e.numpy(), init[key]), key
                    assert np.array_equal(after[key], init[key]), key
    assert state.optimizer.mini_step == 0 and state.optimizer.count == 1 and state.step == 2
    assert int(jstate.opt_state.gradient_step) == 1
    assert frozen and all(not port.get_parameter(k).requires_grad for k in frozen)
    check_step(port, state, metrics, jstate, jmetrics, init, frozen=frozen)
