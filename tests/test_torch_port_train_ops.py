"""The train-step slice's pieces against the JAX package on the CPU, fp32,
on the same numpy inputs: the bf16 scatters' plain versions, the deform
core's mxu/tiled backward, (G)IoU and the FGL bin
targets, the CDN queries, the matcher, the criterion, the schedule and the
parameter groups. Each test states its tolerance."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_port_helpers import jax_cdn_noise, jax_template_shapes
from test_torch_port_helpers import map_tree as _tree
from test_torch_port_helpers import random_outputs as _random_outputs
from test_torch_port_helpers import random_targets as _targets
from test_torch_port_scatter_cases import EDGE_CASES, scatter_case


def _t(x):
    return torch.from_numpy(np.array(x))


# ------------------------------------------------------------ (a) scatters --


def _bf16_naive(idx, contrib, hw):
    """np.add.at of the contributions rounded once to bf16."""
    rounded = np.asarray(jnp.asarray(contrib).astype(jnp.bfloat16), np.float32)
    ref = np.zeros((idx.shape[0], hw, contrib.shape[-1]), np.float32)
    for b in range(idx.shape[0]):
        keep = (idx[b] >= 0) & (idx[b] < hw)
        np.add.at(ref[b], idx[b][keep], rounded[b][keep])
    return ref


def _cases():
    rng = np.random.default_rng(7)
    rand_idx = rng.integers(-1, 777, (3, 1000)).astype(np.int32)
    rand = rng.normal(size=(3, 1000, 32)).astype(np.float32)
    one_row = np.full((2, 600), 700, np.int32)  # every update in one row (and one TPU tile)
    ones = np.ones((2, 600, 8), np.float32)
    dropped = np.full((2, 600), -1, np.int32)
    cases = {"random": (rand_idx, rand, 777), "one_row": (one_row, ones, 2000),
             "all_dropped": (dropped, ones, 2000)}
    cases.update({name: scatter_case(name, 16, seed=1) for name in EDGE_CASES})
    return cases


@pytest.mark.parametrize("impl", ["mxu", "tiled"])
@pytest.mark.parametrize("case", ["random", "one_row", "all_dropped", *EDGE_CASES])
def test_bf16_scatter_plain_matches_pallas_and_naive(impl, case):
    """atol 1e-5, rtol 1e-6 (test_pallas_scatter.py:48, :165): f32 sums of
    the same bf16-rounded payload in another order. The plain version adds
    the entries in increasing n, as ``np.add.at`` does, so the two are
    bit-equal: the order that the card's ``tiled`` kernel keeps."""
    from dfine_tpu.ops.pallas import scatter_rows as jsr

    from dfine_tpu_torch.ops.kernels import scatter_rows as tsr

    idx, contrib, hw = _cases()[case]
    pallas = {"mxu": jsr.rows_scatter_add_mxu, "tiled": jsr.rows_scatter_add_tiled}[impl]
    ref_pallas = np.asarray(pallas(jnp.asarray(idx), jnp.asarray(contrib), hw, interpret=True))
    ours = getattr(tsr, f"rows_scatter_add_{impl}")(_t(idx), _t(contrib), hw).numpy()
    np.testing.assert_allclose(ours, ref_pallas, atol=1e-5, rtol=1e-6)
    np.testing.assert_array_equal(ours, _bf16_naive(idx, contrib, hw))
    if case == "one_row":
        assert ours[0, 700, 0] == 600 and np.count_nonzero(ours[:, :700]) == 0
    if case == "all_dropped":
        assert np.count_nonzero(ours) == 0


# --------------------------------------------------- (b) deform core grads --


@pytest.mark.parametrize("impl", ["mxu", "tiled"])
def test_core_backward_matches_jax_fused(impl):
    """MSDeformAttnCore with the bf16 scatters against ``jax.grad`` of
    ``ms_deform_attn_core_fused(scatter_impl=impl, interpret=True)``, shapes
    of test_pallas_scatter.py:101-145 with out-of-map locations. Both round
    each value-gradient contribution once to bf16: value grads within
    4e-3 x max |grad| (one bf16 ulp of a contribution where the two f32
    products round apart), location and attention grads (f32 on both
    sides) within 2e-4 x max |grad|."""
    from dfine_tpu.ops.deform_attn import ms_deform_attn_core_fused

    from dfine_tpu_torch.ops import deform_attn as tda

    rng = np.random.default_rng(0)
    b, q, h, d = 2, 50, 8, 16
    shapes, pts = ((20, 20), (10, 10), (5, 5)), (3, 6, 3)
    value = rng.normal(size=(b, sum(x * y for x, y in shapes), h, d)).astype(np.float32)
    loc = rng.uniform(-0.1, 1.1, size=(b, q, h, sum(pts), 2)).astype(np.float32)
    att = np.asarray(jax.nn.softmax(jnp.asarray(rng.normal(size=(b, q, h, sum(pts)))), -1),
                     np.float32)
    g_ref = jax.grad(lambda v, l, a: (ms_deform_attn_core_fused(
        v, shapes, l, a, pts, interpret=True, scatter_impl=impl) ** 2).sum(),
        argnums=(0, 1, 2))(jnp.asarray(value), jnp.asarray(loc), jnp.asarray(att))

    tda.set_deform_bwd(impl)
    try:
        v, l, a = (_t(x).requires_grad_() for x in (value, loc, att))
        (tda.ms_deform_attn(v, shapes, l, a, pts) ** 2).sum().backward()
    finally:
        tda.set_deform_bwd("pallas")
    for name, ours, ref, tol in zip(("value", "loc", "att"), (v.grad, l.grad, a.grad), g_ref,
                                    (4e-3, 2e-4, 2e-4)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(ours.numpy(), ref, atol=tol * np.abs(ref).max(),
                                   err_msg=name)


def test_set_deform_bwd_rejects_the_unported_settings():
    from dfine_tpu_torch.ops import deform_attn as tda

    for impl in ("xla", "sorted", "window", "concat", "concat_bf16", "chunked", "novalue",
                 "xla_novalue"):
        with pytest.raises(ValueError, match=impl):
            tda.set_deform_bwd(impl)
    assert tda.deform_bwd_impl() == "pallas"


# --------------------------------------------------------- boxes and FDR --


def test_iou_and_bin_targets_match_jax():
    """Pairwise/aligned (G)IoU and translate_gt/bbox2distance elementwise in
    fp32 (atol 1e-6, rtol 1e-5), with offsets across every clamp of
    translate_gt: below the first bin, past the last, exactly on bin
    values, and degenerate boxes."""
    from dfine_tpu.ops import boxes as jb
    from dfine_tpu.ops import fdr as jf

    from dfine_tpu_torch.ops import boxes as tb
    from dfine_tpu_torch.ops import fdr as tf

    rng = np.random.default_rng(3)
    b1 = rng.uniform(0, 1, (5, 7, 4)).astype(np.float32)
    b2 = rng.uniform(0, 1, (5, 9, 4)).astype(np.float32)
    b1[0, 0] = [0.5, 0.5, 0.5, 0.5]  # zero area
    x1, x2 = (np.asarray(jb.box_cxcywh_to_xyxy(jnp.asarray(b))) for b in (b1, b2))
    tol = dict(atol=1e-6, rtol=1e-5)
    for name in ("generalized_box_iou_pairwise",):
        np.testing.assert_allclose(getattr(tb, name)(_t(x1), _t(x2)).numpy(),
                                   np.asarray(getattr(jb, name)(x1, x2)), **tol)
    np.testing.assert_allclose(tb.box_iou_pairwise(_t(x1), _t(x2))[0].numpy(),
                               np.asarray(jb.box_iou_pairwise(x1, x2)[0]), **tol)
    np.testing.assert_allclose(tb.box_iou_aligned(_t(x1), _t(x1[:, ::-1].copy()))[0].numpy(),
                               np.asarray(jb.box_iou_aligned(x1, x1[:, ::-1])), **tol)
    np.testing.assert_allclose(
        tb.generalized_box_iou_aligned(_t(x1), _t(x1[:, ::-1].copy())).numpy(),
        np.asarray(jb.generalized_box_iou_aligned(x1, x1[:, ::-1])), **tol)

    fv = np.asarray(jf.weighting_function(32, 0.5, 4.0))
    gt = np.concatenate([rng.uniform(-6, 6, 400), fv, fv + 1e-4, [-1e3, -4.0, 4.0, 1e3]])
    gt = gt.astype(np.float32)
    for ours, ref in zip(tf.translate_gt(_t(gt), 32, 4.0, 0.5),
                         jf.translate_gt(jnp.asarray(gt), 32, 4.0, 0.5)):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **tol)
    pts = rng.uniform(0.2, 0.8, (50, 4)).astype(np.float32)
    pts[:5, 2:] = 1e-3  # tiny reference boxes push every edge past the last bin
    gtb = np.asarray(jb.box_cxcywh_to_xyxy(jnp.asarray(rng.uniform(0, 1, (50, 4)).astype(
        np.float32))))
    for ours, ref in zip(tf.bbox2distance(_t(pts), _t(gtb), 32, 4.0, 0.5),
                         jf.bbox2distance(jnp.asarray(pts), jnp.asarray(gtb), 32, 4.0, 0.5)):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **tol)


# ------------------------------------------------------------------ (c) CDN --


@pytest.mark.parametrize("num_denoising,g", [(100, 4), (100, 7), (5, 8)])
def test_cdn_queries_match_jax(num_denoising, g):
    """Same key, same draws: class ids exact, reference logits atol 1e-5;
    keep-mask and DN matching exact."""
    from dfine_tpu.models import denoising as jd

    from dfine_tpu_torch.models import denoising as td

    valid = np.random.default_rng(g).uniform(size=(2, g)) < 0.6
    tgt = _targets(1, g=g, valid=valid)
    key = jax.random.key(9)
    cls_j, box_j, meta_j = jd.build_cdn_queries(
        jnp.asarray(tgt["labels"]), jnp.asarray(tgt["boxes"]), jnp.asarray(valid), key, 5,
        num_denoising)
    noise = jax_cdn_noise(key, 2, g, 5, num_denoising)
    cls_t, box_t, meta_t = td.build_cdn_queries(
        _t(tgt["labels"]), _t(tgt["boxes"]), _t(valid), noise, 5, num_denoising)
    assert tuple(meta_t) == tuple(meta_j)
    np.testing.assert_array_equal(cls_t.numpy(), np.asarray(cls_j))
    np.testing.assert_allclose(box_t.numpy(), np.asarray(box_j), atol=1e-5)
    np.testing.assert_array_equal(td.dn_attn_mask(meta_t.num_group, g, 30),
                                  jd.dn_attn_mask(meta_j.num_group, g, 30))
    for ours, ref in zip(td.dn_match_indices(_t(valid), meta_t.num_group),
                         jd.dn_match_indices(jnp.asarray(valid), meta_j.num_group)):
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def test_cdn_noise_draw_has_the_shapes_and_ranges():
    from dfine_tpu_torch.models.denoising import draw_cdn_noise

    n = draw_cdn_noise(3, 4, 5, 100, 0.5, torch.Generator().manual_seed(0))
    assert n.flip.shape == (3, 200) and n.flip.dtype == torch.bool
    assert int(n.new_label.min()) >= 0 and int(n.new_label.max()) < 5
    assert set(n.sign.unique().tolist()) == {-1.0, 1.0}
    assert n.part.shape == (3, 200, 4) and 0 <= float(n.part.min()) and float(n.part.max()) < 1


# -------------------------------------------------------------- (d) matcher --


def test_matching_cost_and_go_union_match_jax():
    """Costs of stacked sets at atol 1e-5, rtol 1e-6 (the same fp32
    formula); go_union on the same matches exactly."""
    from dfine_tpu import matcher as jm

    from dfine_tpu_torch import matcher as tm

    rng = np.random.default_rng(5)
    s, b, q, c, g = 3, 2, 12, 5, 4
    logits = rng.normal(0, 2, (s, b, q, c)).astype(np.float32)
    boxes = rng.uniform(0.1, 0.9, (s, b, q, 4)).astype(np.float32)
    tgt = _targets(2)
    cfg_j, cfg_t = jm.MatcherConfig(), tm.MatcherConfig()
    ref = jax.vmap(lambda lg, bx: jm.matching_cost(
        lg, bx, jnp.asarray(tgt["labels"]), jnp.asarray(tgt["boxes"]),
        jnp.asarray(tgt["valid"]), cfg_j))(jnp.asarray(logits), jnp.asarray(boxes))
    ours = tm.matching_cost(_t(logits), _t(boxes), _t(tgt["labels"])[None].expand(s, -1, -1),
                            _t(tgt["boxes"]), _t(tgt["valid"]), cfg_t)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-6)

    match = rng.integers(0, q, (s, b, g)).astype(np.int32)
    match[:, ~tgt["valid"]] = -1
    match[1] = match[0]  # agreeing sets
    for ours_u, ref_u in zip(tm.go_union(_t(match).long(), _t(tgt["valid"]), q),
                             jm.go_union(jnp.asarray(match), jnp.asarray(tgt["valid"]), q)):
        np.testing.assert_array_equal(ours_u.numpy(), np.asarray(ref_u))


def test_hungarian_optimum_equals_jax():
    """The matcher's device solver (the plain version on the CPU) against
    the JAX on-device solver, random problems with pad rows: the same
    assignment element for element, so the same optimal costs (rtol 1e-6),
    pad rows -1 from the solver and 0 after solve_matchings."""
    from dfine_tpu.ops.hungarian import hungarian as jax_hungarian

    from dfine_tpu_torch import matcher as tm

    rng = np.random.default_rng(8)
    s, b, g, q = 3, 4, 9, 40
    cost = rng.uniform(0, 10, (s, b, g, q)).astype(np.float32)
    valid = rng.uniform(size=(b, g)) < 0.6
    valid[0] = False  # an image without boxes
    valid[1, :] = True
    cost = np.where(valid[None, :, :, None], cost, 0.0).astype(np.float32)
    ref = np.asarray(jax_hungarian(jnp.asarray(cost), jnp.asarray(valid)))
    ours = tm.hungarian(_t(cost), _t(valid)).numpy()
    np.testing.assert_array_equal(ours, ref)
    assert (ours[:, ~valid] == -1).all() and (ref[:, ~valid] == -1).all()
    rows = np.arange(g)
    for si in range(s):
        for bi in range(b):
            v = valid[bi]
            assert len(set(ours[si, bi][v])) == v.sum()  # an assignment
            np.testing.assert_allclose(cost[si, bi, rows[v], ours[si, bi][v]].sum(),
                                       cost[si, bi, rows[v], ref[si, bi][v]].sum(), rtol=1e-6)
    match, go_q, _, go_valid = tm.solve_matchings(_t(cost), _t(valid))
    assert int(match.min()) >= 0 and int(go_q[~go_valid].abs().sum()) == 0


# ------------------------------------------------------------ (e) criterion --


@pytest.mark.parametrize("seed", [0, 1])
def test_criterion_matches_jax(seed):
    """criterion_forward on identical outputs: the same loss names, each
    term at rtol 1e-5 (atol 1e-6)."""
    from dfine_tpu.train.criterion import CriterionConfig as JCfg
    from dfine_tpu.train.criterion import criterion_forward as jax_criterion

    from dfine_tpu_torch.train.criterion import CriterionConfig, criterion_forward

    out = _random_outputs(seed)
    tgt = _targets(seed + 10)
    static = {k: out.pop(k) for k in ("dn_meta", "enc_meta")}
    ref = jax.jit(lambda o, t: jax_criterion({**o, **static}, t, JCfg(num_classes=5)))(
        _tree(out, jnp.asarray), _tree(tgt, jnp.asarray))
    out.update(static)
    ours = criterion_forward(_tree(out, _t), _tree(tgt, _t), CriterionConfig(num_classes=5))
    assert set(ours) == set(ref)
    for k, v in ref.items():
        np.testing.assert_allclose(float(ours[k]), float(v), rtol=1e-5, atol=1e-6, err_msg=k)


def test_criterion_with_no_valid_box_stays_finite():
    from dfine_tpu_torch.train.criterion import CriterionConfig, criterion_forward

    tgt = _tree(_targets(0, valid=((0, 0, 0, 0), (0, 0, 0, 0))), _t)
    losses = criterion_forward(_tree(_random_outputs(3), _t), tgt, CriterionConfig(num_classes=5))
    assert all(bool(torch.isfinite(v)) for v in losses.values())


# ---------------------------------------------------- (f) schedule, groups --


@pytest.mark.parametrize("epochs,steps,pct", [(3, 7, 0.1), (1, 5, 0.01), (2, 50, 0.3)])
def test_onecycle_matches_optax_at_every_step(epochs, steps, pct):
    """Every step of the schedule and past its end, rtol 1e-5 and atol
    1e-6 x peak: optax evaluates the cosine in float32, the port in float64,
    so they differ by float32 rounding of terms of the peak's size.
    (1, 5, 0.01) takes the one-warm-up-step guard."""
    from dfine_tpu.train.optim import OptimConfig as JCfg
    from dfine_tpu.train.optim import onecycle as jax_onecycle

    from dfine_tpu_torch.train.optim import OptimConfig, onecycle

    kw = dict(epochs=epochs, steps_per_epoch=steps, pct_start=pct)
    ours, ref = onecycle(5e-4, OptimConfig(**kw)), jax_onecycle(5e-4, JCfg(**kw))
    for count in range(epochs * steps + 3):
        np.testing.assert_allclose(ours(count), float(ref(count)), rtol=1e-5, atol=5e-10,
                                   err_msg=count)


def test_param_groups_match_jax_for_every_leaf():
    """Every port parameter gets the group JAX gives its flax path, and
    every JAX leaf is covered once (sizes n with the mask head: every
    leaf kind)."""
    from flax import traverse_util

    from dfine_tpu.train.optim import label_tree

    from dfine_tpu_torch.models.dfine import build_model
    from dfine_tpu_torch.train.optim import param_group_label
    from dfine_tpu_torch.utils.checkpoint import flax_key

    _, shapes = jax_template_shapes("n", 3, True)
    ref = traverse_util.flatten_dict(label_tree(shapes["params"]), sep="/")
    seen = set()
    for name, p in build_model("n", 3, True, device="cpu").named_parameters():
        path = flax_key(name, p.dim())[0][len("params/"):]
        assert param_group_label(name, p.dim()) == ref[path], name
        seen.add(path)
    assert seen == set(ref)
    assert set(ref.values()) == {"backbone", "backbone_norm", "encdec_norm_bias", "rest"}
