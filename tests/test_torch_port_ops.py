"""Port ops against the JAX package, on the CPU: box and FDR math, the
deformable-attention core and its gradients, the row scatter-add, and the
on-device preprocessing."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import test_torch_port_helpers  # noqa: F401  (thread count)
from test_torch_port_deform_cases import DEFORM_CASES, deform_case
from test_torch_port_scatter_cases import EDGE_CASES, scatter_case


def test_boxes_and_fdr_match_jax():
    """Elementwise fp32; tolerance: float32 rounding (1e-6 abs/rel)."""
    from dfine_tpu.ops import boxes as jb, fdr as jf
    from dfine_tpu_torch.ops import boxes as tb, fdr as tf

    rng = np.random.default_rng(0)
    box = rng.uniform(-0.1, 1.1, (7, 11, 4)).astype(np.float32)
    for jfn, tfn in ((jb.box_cxcywh_to_xyxy, tb.box_cxcywh_to_xyxy),
                     (jb.box_xyxy_to_cxcywh, tb.box_xyxy_to_cxcywh),
                     (jb.inverse_sigmoid, tb.inverse_sigmoid)):
        np.testing.assert_allclose(tfn(torch.from_numpy(box)).numpy(),
                                   np.asarray(jfn(jnp.asarray(box))), rtol=1e-6, atol=1e-6)

    for reg_max, up, reg_scale in ((32, 0.5, 4.0), (32, 0.5, 8.0), (16, 0.25, 4.0)):
        proj_j = np.asarray(jf.weighting_function(reg_max, up, reg_scale))
        proj_t = np.asarray(tf.weighting_function(reg_max, up, reg_scale), np.float32)
        np.testing.assert_allclose(proj_t, proj_j, rtol=1e-6, atol=1e-6)
        corners = rng.normal(size=(3, 5, 4 * (reg_max + 1))).astype(np.float32) * 3
        dist_j = np.asarray(jf.integral(jnp.asarray(corners), jnp.asarray(proj_j), reg_max))
        dist_t = tf.integral(torch.from_numpy(corners), torch.from_numpy(proj_t), reg_max)
        np.testing.assert_allclose(dist_t.numpy(), dist_j, rtol=1e-5, atol=1e-5)
        pts = rng.uniform(0.05, 0.95, (3, 5, 4)).astype(np.float32)
        np.testing.assert_allclose(
            tf.distance2bbox(torch.from_numpy(pts), dist_t, reg_scale).numpy(),
            np.asarray(jf.distance2bbox(jnp.asarray(pts), jnp.asarray(dist_j), reg_scale)),
            rtol=1e-5, atol=1e-6)


def _core_inputs(seed, b, q, h, d, shapes, pts):
    rng = np.random.default_rng(seed)
    sum_hw = sum(hh * ww for hh, ww in shapes)
    p = sum(pts)
    value = rng.normal(size=(b, sum_hw, h, d)).astype(np.float32)
    # out-of-bounds sampling locations included (zero-padding semantics)
    loc = rng.uniform(-0.15, 1.15, size=(b, q, h, p, 2)).astype(np.float32)
    logits = rng.normal(size=(b, q, h, p)).astype(np.float32)
    att = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    return value, loc, att.astype(np.float32)


@pytest.mark.parametrize("case", ["16", "32", *DEFORM_CASES])
def test_ms_deform_attn_core_plain_matches_jax(case):
    """fp32 gathers on both sides; tolerance 1e-5 (summation order). Cases
    "16" and "32": three levels at that head dim, locations uniform in
    [-0.15, 1.15]; the others are those of ``test_torch_port_deform_cases``
    (pixel edges and centres, one level, head dim 16 with points (6, 6))."""
    from dfine_tpu.ops.deform_attn import ms_deform_attn_core as jcore
    from dfine_tpu_torch.ops.deform_attn import ms_deform_attn, ms_deform_attn_core

    if case in ("16", "32"):
        shapes, pts = ((12, 10), (6, 5), (3, 3)), (3, 6, 3)
        value, loc, att = _core_inputs(1, 2, 17, 8, int(case), shapes, pts)
    else:
        value, shapes, loc, att, pts = deform_case(case)
    ref = np.asarray(jcore(jnp.asarray(value), shapes, jnp.asarray(loc), jnp.asarray(att), pts))
    args = (torch.from_numpy(value), shapes, torch.from_numpy(loc), torch.from_numpy(att), pts)
    np.testing.assert_allclose(ms_deform_attn_core(*args).numpy(), ref, rtol=1e-5, atol=1e-5)
    out = ms_deform_attn(args[0], shapes, args[2], args[3], pts)  # the Function, CPU path
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_ms_deform_attn_core_out_of_range_gives_exact_zeros():
    from dfine_tpu_torch.ops.deform_attn import ms_deform_attn_core

    shapes, pts = ((6, 5), (3, 3)), (2, 2)
    value, loc, att = _core_inputs(2, 1, 5, 2, 16, shapes, pts)
    loc = np.where(np.arange(2) == 0, -0.6, 1.7).astype(np.float32) * np.ones_like(loc)
    out = ms_deform_attn_core(torch.from_numpy(value), shapes, torch.from_numpy(loc),
                              torch.from_numpy(att), pts)
    assert torch.count_nonzero(out) == 0


def test_ms_deform_attn_core_grads_match_jax_pallas_backward():
    """Grads of MSDeformAttnCore (CPU path: closed form + plain scatter)
    against jax.grad of ms_deform_attn_core_fused(scatter_impl="pallas",
    interpret=True); tolerances of test_pallas_scatter.py:69-78."""
    from dfine_tpu.ops.deform_attn import ms_deform_attn_core_fused
    from dfine_tpu_torch.ops.deform_attn import ms_deform_attn

    shapes, pts = ((6, 5), (3, 3)), (3, 2)
    value, loc, att = _core_inputs(1, 2, 9, 4, 8, shapes, pts)

    def loss_j(v, l, a):
        out = ms_deform_attn_core_fused(v, shapes, l, a, pts, interpret=True,
                                        scatter_impl="pallas")
        return (out ** 2).sum()

    g_ref = jax.grad(loss_j, argnums=(0, 1, 2))(jnp.asarray(value), jnp.asarray(loc),
                                                jnp.asarray(att))
    tv, tl, ta = (torch.from_numpy(a).requires_grad_() for a in (value, loc, att))
    loss_t = (ms_deform_attn(tv, shapes, tl, ta, pts) ** 2).sum()
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j(*map(jnp.asarray, (value, loc, att)))),
                               rtol=1e-6)
    loss_t.backward()
    for name, a, b in zip(("value", "loc", "att"), g_ref, (tv.grad, tl.grad, ta.grad)):
        scale = float(jnp.abs(a).max()) + 1e-9
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=2e-4 * scale,
                                   err_msg=f"grad {name}")


def _naive_scatter(idx, contrib, hw):
    ref = np.zeros((idx.shape[0], hw, contrib.shape[-1]), np.float32)
    for r in range(idx.shape[0]):
        valid = (idx[r] >= 0) & (idx[r] < hw)
        np.add.at(ref[r], idx[r][valid], contrib[r][valid])
    return ref


@pytest.mark.parametrize("case", ["random", *EDGE_CASES])
def test_rows_scatter_add_plain_matches_jax_and_numpy(case):
    """Against the Pallas kernel (interpret mode) and np.add.at; tolerance
    of test_pallas_scatter.py:24 (atol 1e-4, rtol 1e-5). The edge cases of
    ``test_torch_port_scatter_cases`` come at head dim 16."""
    from dfine_tpu.ops.pallas.scatter_rows import rows_scatter_add as jscatter
    from dfine_tpu_torch.ops.kernels.scatter_rows import rows_scatter_add, rows_scatter_add_plain

    if case == "random":
        rng = np.random.default_rng(0)
        bh, n, d, hw = 4, 1000, 32, 777
        idx = rng.integers(-1, hw, (bh, n)).astype(np.int32)
        contrib = rng.normal(size=(bh, n, d)).astype(np.float32)
    else:
        idx, contrib, hw = scatter_case(case, 16)
        bh, n, d = contrib.shape
    ours = rows_scatter_add(torch.from_numpy(idx), torch.from_numpy(contrib), hw).numpy()
    np.testing.assert_allclose(ours, _naive_scatter(idx, contrib, hw), atol=1e-4, rtol=1e-5)
    ref_j = np.asarray(jscatter(jnp.asarray(idx), jnp.asarray(contrib), hw, interpret=True))
    np.testing.assert_allclose(ours, ref_j, atol=1e-4, rtol=1e-5)

    dropped = np.full((bh, n), -1, np.int32)
    out = rows_scatter_add_plain(torch.from_numpy(dropped), torch.from_numpy(contrib), hw)
    assert out.shape == (bh, hw, d) and torch.count_nonzero(out) == 0


@pytest.mark.parametrize("src_hw,out_hw", [((720, 1280), (320, 320)), ((96, 80), (320, 320))])
def test_preprocess_plain_matches_jax(src_hw, out_hw):
    """Downscale and upscale; tolerance 1e-5 on [0, 1] values (float32
    interpolation weights computed in a different order)."""
    from dfine_tpu.ops.preprocess import preprocess_plain as jprep
    from dfine_tpu_torch.ops.preprocess import preprocess_plain

    raw = np.random.default_rng(3).integers(0, 256, (2, *src_hw, 3), dtype=np.uint8)
    ref = np.asarray(jprep(jnp.asarray(raw), out_hw))  # NHWC
    ours = preprocess_plain(torch.from_numpy(raw), out_hw).numpy().transpose(0, 2, 3, 1)
    np.testing.assert_allclose(ours, ref, atol=1e-5, rtol=0)
