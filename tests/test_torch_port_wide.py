"""The widened decoder tail (``decoder.layer_scale`` 2) of the port against
the JAX package on the CPU, fp32, at
size n, 320 px, with every JAX leaf re-drawn from a numpy seed and bridged
(``test_torch_port_helpers``' model variants):

- ``layer_scale=2, eval_idx=1, num_denoising=0``: the widened parameter
  shapes, the train-mode outputs (every aux set, aligned by box), one whole
  train step (``check_step``) and the eval outputs after it. At n the wide
  layer's head dim is 256 / 8 = 32;
- head dim 64, the wide layer of s/m/l/x: ``MSDeformableAttention`` at
  width 512 over 8 heads, and the deformable core with its backward through
  each value-gradient scatter, against JAX (the Pallas kernels in interpret
  mode); the scatters at D = 64 on the shared edge cases.

The extra pyramid levels are held in ``test_torch_port_extra_level``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_port_helpers import (NO_LAB, VARIANT_CLASSES, VARIANT_IMG, VARIANT_SIZE,
                                     all_sets, compare_sets, jax_template_shapes,
                                     port_model_from, port_view, random_variables, torch_batch,
                                     variant_batch, variant_step_against_jax)
from test_torch_port_scatter_cases import EDGE_CASES, scatter_case

WIDE = (("decoder.layer_scale", 2), ("decoder.eval_idx", 1), ("decoder.num_denoising", 0))


def _variant(overrides):
    jmodel, shapes = jax_template_shapes(VARIANT_SIZE, VARIANT_CLASSES, False, VARIANT_IMG,
                                         overrides)
    return jmodel, random_variables(shapes, seed=31)


def test_wide_tail_parameters_and_train_outputs_match_jax():
    """The bridge is strict, so every widened tensor has JAX's shape; the
    layer past ``eval_idx`` holds d = 256 and FFN 1024 (test_model_forward.py
    :105-108), its box head 256 inputs, the LQEs and ``pre_bbox_head`` stay
    at 128. Train mode (no CDN: ``num_denoising`` 0) runs the wide tail: the
    final set comes from the wide layer; every set within SET_TOL of JAX's,
    aligned by box; the updated BatchNorm statistics atol 1e-5, rtol 1e-4."""
    jmodel, variables = _variant(WIDE)
    port = port_model_from(variables, VARIANT_SIZE, VARIANT_CLASSES, False, WIDE).train()
    layers = port.decoder.decoder.layers
    assert layers[1].linear1.weight.shape == (512, 128)
    assert layers[2].linear1.weight.shape == (1024, 256)
    assert layers[2].cross_attn.embed_dim == 256
    assert port.decoder.dec_bbox_head[2].layers[0].weight.shape[1] == 256
    assert port.decoder.dec_score_head[2].weight.shape == (VARIANT_CLASSES, 256)
    assert port.decoder.pre_bbox_head.layers[0].weight.shape == (128, 128)

    images, targets = variant_batch()
    ref, mutated = jax.jit(lambda v, x, t: jmodel.apply(
        v, x, t, train=True, rngs={"dn": jax.random.key(0)}, mutable=["batch_stats"]))(
        variables, jnp.asarray(images), jax.tree.map(jnp.asarray, targets))
    x, tgt = torch_batch(images, targets)
    with torch.no_grad():
        ours = port(x, tgt)
    assert "dn_outputs" not in ours and len(ours["aux_outputs"]) == 2
    compare_sets(ref, ours, all_sets)
    view = port_view(port, {"params": variables["params"], **mutated})
    for key, t in port.state_dict().items():
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(t.numpy(), view[key], atol=1e-5, rtol=1e-4, err_msg=key)


def test_wide_tail_train_step_matches_jax():
    """``layer_scale`` 2, no LAB (``NO_LAB``): one step against the JAX
    step by ``check_step``'s rules, so the gradients reach the wide layer
    (more than 90 % of all tensors move), then the eval outputs (eval stops
    at ``eval_idx`` and never runs the tail)."""
    overrides = WIDE + NO_LAB
    jmodel, variables = _variant(overrides)
    port = variant_step_against_jax(jmodel, variables, overrides)
    wide = port.decoder.decoder.layers[2]
    before = port_view(port, variables)
    moved = [k for k, p in wide.named_parameters()
             if not np.array_equal(p.detach().numpy(), before[f"decoder.decoder.layers.2.{k}"])]
    assert len(moved) == len(list(wide.parameters())), moved


def test_wide_tail_serves_and_deploys(tmp_path):
    """``TorchModel`` with ``cfg_overrides`` takes a wide model's weights
    (``.npz``, strict: the tail's tensors included) and serves eval, which
    stops at ``eval_idx``: its outputs equal those of the port model under
    the same serving fold on the same input (bit-equal: the same layers and
    folded weights), and lie within SET_TOL of the unfused port model's
    outputs, aligned by box (the fold reorders f32 sums, and top-k may then
    order near-tied queries otherwise)."""
    import copy

    from dfine_tpu_torch import TorchModel
    from dfine_tpu_torch.infer.fuse import fold_for_serving
    from dfine_tpu_torch.infer.torch_model import decode
    from dfine_tpu_torch.utils.checkpoint import port_variables

    _, variables = _variant(WIDE)
    port = port_model_from(variables, VARIANT_SIZE, VARIANT_CLASSES, False, WIDE)
    npz = tmp_path / "wide.npz"
    np.savez(npz, **port_variables(port))
    x = torch.from_numpy(variant_batch(9)[0][:1].transpose(0, 3, 1, 2).copy())
    served = TorchModel(VARIANT_SIZE, str(npz), VARIANT_CLASSES, VARIANT_IMG, VARIANT_IMG,
                        half=False, device="cpu", cfg_overrides=WIDE)
    with torch.no_grad():
        out = served.model(x)
        ref = fold_for_serving(copy.deepcopy(port), torch.float32)(x)
        for k in ref:
            assert torch.equal(out[k], ref[k]), k
        assert decode(served.model, x, 300)["boxes"].shape == (1, 300, 4)
        unfused = {k: v.numpy() for k, v in port(x).items()}
    compare_sets(unfused, out)


# ---------------------------------------------------------- head dim 64 --


def test_wide_deformable_attention_at_head_dim_64():
    """``MSDeformableAttention`` of width 512 over 8 heads (the wide layer
    of s/m/l/x at ``layer_scale`` 2) against JAX's, its parameters re-drawn
    from a seed: outputs within 1e-5 (fp32 gathers in another order)."""
    from dfine_tpu.models.decoder import MSDeformableAttention as JAttn

    from dfine_tpu_torch.models.decoder import MSDeformableAttention

    d_model, heads, pts = 512, 8, (3, 6, 3)
    shapes = ((12, 10), (6, 5), (3, 3))
    rng = np.random.default_rng(2)
    s = sum(h * w for h, w in shapes)
    query = rng.normal(size=(2, 11, d_model)).astype(np.float32)
    ref_pts = np.concatenate([rng.uniform(0.1, 0.9, (2, 11, 2)),
                              rng.uniform(0.05, 0.4, (2, 11, 2))], -1).astype(np.float32)
    value = rng.normal(size=(2, s, heads, d_model // heads)).astype(np.float32)
    jm = JAttn(d_model, heads, len(shapes), pts)
    shp = jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.asarray(query),
                                         jnp.asarray(ref_pts), jnp.asarray(value), shapes))
    params = random_variables(shp, seed=3)
    ref = np.asarray(jm.apply(params, jnp.asarray(query), jnp.asarray(ref_pts),
                              jnp.asarray(value), shapes))
    ours_m = MSDeformableAttention(d_model, heads, pts)
    with torch.no_grad():
        for name in ("sampling_offsets", "attention_weights"):
            lin = getattr(ours_m, name)
            lin.weight.copy_(torch.from_numpy(params["params"][name]["kernel"].T.copy()))
            lin.bias.copy_(torch.from_numpy(params["params"][name]["bias"]))
        ours = ours_m(*(torch.from_numpy(a) for a in (query, ref_pts, value)), shapes)
    assert ours.shape == (2, 11, d_model)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-5, atol=1e-5)


def _core_inputs(seed, b, q, h, d, shapes, pts):
    rng = np.random.default_rng(seed)
    s = sum(hh * ww for hh, ww in shapes)
    value = rng.normal(size=(b, s, h, d)).astype(np.float32)
    loc = rng.uniform(-0.15, 1.15, size=(b, q, h, sum(pts), 2)).astype(np.float32)
    logits = rng.normal(size=(b, q, h, sum(pts)))
    att = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    return value, loc, att.astype(np.float32)


@pytest.mark.parametrize("impl", ["pallas", "mxu", "tiled"])
def test_core_and_backward_at_head_dim_64_match_jax(impl):
    """The core at D = 64 and its gradients through each scatter against
    ``jax.grad`` of ``ms_deform_attn_core_fused(scatter_impl=impl,
    interpret=True)``: the loss within rtol 1e-6; location, attention and
    (f32 payload) value gradients within 2e-4 of the largest
    (test_pallas_scatter.py:69-78); with the bf16 payload both sides round
    each contribution once, and the value gradients agree within 1e-3 of
    the largest (f32 sums of the same rounded terms in another order)."""
    from dfine_tpu.ops.deform_attn import ms_deform_attn_core_fused

    from dfine_tpu_torch.ops import deform_attn as tda

    shapes, pts = ((6, 5), (3, 3)), (3, 2)
    value, loc, att = _core_inputs(1, 2, 9, 8, 64, shapes, pts)

    def loss_j(v, l, a):
        out = ms_deform_attn_core_fused(v, shapes, l, a, pts, interpret=True, scatter_impl=impl)
        return (out ** 2).sum()

    g_ref = jax.grad(loss_j, argnums=(0, 1, 2))(jnp.asarray(value), jnp.asarray(loc),
                                                jnp.asarray(att))
    tv, tl, ta = (torch.from_numpy(a).requires_grad_() for a in (value, loc, att))
    tda.set_deform_bwd(impl)
    try:
        loss_t = (tda.ms_deform_attn(tv, shapes, tl, ta, pts) ** 2).sum()
        loss_t.backward()
    finally:
        tda.set_deform_bwd("pallas")
    np.testing.assert_allclose(float(loss_t.detach()),
                               float(loss_j(*map(jnp.asarray, (value, loc, att)))), rtol=1e-6)
    for name, a, b in zip(("value", "loc", "att"), g_ref, (tv.grad, tl.grad, ta.grad)):
        scale = float(jnp.abs(a).max()) + 1e-9
        rel = 1e-3 if (name == "value" and impl != "pallas") else 2e-4
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=rel * scale,
                                   err_msg=f"grad {name}")


@pytest.mark.parametrize("impl", ["pallas", "mxu", "tiled"])
@pytest.mark.parametrize("case", EDGE_CASES)
def test_scatters_at_head_dim_64_match_jax(case, impl):
    """Each scatter's CPU path at D = 64 on the shared edge cases against
    the Pallas kernel it replaces (interpret mode): f32 payload atol 1e-4,
    rtol 1e-5 (test_pallas_scatter.py:24); the bf16 forms atol 1e-5, rtol
    1e-6 (test_pallas_scatter.py:48, :165), bit-equal to np.add.at of the
    rounded payload."""
    from dfine_tpu.ops.pallas import scatter_rows as jsr

    from dfine_tpu_torch.ops.kernels import scatter_rows as tsr

    idx, contrib, hw = scatter_case(case, 64, seed=2)
    jfn = {"pallas": jsr.rows_scatter_add, "mxu": jsr.rows_scatter_add_mxu,
           "tiled": jsr.rows_scatter_add_tiled}[impl]
    ref = np.asarray(jfn(jnp.asarray(idx), jnp.asarray(contrib), hw, interpret=True))
    fn = {"pallas": tsr.rows_scatter_add, "mxu": tsr.rows_scatter_add_mxu,
          "tiled": tsr.rows_scatter_add_tiled}[impl]
    ours = fn(torch.from_numpy(idx), torch.from_numpy(contrib), hw).numpy()
    assert ours.shape == (idx.shape[0], hw, 64)
    if impl == "pallas":
        np.testing.assert_allclose(ours, ref, atol=1e-4, rtol=1e-5)
        return
    np.testing.assert_allclose(ours, ref, atol=1e-5, rtol=1e-6)
    rounded = np.asarray(jnp.asarray(contrib).astype(jnp.bfloat16), np.float32)
    naive = np.zeros_like(ours)
    for r in range(idx.shape[0]):
        keep = (idx[r] >= 0) & (idx[r] < hw)
        np.add.at(naive[r], idx[r][keep], rounded[r][keep])
    np.testing.assert_array_equal(ours, naive)
