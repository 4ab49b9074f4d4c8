"""The port's backbone, encoder and whole model (eval, fp32) against the JAX
package at sizes n and s, 320 px, and x, 160 px (the only size with a
conv + BatchNorm ``input_proj``, B5 and AIFI at head dim 48; the smaller
image keeps its JAX compile short), with every weight re-drawn from a
numpy seed and carried over by the weight bridge."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_port_helpers import (align_by_box, jax_template_shapes, port_model_from,
                                     random_variables)

IMG = {"n": 320, "s": 320, "x": 160}
NUM_CLASSES = 5
_CACHE = {}


def _setup(size, mask_head):
    key = (size, mask_head)
    if key not in _CACHE:
        jmodel, shapes = jax_template_shapes(size, NUM_CLASSES, mask_head, IMG[size])
        variables = random_variables(shapes, seed=17)
        port = port_model_from(variables, size, NUM_CLASSES, mask_head)
        _CACHE[key] = (jmodel, variables, port)
    return _CACHE[key]


@pytest.fixture(scope="module", autouse=True)
def _drop_cache():
    yield
    _CACHE.clear()


def _image(seed, img):
    return np.random.default_rng(seed).uniform(size=(1, img, img, 3)).astype(np.float32)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _sub_vars(variables, name):
    return {"params": variables["params"][name], "batch_stats": variables["batch_stats"][name]}


@pytest.mark.parametrize("size", ["n", "s", "x"])
def test_backbone_and_encoder_match_jax(size):
    """Features at atol 1e-4, rtol 1e-3 (test_torch_parity.py:107-109)."""
    from dfine_tpu.configs import model_config
    from dfine_tpu.models.hgnetv2 import HGNetv2
    from dfine_tpu.models.hybrid_encoder import HybridEncoder

    _, variables, port = _setup(size, False)
    cfg = model_config(size)
    bcfg, ecfg = cfg["backbone"], cfg["encoder"]
    x = _image(1, IMG[size])
    bb = HGNetv2(name_=bcfg["name"], use_lab=bcfg["use_lab"], return_idx=tuple(bcfg["return_idx"]))
    feats_j = jax.jit(lambda v, x: bb.apply(v, x, False))(_sub_vars(variables, "backbone"),
                                                          jnp.asarray(x))
    enc = HybridEncoder(
        in_channels=tuple(ecfg["in_channels"]), feat_strides=tuple(ecfg["feat_strides"]),
        hidden_dim=ecfg["hidden_dim"], nhead=ecfg["nhead"],
        dim_feedforward=ecfg["dim_feedforward"], enc_act=ecfg["enc_act"],
        use_encoder_idx=tuple(ecfg["use_encoder_idx"]),
        num_encoder_layers=ecfg["num_encoder_layers"], expansion=ecfg["expansion"],
        depth_mult=ecfg["depth_mult"], act=ecfg["act"])
    outs_j, inner_j = jax.jit(lambda v, f: enc.apply(v, f, False))(
        _sub_vars(variables, "encoder"), feats_j)

    with torch.no_grad():
        feats_t = port.backbone(_nchw(x))
        outs_t, inner_t = port.encoder(feats_t)
    for fj, ft in zip(feats_j, feats_t):
        np.testing.assert_allclose(ft.numpy(), np.asarray(fj).transpose(0, 3, 1, 2),
                                   atol=1e-4, rtol=1e-3)
    for fj, ft in zip(list(outs_j) + list(inner_j), list(outs_t) + list(inner_t)):
        np.testing.assert_allclose(ft.numpy(), np.asarray(fj).transpose(0, 3, 1, 2),
                                   atol=1e-4, rtol=1e-3)


@pytest.mark.parametrize("size,mask_head", [("n", False), ("n", True), ("s", False), ("s", True),
                                            ("x", True)])
def test_model_matches_jax(size, mask_head):
    """Queries aligned by box (>= 98% matched 1:1); matched boxes atol 5e-4,
    logits atol 2e-3 (test_torch_parity.py:80-83); masks atol 1e-3."""
    jmodel, variables, port = _setup(size, mask_head)
    x = _image(2, IMG[size])
    ref = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(variables, jnp.asarray(x))
    with torch.no_grad():
        ours = port(_nchw(x))

    rb, ob = np.asarray(ref["pred_boxes"])[0], ours["pred_boxes"].numpy()[0]
    match, keep = align_by_box(rb, ob)
    assert keep.mean() >= 0.98, f"only {keep.mean():.3f} of queries matched 1:1"
    np.testing.assert_allclose(ob[match[keep]], rb[keep], atol=5e-4, rtol=1e-3)
    np.testing.assert_allclose(ours["pred_logits"].numpy()[0][match[keep]],
                               np.asarray(ref["pred_logits"])[0][keep], atol=2e-3, rtol=1e-2)
    assert ("pred_masks" in ours) == mask_head
    if mask_head:
        np.testing.assert_allclose(ours["pred_masks"].numpy()[0][match[keep]],
                                   np.asarray(ref["pred_masks"])[0][keep], atol=1e-3)


@pytest.mark.parametrize("size", ["n", "s", "m", "l", "x"])
def test_mask_head_wiring_at_every_size(size):
    """Shapes only (meta tensors, nothing is computed): the encoder's FPN
    maps feed the pixel decoder at every published size; at x the encoder
    (384) is wider than the decoder (256)."""
    from dfine_tpu_torch.configs import model_config
    from dfine_tpu_torch.models.dfine import DFINE

    stride0 = model_config(size)["decoder"]["feat_strides"][0]
    with torch.device("meta"):
        model = DFINE(size, 80, enable_mask_head=True)
        outs, inner = model.encoder(model.backbone(torch.empty(1, 3, 640, 640)))
        mem0 = model.decoder.input_proj[0](outs[0])
        mask_feat = model.decoder.pixel_decoder(inner, mem0)
    assert tuple(mask_feat.shape) == (1, 256, 2 * 640 // stride0, 2 * 640 // stride0)
