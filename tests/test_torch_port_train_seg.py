"""The det+seg train path of the port against the JAX package on the CPU,
fp32, at size n, 320 px, batch 2, G = 4 slots, every weight re-drawn from a
numpy seed: the train-mode outputs of the lazy mask head (``mask_feat``,
every set's ``mask_embed``, the pixel decoder's BatchNorm statistics), the
criterion with the ``masks`` loss on identical outputs (GT masks at the mask
head's size and at another, so that the nearest resize runs), and one whole
det+seg ``make_train_step``. Both sides get the same CDN noise.
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
MASK_HW = (IMG // 8, IMG // 8)  # n: the first level is stride 16, the mask head twice it
DN_KEY_SEED = 5
_CACHE = {}


@pytest.fixture(scope="module")
def setup():
    if not _CACHE:
        jmodel, shapes = jax_template_shapes(SIZE, NUM_CLASSES, True, IMG)
        _CACHE.update(jmodel=jmodel, variables=random_variables(shapes, seed=23))
    yield _CACHE
    _CACHE.clear()


@pytest.fixture
def fixed_dn_key(monkeypatch):
    return patch_jax_dn_key(monkeypatch, DN_KEY_SEED, B, G, NUM_CLASSES)


def ellipse_masks(boxes: np.ndarray, valid: np.ndarray, hw) -> np.ndarray:
    """[B, G, H, W] f32: the ellipse inscribed in each valid cxcywh box."""
    h, w = hw
    y = (np.arange(h) + 0.5)[:, None] / h
    x = (np.arange(w) + 0.5)[None, :] / w
    cx, cy, bw, bh = (boxes[..., i][..., None, None] for i in range(4))
    inside = ((x - cx) / (bw / 2)) ** 2 + ((y - cy) / (bh / 2)) ** 2 <= 1.0
    return (inside & valid[..., None, None]).astype(np.float32)


def _batch(seed=4, mask_hw=MASK_HW):
    rng = np.random.default_rng(seed)
    images = rng.uniform(size=(B, IMG, IMG, 3)).astype(np.float32)
    valid = np.asarray([[1, 1, 1, 0], [1, 1, 0, 0]], bool)
    targets = {"labels": rng.integers(0, NUM_CLASSES, (B, G)).astype(np.int32),
               "boxes": rng.uniform(0.25, 0.6, (B, G, 4)).astype(np.float32),
               "valid": valid,
               "mask_valid": valid & np.asarray([[1, 0, 1, 1], [1, 1, 1, 1]], bool)}
    targets["masks"] = ellipse_masks(targets["boxes"], valid, mask_hw)
    return images, targets


def _torch_batch(images, targets):
    return (torch.from_numpy(images.transpose(0, 3, 1, 2).copy()),
            {k: torch.from_numpy(v.copy()) for k, v in targets.items()})


def test_train_mode_mask_outputs_match_jax(setup, fixed_dn_key):
    """The pixel decoder in train mode on the port's own inputs against the
    JAX pixel decoder on the same inputs, atol 1e-5, rtol 1e-4. The whole
    model's ``mask_feat`` (JAX NHWC to NCHW) atol 1e-4, rtol 1e-3, but for
    at most 1e-5 of its elements (2 of 819200), which stay within 5e-4: the
    train-mode BatchNorms at batch 2 carry the backbone's and encoder's
    rounding differences into the decoder's inputs, and the pixel decoder's
    own BatchNorms scale them up. The ``mask_embed`` of the final and aux
    sets aligned by box on the final layer (>= 98 % of queries matched 1:1),
    of the DN sets in their fixed order, atol 2e-3, rtol 1e-2; the
    BatchNorm statistics the forward updated, the pixel decoder's
    included, atol 1e-5, rtol 1e-4. No set carries [B, Q, Hm, Wm] logits."""
    from dfine_tpu.models.decoder import MaskPixelDecoder

    jmodel, variables = setup["jmodel"], setup["variables"]
    images, targets = _batch()
    ref, mutated = jax.jit(lambda v, x, t: jmodel.apply(
        v, x, t, train=True, rngs={"dn": jax.random.key(0)}, mutable=["batch_stats"]))(
        variables, jnp.asarray(images), jax.tree.map(jnp.asarray, targets))
    port = port_model_from(variables, SIZE, NUM_CLASSES, True).train()
    x, tgt = _torch_batch(images, targets)
    seen = {}
    port.decoder.pixel_decoder.register_forward_hook(
        lambda mod, inp, out: seen.update(feats=inp[0], enc=inp[1], out=out))
    with torch.no_grad():
        ours = port(x, tgt, dn_noise=fixed_dn_key)

    nhwc = lambda t: jnp.asarray(t.numpy().transpose(0, 2, 3, 1))  # noqa: E731
    pd = {k: variables[k]["decoder"]["pixel_decoder"] for k in ("params", "batch_stats")}
    alone, _ = MaskPixelDecoder(256).apply(pd, [nhwc(f) for f in seen["feats"]],
                                           nhwc(seen["enc"]), True, mutable=["batch_stats"])
    np.testing.assert_allclose(seen["out"].numpy(), np.asarray(alone).transpose(0, 3, 1, 2),
                               atol=1e-5, rtol=1e-4)
    jfeat = np.asarray(ref["mask_feat"]).transpose(0, 3, 1, 2)
    diff = np.abs(ours["mask_feat"].numpy() - jfeat)
    assert (diff > 1e-4 + 1e-3 * np.abs(jfeat)).mean() <= 1e-5 and diff.max() <= 5e-4, diff.max()
    assert tuple(ours["mask_feat"].shape[2:]) == MASK_HW
    tol = dict(atol=2e-3, rtol=1e-2)
    main = [(ref, ours)] + list(zip(ref["aux_outputs"], ours["aux_outputs"]))
    dn = list(zip(ref["dn_outputs"], ours["dn_outputs"]))
    assert len(main) == len(dn) == port.decoder.num_layers
    for r, o in main + dn:
        assert "mask_embed" in o and "pred_masks" not in o
    for bi in range(B):
        match, keep = align_by_box(np.asarray(ref["pred_boxes"])[bi],
                                   ours["pred_boxes"][bi].numpy())
        assert keep.mean() >= 0.98, f"only {keep.mean():.3f} of queries matched 1:1"
        for r, o in main:
            np.testing.assert_allclose(o["mask_embed"][bi].numpy()[match[keep]],
                                       np.asarray(r["mask_embed"])[bi][keep], **tol)
    for r, o in dn:
        np.testing.assert_allclose(o["mask_embed"].numpy(), np.asarray(r["mask_embed"]), **tol)
    view = port_view(port, {"params": variables["params"], **mutated})
    stats = [k for k in port.state_dict() if k.endswith(("running_mean", "running_var"))]
    assert sum("pixel_decoder" in k for k in stats) == 2 * (len(seen["feats"]) + 2)
    for key in stats:
        np.testing.assert_allclose(port.state_dict()[key].numpy(), view[key], atol=1e-5,
                                   rtol=1e-4, err_msg=key)


@pytest.mark.parametrize("gt_hw", [(12, 14), (7, 9)], ids=["head_size", "resized"])
@pytest.mark.parametrize("seed", [0, 1])
def test_criterion_with_masks_matches_jax(seed, gt_hw):
    """criterion_forward with ``masks`` on identical outputs (mask head
    12 x 14): the same loss names, each term at rtol 1e-4 (atol 1e-6). With
    masks on, the last DN layer leaves the vfl/boxes/FGL/DDF DN sets and is
    supervised for masks alone as ``_dn_final``."""
    from dfine_tpu.train.criterion import CriterionConfig as JCfg
    from dfine_tpu.train.criterion import criterion_forward as jax_criterion

    from dfine_tpu_torch.train.criterion import CriterionConfig, criterion_forward

    out = random_outputs(seed, masks=(16, 12, 14))
    tgt = random_targets(seed + 10)
    rng = np.random.default_rng(seed)
    tgt["masks"] = (rng.uniform(size=(2, 4, *gt_hw)) < 0.4).astype(np.float32)
    tgt["mask_valid"] = tgt["valid"] & np.asarray([[1, 1, 0, 1], [1, 1, 1, 1]], bool)
    losses = ("vfl", "boxes", "local", "masks")
    static = {k: out.pop(k) for k in ("dn_meta", "enc_meta")}
    jout = map_tree(out, jnp.asarray)
    jout["mask_feat"] = jnp.asarray(out["mask_feat"].transpose(0, 2, 3, 1))  # NHWC
    ref = jax.jit(lambda o, t: jax_criterion({**o, **static}, t,
                                             JCfg(num_classes=5, losses=losses)))(
        jout, map_tree(tgt, jnp.asarray))
    out.update(static)
    ours = criterion_forward(map_tree(out, torch.from_numpy), map_tree(tgt, torch.from_numpy),
                             CriterionConfig(num_classes=5, losses=losses))
    assert set(ours) == set(ref)
    n_dn = len(out["dn_outputs"])
    assert {"loss_mask_bce_dn_final", "loss_mask_dice_dn_final",
            f"loss_mask_bce_dn_{n_dn - 2}", "loss_mask_bce_aux_1"} <= set(ours)
    last = f"_dn_{n_dn - 1}"
    assert not [k for k in ours if k.endswith(last)]
    for k, v in ref.items():
        np.testing.assert_allclose(float(ours[k]), float(v), rtol=1e-4, atol=1e-6, err_msg=k)


def test_seg_train_step_matches_jax(setup, fixed_dn_key):
    """One det+seg step of both (losses vfl, boxes, local, masks; GT
    ellipses at the mask head's size, one valid box without a mask), same
    weights, batch and DN noise, by the rules of ``check_step``: every
    metric (the mask terms included), the updated parameters, BatchNorm
    statistics and EMA, and AdamW's first moment leaf by leaf, the pixel
    decoder's and the mask head's included."""
    from dfine_tpu.train.criterion import CriterionConfig as JCrit
    from dfine_tpu.train.optim import OptimConfig as JOpt
    from dfine_tpu.train.optim import build_optimizer as jax_optimizer
    from dfine_tpu.train.train_step import TrainState as JState
    from dfine_tpu.train.train_step import make_train_step as jax_step

    from dfine_tpu_torch.train.criterion import CriterionConfig
    from dfine_tpu_torch.train.optim import OptimConfig, build_optimizer
    from dfine_tpu_torch.train.train_step import TrainState, make_train_step

    jmodel, variables = setup["jmodel"], setup["variables"]
    images, targets = _batch()
    losses = ("vfl", "boxes", "local", "masks")
    tx = jax_optimizer(variables["params"], JOpt())
    jstate, jmetrics = jax.jit(jax_step(jmodel, tx, JCrit(num_classes=NUM_CLASSES,
                                                          losses=losses)))(
        JState.create(variables, tx), {"images": jnp.asarray(images),
                                       "targets": jax.tree.map(jnp.asarray, targets)},
        jax.random.key(0))

    port = port_model_from(variables, SIZE, NUM_CLASSES, True)
    state = TrainState.create(port, build_optimizer(port, OptimConfig()))
    x, tgt = _torch_batch(images, targets)
    step = make_train_step(CriterionConfig(num_classes=NUM_CLASSES, losses=losses),
                           compute_dtype=torch.float32)
    state, metrics = step(state, {"images": x, "targets": tgt}, dn_noise=fixed_dn_key)
    assert {"loss_mask_bce", "loss_mask_dice"} <= set(metrics)
    check_step(port, state, metrics, jstate, jmetrics, port_view(port, variables))
    mask_params = [k for k, _ in port.named_parameters()
                   if "pixel_decoder" in k or "mask_head" in k]
    assert mask_params and all(port.get_parameter(k) in state.optimizer.adamw.state
                               for k in mask_params)
