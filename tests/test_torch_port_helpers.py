"""Shared helpers of the port's parity tests (``test_torch_port_*``).

The port is held against the JAX package on the same inputs: data is made
with numpy from a seed and handed to both; JAX stays on the CPU. The JAX
template comes from a train-mode ``eval_shape`` (no compile), so every head
exists, and every leaf is re-drawn from a numpy seed: the JAX zero inits
(sampling offsets, attention weights, gate, the ``zero_last`` heads) would
otherwise make the decoder trivial. This file holds no tests.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

import jax
import jax.numpy as jnp

torch.set_num_threads(2)  # xdist runs several workers side by side


def jax_template_shapes(size: str, num_classes: int, mask_head: bool, img: int = 320,
                        cfg_overrides=()):
    """ShapeDtypeStruct tree of a train-mode init of the JAX DFINE."""
    from dfine_tpu.models import build_model

    model = build_model(size, num_classes=num_classes, enable_mask_head=mask_head,
                        cfg_overrides=cfg_overrides)
    g = 4
    x = jnp.zeros((1, img, img, 3), jnp.float32)
    tgt = {
        "labels": jnp.zeros((1, g), jnp.int32),
        "boxes": jnp.full((1, g, 4), 0.5, jnp.float32),
        "valid": jnp.ones((1, g), bool),
    }
    if mask_head:
        tgt["masks"] = jnp.zeros((1, g, img // 4, img // 4), jnp.float32)
        tgt["mask_valid"] = tgt["valid"]
    rngs = {"params": jax.random.key(0), "dn": jax.random.key(1)}
    return model, jax.eval_shape(lambda: model.init(rngs, x, tgt, train=True))


def random_variables(shapes, seed: int):
    """Every leaf re-drawn from numpy: kernels U(+-1/sqrt(fan_in)), biases
    U(+-0.1), norm scales U(0.8, 1.2), BN means N(0, 0.1), variances
    U(0.5, 1.5), embeddings N(0, 1)."""
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = jax.tree_util.keystr(path)
        shape = s.shape
        if name.endswith("['mean']"):
            v = rng.normal(0.0, 0.1, shape)
        elif name.endswith("['var']"):
            v = rng.uniform(0.5, 1.5, shape)
        elif name.endswith("['scale']"):
            v = rng.uniform(0.8, 1.2, shape)
        elif name.endswith("['embedding']"):
            v = rng.normal(0.0, 1.0, shape)
        elif name.endswith("['kernel']"):
            b = 1.0 / np.sqrt(int(np.prod(shape[:-1])))
            v = rng.uniform(-b, b, shape)
        else:
            v = rng.uniform(-0.1, 0.1, shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def port_model_from(variables, size: str, num_classes: int, mask_head: bool, cfg_overrides=()):
    from dfine_tpu_torch.models.dfine import build_model
    from dfine_tpu_torch.utils.checkpoint import load_jax_variables

    model = build_model(size, num_classes, mask_head, device="cpu", cfg_overrides=cfg_overrides)
    return load_jax_variables(model, variables)


def align_by_box(ref_boxes: np.ndarray, our_boxes: np.ndarray):
    """Top-k query selection may permute query order between frameworks
    (near-tied scores) while selecting the same set: align rows by box
    identity as tests/test_torch_parity.py:71-79 does. Returns (match,
    keep): ref row i <-> our row match[i], kept where the match is 1:1."""
    cost = np.abs(ref_boxes[:, None, :] - our_boxes[None, :, :]).sum(-1)
    match = cost.argmin(1)
    uniq, counts = np.unique(match, return_counts=True)
    dup = set(uniq[counts > 1].tolist())
    keep = np.asarray([m not in dup for m in match])
    return match, keep


def jax_cdn_noise(key, batch, max_gt, num_classes, num_denoising=100, ratio=0.5):
    """The four draws of dfine_tpu/models/denoising.py:79-92 from ``key``,
    as the port's CdnNoise."""
    from dfine_tpu_torch.models.denoising import CdnNoise

    d = 2 * max(1, num_denoising // max_gt) * max_gt
    k_label, k_new, k_sign, k_part = jax.random.split(key, 4)
    flip = jax.random.uniform(k_label, (batch, d)) < ratio * 0.5
    new_label = jax.random.randint(k_new, (batch, d), 0, num_classes, dtype=jnp.int32)
    sign = jax.random.randint(k_sign, (batch, d, 4), 0, 2).astype(jnp.float32) * 2.0 - 1.0
    part = jax.random.uniform(k_part, (batch, d, 4))
    flip, new_label, sign, part = (torch.from_numpy(np.array(a))
                                   for a in (flip, new_label, sign, part))
    return CdnNoise(flip, new_label.long(), sign, part)


def patch_jax_dn_key(monkeypatch, seed: int, batch: int, max_gt: int, num_classes: int):
    """Hand the JAX decoder's ``build_cdn_queries`` the key ``seed`` and
    return the same draws as the port's CdnNoise."""
    import dfine_tpu.models.decoder as jdec

    orig = jdec.build_cdn_queries
    monkeypatch.setattr(jdec, "build_cdn_queries", lambda labels, boxes, valid, rng, *a, **k:
                        orig(labels, boxes, valid, jax.random.key(seed), *a, **k))
    return jax_cdn_noise(jax.random.key(seed), batch, max_gt, num_classes)


def random_targets(seed, b=2, g=4, c=5, valid=((1, 1, 1, 0), (1, 0, 0, 0))):
    rng = np.random.default_rng(seed)
    return {"labels": rng.integers(0, c, (b, g)).astype(np.int32),
            "boxes": rng.uniform(0.2, 0.6, (b, g, 4)).astype(np.float32),
            "valid": np.asarray(valid, bool)}


def random_outputs(seed, b=2, q=24, c=5, g=4, n_aux=2, n_group=2, reg_max=32, masks=None,
                   enc_classes=None):
    """A train-mode output tree of numpy arrays: final, aux, pre, enc and the
    DN sets, with distinct random scores so the assignments are unique.
    ``masks`` = (mask_dim, Hm, Wm) adds the lazy mask head's ``mask_embed``
    to the final, aux and DN sets and its ``mask_feat`` (NCHW);
    ``enc_classes`` = 1 gives the class-agnostic encoder set."""
    rng = np.random.default_rng(seed)
    d = 2 * n_group * g

    def one(n, corners=True, classes=c):
        s = {"pred_logits": rng.normal(0, 2, (b, n, classes)).astype(np.float32),
             "pred_boxes": rng.uniform(0.15, 0.75, (b, n, 4)).astype(np.float32)}
        if corners:
            s["pred_corners"] = rng.normal(0, 1, (b, n, 4 * (reg_max + 1))).astype(np.float32)
            s["ref_points"] = ref_q if n == q else ref_d
            if masks is not None:
                s["mask_embed"] = rng.normal(0, 1, (b, n, masks[0])).astype(np.float32)
        return s

    ref_q = rng.uniform(0.2, 0.7, (b, q, 4)).astype(np.float32)
    ref_d = rng.uniform(0.2, 0.7, (b, d, 4)).astype(np.float32)
    out = one(q)
    out["aux_outputs"] = [one(q) for _ in range(n_aux)]
    out["pre_outputs"] = one(q, corners=False)
    out["enc_aux_outputs"] = [one(q, corners=False, classes=enc_classes or c)]
    out["enc_meta"] = {"class_agnostic": enc_classes == 1}
    out["dn_outputs"] = [one(d) for _ in range(n_aux + 1)]
    out["dn_pre_outputs"] = one(d, corners=False)
    out["dn_meta"] = {"dn_num_group": n_group, "dn_num_split": (d, q), "max_gt": g}
    if masks is not None:
        out["mask_feat"] = (rng.normal(0, 1, (b, *masks)) / np.sqrt(masks[0])).astype(np.float32)
    return out


def map_tree(x, fn):
    if isinstance(x, dict):
        return {k: map_tree(v, fn) for k, v in x.items()}
    if isinstance(x, list):
        return [map_tree(v, fn) for v in x]
    return fn(x) if isinstance(x, np.ndarray) else x


def port_view(model, variables):
    """Each port tensor's JAX counterpart (params and batch_stats) in the
    port's layout, by the weight bridge's name map."""
    from dfine_tpu_torch.utils.checkpoint import flatten, flax_key, jax_to_port

    flat = flatten(jax.tree.map(np.asarray, variables))
    out = {}
    for key, t in model.state_dict().items():
        if key.endswith("num_batches_tracked"):
            continue
        fkey, transform = flax_key(key, t.dim())
        module = model.get_submodule(key.rsplit(".", 1)[0])
        out[key] = jax_to_port(flat[fkey], transform, isinstance(module, torch.nn.ConvTranspose2d))
    return out


# The first moment after a step, leaf by leaf: the norm of the difference
# within this share of the norm of JAX's leaf. The backbone's gradients at
# random weights are ill-conditioned (a train-mode BatchNorm in every
# layer): the port and JAX differ by up to 1.7 % in the backbone's tensors
# and 9.2 % in its one-element LAB parameters, each one sum over a whole
# feature map; the encoder and decoder agree within 0.7 %.
MU_REL, MU_REL_SCALAR = 3e-2, 0.15
# A leaf is nought to rounding when the RMS of its gradient is under this
# share of the RMS over all leaves: the LAB and norm parameters whose effect
# a following train-mode BatchNorm removes, so that their gradients cancel.
MU_ROUNDING_SHARE = 5e-4


def _flat_first_moment(port, optimizer, opt_state, params, batch_stats):
    """The flat optimizers' first moments: JAX's ``FlatAdamWState.m``
    unravelled onto ``params`` in the port's layout, and the port's ``m``
    buffer cut into its trainable parameters."""
    from jax.flatten_util import ravel_pytree

    from dfine_tpu.train.flat_optim import FlatAdamWState

    is_flat = lambda x: isinstance(x, FlatAdamWState)  # noqa: E731
    m = next(s.m for s in jax.tree.leaves(opt_state, is_leaf=is_flat) if is_flat(s))
    view = port_view(port, {"params": ravel_pytree(params)[1](m), "batch_stats": batch_stats})
    ours, off = {}, 0
    for k, p in port.named_parameters():
        if p.requires_grad:
            ours[k] = optimizer.m[off: off + p.numel()].view_as(p).numpy()
        off += p.numel()
    return view, ours


def first_moment_agreement(port, optimizer, opt_state, batch_stats, params=None):
    """Per parameter of the port with a first moment, ||m - m_jax|| /
    ||m_jax|| of AdamW's ``exp_avg`` against optax's ``mu`` (with the flat
    optimizer, ``build_optimizer(flat=True)``: its ``m`` buffer against the
    JAX flat state's, unravelled onto ``params``; the frozen parameters,
    ``requires_grad`` off, left out), and the parameters exempted as nought
    to rounding, with their norms."""
    import optax
    from flax import traverse_util

    if hasattr(optimizer, "grad_flat"):
        view, ours = _flat_first_moment(port, optimizer, opt_state, params, batch_stats)
        params = {k: port.get_parameter(k) for k in ours}
        mu_of = ours.__getitem__
    else:
        mu = {}
        is_adam = lambda x: isinstance(x, optax.ScaleByAdamState)  # noqa: E731
        for s in jax.tree.leaves(opt_state, is_leaf=is_adam):
            if is_adam(s):
                mu.update({k: v for k, v in traverse_util.flatten_dict(s.mu).items()
                           if not isinstance(v, optax.MaskedNode)})
        view = port_view(port, {"params": traverse_util.unflatten_dict(mu),
                                "batch_stats": batch_stats})
        params = {k: p for k, p in port.named_parameters() if p in optimizer.adamw.state}
        mu_of = lambda k: optimizer.adamw.state[params[k]]["exp_avg"].numpy()  # noqa: E731
    norms = {k: float(np.linalg.norm(view[k])) for k in params}
    rms_all = np.sqrt(sum(n * n for n in norms.values()) / sum(p.numel() for p in params.values()))
    rel, exempt = {}, {}
    for k, p in params.items():
        if norms[k] / np.sqrt(p.numel()) < MU_ROUNDING_SHARE * rms_all:
            exempt[k] = norms[k]
            continue
        rel[k] = float(np.linalg.norm(mu_of(k) - view[k])) / norms[k]
    return rel, exempt


def check_step(port, state, metrics, jstate, jmetrics, before, frozen=(), lr=2e-5):
    """A port train step against the JAX step from the same weights
    (``before``, the port's view of the JAX variables), by the rules of
    ``test_train_step_matches_jax``: every metric at rtol 1e-4 (grad_norm
    1e-3); the updated BatchNorm statistics, of the model and of the EMA,
    atol 1e-5, rtol 1e-4; AdamW's first step moves a parameter by about
    ``lr``, so every parameter element and EMA element within 2 lr + 2e-6 of
    JAX's and 99.5 % of them within 2e-6; more than 90 % of the trainable
    tensors moved, each of ``frozen`` bit-unchanged; AdamW's first moment
    leaf by leaf within MU_REL (MU_REL_SCALAR for one-element leaves) but
    for the leaves nought to rounding (norm and LAB kinds, at most a tenth)."""
    assert set(metrics) == set(jmetrics), set(metrics) ^ set(jmetrics)
    for k, v in jmetrics.items():
        rtol = 1e-3 if k == "grad_norm" else 1e-4
        np.testing.assert_allclose(float(metrics[k]), float(v), rtol=rtol, err_msg=k)
    after = port_view(port, {"params": jstate.params, "batch_stats": jstate.batch_stats})
    ema = port_view(port, {"params": jstate.ema_params, "batch_stats": jstate.ema_batch_stats})
    moved, n_far, n_el, n_params = 0, {"params": 0, "ema": 0}, 0, 0
    for (key, t), e in zip(port.state_dict().items(), state.ema.state_dict().values()):
        if key not in after:
            continue
        if key.endswith(("running_mean", "running_var")):
            for ours, ref in ((t, after[key]), (e, ema[key])):
                np.testing.assert_allclose(ours.numpy(), ref, atol=1e-5, rtol=1e-4, err_msg=key)
            continue
        for name, ours, ref in (("params", t, after[key]), ("ema", e, ema[key])):
            diff = np.abs(ours.numpy() - ref)
            assert diff.max() <= 2 * lr + 2e-6, (name, key, diff.max())
            n_far[name] += int((diff > 2e-6).sum())
        n_el += t.numel()
        if key in frozen:
            assert np.array_equal(t.numpy(), before[key]), key
            continue
        n_params += 1
        moved += int(not np.array_equal(t.numpy(), before[key]))
    assert max(n_far.values()) <= 0.005 * n_el, (n_far, n_el)
    assert moved > 0.9 * n_params, (moved, n_params)

    rel, exempt = first_moment_agreement(port, state.optimizer, jstate.opt_state,
                                         jstate.batch_stats, jstate.params)
    assert all(("lab." in k or "norm" in k or ".bn." in k) for k in exempt), exempt
    assert len(exempt) <= 0.1 * len(rel), exempt
    for k, r in rel.items():
        assert r <= (MU_REL_SCALAR if port.get_parameter(k).numel() == 1 else MU_REL), (k, r)


def write_dataset(root: Path, n: int, hw, seed: int, n_val: int = 0):
    """PNG frames with shapes, YOLO labels (polygon rows and box rows, one
    frame without labels), train.csv and val.csv: the last ``n_val`` frames
    in val and the others in train, or (``n_val`` 0) all frames in both."""
    import cv2

    from dfine_tpu_torch.data.image_io import write_png

    rng = np.random.default_rng(seed)
    (root / "images").mkdir(parents=True)
    (root / "labels").mkdir()
    h, w = hw
    names = []
    for i in range(n):
        img = rng.integers(0, 60, (h, w, 3), dtype=np.uint8)
        lines = []
        for _ in range(0 if i == 1 else int(rng.integers(1, 6))):
            cls = int(rng.integers(0, 3))
            cx, cy = rng.uniform(0.2, 0.8, 2)
            rx, ry = rng.uniform(0.05, 0.25, 2)
            ang = np.sort(rng.uniform(0, 2 * np.pi, int(rng.integers(3, 12))))
            poly = np.stack([cx + rx * np.cos(ang), cy + ry * np.sin(ang)], 1).clip(0, 1)
            pts = np.round(poly * (w, h)).astype(np.int32)
            cv2.fillPoly(img, [pts], tuple(int(v) for v in rng.integers(80, 256, 3)))
            if rng.uniform() < 0.3:
                lo, hi = poly.min(0), poly.max(0)
                lines.append(f"{cls} {(lo[0] + hi[0]) / 2:.6f} {(lo[1] + hi[1]) / 2:.6f} "
                             f"{hi[0] - lo[0]:.6f} {hi[1] - lo[1]:.6f}")
            else:
                lines.append(f"{cls} " + " ".join(f"{v:.6f}" for v in poly.reshape(-1)))
        names.append(f"f{i}.png")
        write_png(root / "images" / names[-1], img)
        (root / "labels" / f"f{i}.txt").write_text("\n".join(lines) + ("\n" if lines else ""))
    splits = {"train": names[:n - n_val], "val": names[n - n_val:]} if n_val else \
        {"train": names, "val": names}
    for split, part in splits.items():
        (root / f"{split}.csv").write_text("".join(f"{x}\n" for x in part))
    return names


# ------------------------------------- model variants: wide tail, extra levels --

# n at 320 px, batch 2, G = 4 slots, as in test_torch_port_train_step
VARIANT_SIZE, VARIANT_IMG, VARIANT_CLASSES, VARIANT_B, VARIANT_G = "n", 320, 5, 2, 4
# the tolerances of test_torch_port_train_step: boxes and reference points
# atol 5e-4, logits and corner logits atol 2e-3 (test_torch_parity.py:80-83)
SET_TOL = {"pred_boxes": dict(atol=5e-4, rtol=1e-3), "pred_logits": dict(atol=2e-3, rtol=1e-2),
           "pred_corners": dict(atol=2e-3, rtol=1e-2), "ref_points": dict(atol=5e-4, rtol=1e-3)}
# A variant's step runs without LAB, as test_torch_port_train_options's
# accumulated step does: a LAB scalar's gradient is one sum over a feature
# map that a train-mode BatchNorm re-normalizes, so at random weights
# AdamW's first moment of such a scalar is rounding-sized, and its relative
# error (up to 0.17 seen, beside MU_REL_SCALAR's 0.15) measures rounding,
# not the port.
NO_LAB = (("backbone.use_lab", False),)


def variant_batch(seed=4):
    rng = np.random.default_rng(seed)
    b, g = VARIANT_B, VARIANT_G
    images = rng.uniform(size=(b, VARIANT_IMG, VARIANT_IMG, 3)).astype(np.float32)
    targets = {"labels": rng.integers(0, VARIANT_CLASSES, (b, g)).astype(np.int32),
               "boxes": rng.uniform(0.25, 0.6, (b, g, 4)).astype(np.float32),
               "valid": np.asarray([[1, 1, 1, 0], [1, 1, 0, 0]], bool)}
    return images, targets


def torch_batch(images, targets):
    return (torch.from_numpy(images.transpose(0, 3, 1, 2).copy()),
            {k: torch.from_numpy(v.copy()) for k, v in targets.items()})


def all_sets(ref, ours):
    """(JAX, port) pairs of a train-mode output: final, aux, pre, encoder."""
    return ([(ref, ours)] + list(zip(ref["aux_outputs"], ours["aux_outputs"]))
            + [(ref["pre_outputs"], ours["pre_outputs"])]
            + list(zip(ref["enc_aux_outputs"], ours["enc_aux_outputs"])))


def compare_sets(ref, ours, pairs=lambda r, o: [(r, o)]):
    """Each (JAX, port) pair of ``pairs(ref, ours)`` row-aligned by the
    final layer's boxes, image by image: >= 98 % of queries matched 1:1,
    values within SET_TOL."""
    for bi in range(ours["pred_boxes"].shape[0]):
        match, keep = align_by_box(np.asarray(ref["pred_boxes"])[bi],
                                   ours["pred_boxes"][bi].numpy())
        assert keep.mean() >= 0.98, f"only {keep.mean():.3f} of queries matched 1:1"
        for r, o in pairs(ref, ours):
            for k in set(r) & set(SET_TOL):
                np.testing.assert_allclose(o[k][bi].numpy()[match[keep]],
                                           np.asarray(r[k])[bi][keep], **SET_TOL[k],
                                           err_msg=k)


def variant_step_against_jax(jmodel, variables, overrides, noise=None):
    """One train step of both from the same weights and ``variant_batch``
    (and the CDN noise ``noise``, the JAX key patched by the caller):
    ``check_step``; then the EMA model's eval outputs against JAX's
    ``make_eval_step`` by ``compare_sets``."""
    from dfine_tpu.train.criterion import CriterionConfig as JCrit
    from dfine_tpu.train.optim import OptimConfig as JOpt
    from dfine_tpu.train.optim import build_optimizer as jax_optimizer
    from dfine_tpu.train.train_step import TrainState as JState
    from dfine_tpu.train.train_step import make_eval_step as jax_eval_step
    from dfine_tpu.train.train_step import make_train_step as jax_step

    from dfine_tpu_torch.train.criterion import CriterionConfig
    from dfine_tpu_torch.train.optim import OptimConfig, build_optimizer
    from dfine_tpu_torch.train.train_step import TrainState, make_eval_step, make_train_step

    images, targets = variant_batch()
    tx = jax_optimizer(variables["params"], JOpt())
    jstate, jmetrics = jax.jit(jax_step(jmodel, tx, JCrit(num_classes=VARIANT_CLASSES)))(
        JState.create(variables, tx), {"images": jnp.asarray(images),
                                       "targets": jax.tree.map(jnp.asarray, targets)},
        jax.random.key(0))
    port = port_model_from(variables, VARIANT_SIZE, VARIANT_CLASSES, False, overrides)
    state = TrainState.create(port, build_optimizer(port, OptimConfig()))
    x, tgt = torch_batch(images, targets)
    step = make_train_step(CriterionConfig(num_classes=VARIANT_CLASSES),
                           compute_dtype=torch.float32)
    state, metrics = step(state, {"images": x, "targets": tgt}, dn_noise=noise)
    check_step(port, state, metrics, jstate, jmetrics, port_view(port, variables))
    compare_sets(jax.jit(jax_eval_step(jmodel))(jstate, jnp.asarray(images)),
                 make_eval_step()(state, x))
    return port
