"""Shared helpers of the port's parity tests (``test_torch_port_*``).

The port is held against the JAX package on the same inputs: data is made
with numpy from a seed and handed to both; JAX stays on the CPU. The JAX
template comes from a train-mode ``eval_shape`` (no compile), so every head
exists, and every leaf is re-drawn from a numpy seed: the JAX zero inits
(sampling offsets, attention weights, gate, the ``zero_last`` heads) would
otherwise make the decoder trivial. This file holds no tests.
"""

from __future__ import annotations

import numpy as np
import torch

import jax
import jax.numpy as jnp

torch.set_num_threads(2)  # xdist runs several workers side by side


def jax_template_shapes(size: str, num_classes: int, mask_head: bool, img: int = 320):
    """ShapeDtypeStruct tree of a train-mode init of the JAX DFINE."""
    from dfine_tpu.models import build_model

    model = build_model(size, num_classes=num_classes, enable_mask_head=mask_head)
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


def port_model_from(variables, size: str, num_classes: int, mask_head: bool):
    from dfine_tpu_torch.models.dfine import build_model
    from dfine_tpu_torch.utils.checkpoint import load_jax_variables

    model = build_model(size, num_classes, mask_head, device="cpu")
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
