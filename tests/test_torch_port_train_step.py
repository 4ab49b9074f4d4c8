"""The train path of the port against the JAX package on the CPU, fp32:
(g) the train-mode model outputs and updated BatchNorm statistics, and
(h) one whole ``make_train_step`` (forward with the CDN queries, criterion
with Hungarian matching, backward, clip + AdamW, EMA), at size n, 320 px,
batch 2, G = 4 slots, with every weight re-drawn from a numpy seed.

Both sides use the same CDN noise: the JAX decoder's ``build_cdn_queries``
is handed a fixed key, and the port gets the four arrays drawn from that
key with the JAX package's own split (``jax_cdn_noise``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_port_helpers import (align_by_box, check_step, jax_template_shapes,
                                     patch_jax_dn_key, port_model_from, port_view,
                                     random_variables)

SIZE, IMG, NUM_CLASSES, B, G = "n", 320, 5, 2, 4
DN_KEY_SEED = 5
_CACHE = {}


@pytest.fixture(scope="module")
def setup():
    if not _CACHE:
        jmodel, shapes = jax_template_shapes(SIZE, NUM_CLASSES, False, IMG)
        _CACHE.update(jmodel=jmodel, variables=random_variables(shapes, seed=23))
    yield _CACHE
    _CACHE.clear()


@pytest.fixture
def fixed_dn_key(monkeypatch):
    """The JAX decoder draws its CDN noise from ``jax.random.key(5)``."""
    return patch_jax_dn_key(monkeypatch, DN_KEY_SEED, B, G, NUM_CLASSES)


def _batch(seed=4):
    rng = np.random.default_rng(seed)
    images = rng.uniform(size=(B, IMG, IMG, 3)).astype(np.float32)
    targets = {"labels": rng.integers(0, NUM_CLASSES, (B, G)).astype(np.int32),
               "boxes": rng.uniform(0.25, 0.6, (B, G, 4)).astype(np.float32),
               "valid": np.asarray([[1, 1, 1, 0], [1, 1, 0, 0]], bool)}
    return images, targets


def _torch_batch(images, targets):
    return (torch.from_numpy(images.transpose(0, 3, 1, 2).copy()),
            {k: torch.from_numpy(v.copy()) for k, v in targets.items()})


def test_train_mode_outputs_match_jax(setup, fixed_dn_key):
    """Final, aux, pre and encoder sets aligned by box on the final layer
    (>= 98 % of queries matched 1:1), the DN sets in their fixed order:
    boxes atol 5e-4, logits and corner logits atol 2e-3
    (test_torch_parity.py:80-83); the BatchNorm statistics updated by the
    forward atol 1e-5, rtol 1e-4."""
    jmodel, variables = setup["jmodel"], setup["variables"]
    images, targets = _batch()
    ref, mutated = jax.jit(lambda v, x, t: jmodel.apply(
        v, x, t, train=True, rngs={"dn": jax.random.key(0)}, mutable=["batch_stats"]))(
        variables, jnp.asarray(images), jax.tree.map(jnp.asarray, targets))
    port = port_model_from(variables, SIZE, NUM_CLASSES, False).train()
    x, tgt = _torch_batch(images, targets)
    with torch.no_grad():
        ours = port(x, tgt, dn_noise=fixed_dn_key)

    tol = {"pred_boxes": dict(atol=5e-4, rtol=1e-3), "pred_logits": dict(atol=2e-3, rtol=1e-2),
           "pred_corners": dict(atol=2e-3, rtol=1e-2), "ref_points": dict(atol=5e-4, rtol=1e-3)}
    for bi in range(B):
        match, keep = align_by_box(np.asarray(ref["pred_boxes"])[bi],
                                   ours["pred_boxes"][bi].numpy())
        assert keep.mean() >= 0.98, f"only {keep.mean():.3f} of queries matched 1:1"
        pairs = ([(ref, ours)] + list(zip(ref["aux_outputs"], ours["aux_outputs"]))
                 + [(ref["pre_outputs"], ours["pre_outputs"])]
                 + list(zip(ref["enc_aux_outputs"], ours["enc_aux_outputs"])))
        for r, o in pairs:
            for k in set(r) & set(tol):
                np.testing.assert_allclose(o[k][bi].numpy()[match[keep]],
                                           np.asarray(r[k])[bi][keep], **tol[k], err_msg=k)
    dn_pairs = (list(zip(ref["dn_outputs"], ours["dn_outputs"]))
                + [(ref["dn_pre_outputs"], ours["dn_pre_outputs"])])
    assert len(dn_pairs) == len(ours["aux_outputs"]) + 2
    for r, o in dn_pairs:
        for k in set(r) & set(tol):
            np.testing.assert_allclose(o[k].numpy(), np.asarray(r[k]), **tol[k], err_msg=k)
    assert ours["dn_meta"] == {k: (tuple(v) if isinstance(v, tuple) else v)
                               for k, v in ref["dn_meta"].items()}
    view = port_view(port, {"params": variables["params"], **mutated})
    for key, t in port.state_dict().items():
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(t.numpy(), view[key], atol=1e-5, rtol=1e-4, err_msg=key)


def test_train_step_matches_jax(setup, fixed_dn_key):
    """One step of both, same weights, batch and DN noise: every loss term
    and the total at rtol 1e-4 (fp32 sums over a whole model in another
    order), grad_norm at rtol 1e-3. AdamW's first moment, leaf by leaf,
    within MU_REL of JAX's (MU_REL_SCALAR for one-element leaves), but for
    the leaves nought to rounding (norm and LAB parameters only, at most a
    tenth of all). AdamW's first step moves a parameter by
    lr * g / (|g| + 1e-8), about lr = 2e-5 with the sign of its gradient:
    at least 99.5 % of all parameter elements are within 2e-6 of JAX's (a
    tenth of a step), and every element within 2 lr + 2e-6 (a gradient
    within rounding noise of zero may take the other sign: train-mode
    BatchNorm's backward subtracts its means and amplifies the noise). The
    updated BatchNorm statistics atol 1e-5, rtol 1e-4. The EMA is held to
    JAX's EMA by the same rules, and ``make_eval_step`` on it to JAX's as the
    eval model test holds the model (>= 98 % of queries matched 1:1, boxes
    atol 5e-4, logits atol 2e-3)."""
    from dfine_tpu.train.criterion import CriterionConfig as JCrit
    from dfine_tpu.train.optim import OptimConfig as JOpt
    from dfine_tpu.train.optim import build_optimizer as jax_optimizer
    from dfine_tpu.train.train_step import TrainState as JState
    from dfine_tpu.train.train_step import make_eval_step as jax_eval_step
    from dfine_tpu.train.train_step import make_train_step as jax_step

    from dfine_tpu_torch.train.criterion import CriterionConfig
    from dfine_tpu_torch.train.optim import OptimConfig, build_optimizer
    from dfine_tpu_torch.train.train_step import TrainState, make_eval_step, make_train_step

    jmodel, variables = setup["jmodel"], setup["variables"]
    images, targets = _batch()
    tx = jax_optimizer(variables["params"], JOpt())
    jstate, jmetrics = jax.jit(jax_step(jmodel, tx, JCrit(num_classes=NUM_CLASSES)))(
        JState.create(variables, tx), {"images": jnp.asarray(images),
                                       "targets": jax.tree.map(jnp.asarray, targets)},
        jax.random.key(0))

    port = port_model_from(variables, SIZE, NUM_CLASSES, False)
    state = TrainState.create(port, build_optimizer(port, OptimConfig()))
    x, tgt = _torch_batch(images, targets)
    step = make_train_step(CriterionConfig(num_classes=NUM_CLASSES), compute_dtype=torch.float32)
    state, metrics = step(state, {"images": x, "targets": tgt}, dn_noise=fixed_dn_key)

    assert state.step == 1
    check_step(port, state, metrics, jstate, jmetrics, port_view(port, variables))

    ref = jax.jit(jax_eval_step(jmodel))(jstate, jnp.asarray(images))
    ours = make_eval_step()(state, x)
    for bi in range(B):
        match, keep = align_by_box(np.asarray(ref["pred_boxes"])[bi],
                                   ours["pred_boxes"][bi].numpy())
        assert keep.mean() >= 0.98, f"only {keep.mean():.3f} of queries matched 1:1"
        np.testing.assert_allclose(ours["pred_boxes"][bi].numpy()[match[keep]],
                                   np.asarray(ref["pred_boxes"])[bi][keep], atol=5e-4, rtol=1e-3)
        np.testing.assert_allclose(ours["pred_logits"][bi].numpy()[match[keep]],
                                   np.asarray(ref["pred_logits"])[bi][keep], atol=2e-3, rtol=1e-2)
