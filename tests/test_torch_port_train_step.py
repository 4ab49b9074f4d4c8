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

from test_torch_port_helpers import (align_by_box, jax_cdn_noise, jax_template_shapes,
                                     port_model_from, random_variables)

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
    import dfine_tpu.models.decoder as jdec

    orig = jdec.build_cdn_queries
    monkeypatch.setattr(jdec, "build_cdn_queries", lambda labels, boxes, valid, rng, *a, **k:
                        orig(labels, boxes, valid, jax.random.key(DN_KEY_SEED), *a, **k))
    return jax_cdn_noise(jax.random.key(DN_KEY_SEED), B, G, NUM_CLASSES)


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


def _port_view(model, variables):
    """Each port tensor's JAX counterpart (params and batch_stats) in the
    port's layout, by the weight bridge's name map."""
    from dfine_tpu_torch.utils.checkpoint import flatten, flax_key, jax_to_port

    flat = flatten(jax.tree.map(np.asarray, variables))
    out = {}
    for key, t in model.state_dict().items():
        if key.endswith("num_batches_tracked"):
            continue
        fkey, transform = flax_key(key, t.dim())
        out[key] = jax_to_port(flat[fkey], transform, False)
    return out


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
    view = _port_view(port, {"params": variables["params"], **mutated})
    for key, t in port.state_dict().items():
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(t.numpy(), view[key], atol=1e-5, rtol=1e-4, err_msg=key)


# The first moment after the step, leaf by leaf: the norm of the difference
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


def _first_moment_agreement(port, state, jstate):
    """Per parameter of the port, ||m - m_jax|| / ||m_jax|| of AdamW's first
    moment (``exp_avg`` against optax's ``mu``), and the parameters exempted
    as nought to rounding, with their norms."""
    import optax
    from flax import traverse_util

    mu = {}
    is_adam = lambda x: isinstance(x, optax.ScaleByAdamState)  # noqa: E731
    for s in jax.tree.leaves(jstate.opt_state, is_leaf=is_adam):
        if is_adam(s):
            mu.update({k: v for k, v in traverse_util.flatten_dict(s.mu).items()
                       if not isinstance(v, optax.MaskedNode)})
    view = _port_view(port, {"params": traverse_util.unflatten_dict(mu),
                             "batch_stats": jstate.batch_stats})
    params = dict(port.named_parameters())
    norms = {k: float(np.linalg.norm(view[k])) for k in params}
    rms_all = np.sqrt(sum(n * n for n in norms.values()) / sum(p.numel() for p in params.values()))
    rel, exempt = {}, {}
    for k, p in params.items():
        if norms[k] / np.sqrt(p.numel()) < MU_ROUNDING_SHARE * rms_all:
            exempt[k] = norms[k]
            continue
        ours = state.optimizer.adamw.state[p]["exp_avg"].numpy()
        rel[k] = float(np.linalg.norm(ours - view[k])) / norms[k]
    return rel, exempt


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

    assert state.step == 1 and set(metrics) == set(jmetrics)
    for k, v in jmetrics.items():
        rtol = 1e-3 if k == "grad_norm" else 1e-4
        np.testing.assert_allclose(float(metrics[k]), float(v), rtol=rtol, err_msg=k)
    before = _port_view(port, variables)
    after = _port_view(port, {"params": jstate.params, "batch_stats": jstate.batch_stats})
    ema = _port_view(port, {"params": jstate.ema_params, "batch_stats": jstate.ema_batch_stats})
    lr, moved, n_far, n_el, n_params = 2e-5, 0, {"params": 0, "ema": 0}, 0, 0
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
        n_params += 1
        moved += int(not np.array_equal(t.numpy(), before[key]))
    assert max(n_far.values()) <= 0.005 * n_el, (n_far, n_el)
    assert moved > 0.9 * n_params

    # the first moment, 0.1 x the clipped gradient, leaf by leaf
    rel, exempt = _first_moment_agreement(port, state, jstate)
    assert all(("lab." in k or "norm" in k or ".bn." in k) for k in exempt), exempt
    assert len(exempt) <= 0.1 * len(rel), exempt
    for k, r in rel.items():
        assert r <= (MU_REL_SCALAR if port.get_parameter(k).numel() == 1 else MU_REL), (k, r)

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
