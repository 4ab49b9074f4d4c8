"""The flat optimizer tail (``build_optimizer(flat=True)``,
``ema_update_flat``) of the port on the CPU against the JAX package's
``flat_adamw`` under ``optax.MultiSteps`` and ``ema_update_flat``, and
against the port's four-group ``Optimizer``. The parameters are those of
the n model, every JAX leaf re-drawn from a numpy seed and bridged; the
gradients are drawn from a numpy seed, the frozen ones zero, as the JAX
train step masks them.

Tolerances: an update moves a parameter by about the learning rate (up to
5e-4 here); the two sides compute it in f32 in another order (the global
norm's sum, ``lerp_`` against ``m * a + (1 - m) * b``), so parameters agree
within 1e-6 (a fifth of a percent of a step) and Adam's moments within
rtol 1e-5, atol 1e-10.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_port_helpers import (jax_template_shapes, port_model_from, port_view,
                                     random_variables, torch_batch, variant_batch)

SIZE, NUM_CLASSES = "n", 5
# a short schedule, so that the rate moves from step to step; l/x peaks,
# two micro-steps an optimizer step
KW = dict(per_group_max_lr=True, b_accum_steps=2, epochs=2, steps_per_epoch=6)
MICRO = 6  # three optimizer steps


@pytest.fixture(scope="module")
def variables():
    _, shapes = jax_template_shapes(SIZE, NUM_CLASSES, False)
    return random_variables(shapes, seed=17)


def _grads(params, mask, seed):
    """A gradient tree like ``params`` from ``seed``, zero where frozen."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda p, keep: (rng.normal(0, 1e-2, np.shape(p)) * keep)
                        .astype(np.float32), params, mask)


def _frozen_port(variables):
    from dfine_tpu_torch.train.optim import freeze_mask

    port = port_model_from(variables, SIZE, NUM_CLASSES, False).train()
    frozen = [k for k, keep in freeze_mask(port, True, True).items() if not keep]
    for k in frozen:
        port.get_parameter(k).requires_grad_(False)
    return port, frozen


def _set_grads(port, opt, view):
    opt.zero_grad()
    for k, p in port.named_parameters():
        if p.requires_grad:
            if p.grad is None:
                p.grad = torch.from_numpy(view[k].copy())
            else:
                p.grad.copy_(torch.from_numpy(view[k]))


def _port_layout(port, flat):
    """A flat buffer of the port's parameter order, cut into its tensors."""
    out, off = {}, 0
    for k, p in port.named_parameters():
        out[k] = flat[off: off + p.numel()].view_as(p).numpy()
        off += p.numel()
    return out


def test_flat_optimizer_matches_jax_flat_adamw(variables):
    """Six micro-steps, accumulation 2, the freeze mask of l/x (backbone
    norms and stem), per-group peaks: after each optimizer step every
    parameter within 1e-6 of JAX's, the frozen ones bit-unchanged on both
    sides; Adam's m and v after the last step within rtol 1e-5, atol
    1e-10 of JAX's flat state; the micro-step's gradient norm within rtol
    1e-5."""
    import optax
    from jax.flatten_util import ravel_pytree

    from dfine_tpu.train.optim import OptimConfig as JOpt
    from dfine_tpu.train.optim import build_optimizer as jax_optimizer
    from dfine_tpu.train.optim import freeze_mask as jax_freeze_mask

    from dfine_tpu_torch.train.optim import OptimConfig, build_optimizer

    params = jax.tree.map(jnp.asarray, variables["params"])
    jmask = jax_freeze_mask(params, True, True)
    tx = jax_optimizer(params, JOpt(**KW), update_mask=jmask, flat=True)
    jstate = tx.init(params)
    port, frozen = _frozen_port(variables)
    opt = build_optimizer(port, OptimConfig(**KW), flat=True)
    init = port_view(port, variables)
    update = jax.jit(lambda g, st, p: (lambda u, st2: (optax.apply_updates(p, u), st2))(
        *tx.update(g, st, p)))
    for micro in range(MICRO):
        grads = _grads(variables["params"], jmask, seed=micro)
        view = port_view(port, {"params": grads, "batch_stats": variables["batch_stats"]})
        _set_grads(port, opt, view)
        norm = opt.step()
        jnorm = float(optax.global_norm(grads))
        np.testing.assert_allclose(float(norm), jnorm, rtol=1e-5)
        params, jstate = update(jax.tree.map(jnp.asarray, grads), jstate, params)
        assert opt.mini_step == (micro + 1) % 2 and opt.count == (micro + 1) // 2
        if opt.mini_step:
            continue
        ref = port_view(port, {"params": params, "batch_stats": variables["batch_stats"]})
        for k, p in port.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), ref[k], atol=1e-6, rtol=0,
                                       err_msg=k)
            if k in frozen:
                assert np.array_equal(p.detach().numpy(), init[k]) and \
                    np.array_equal(ref[k], init[k]), k
    inner = jstate.inner_opt_state
    _, unravel = ravel_pytree(variables["params"])
    for name, ours in (("m", opt.m), ("v", opt.v)):
        ref = port_view(port, {"params": unravel(getattr(inner, name)),
                               "batch_stats": variables["batch_stats"]})
        for k, t in _port_layout(port, ours).items():
            np.testing.assert_allclose(t, ref[k], rtol=1e-5, atol=1e-10, err_msg=f"{name} {k}")


def test_ema_update_flat_matches_jax(variables):
    """The port's ``ema_update_flat`` (one ``lerp_`` over parameters and
    BatchNorm statistics) against JAX's ``ema_update_flat`` over the same
    trees at iteration 500 and base 0.9999: within 1e-6; BatchNorm's batch
    counter copied."""
    from dfine_tpu.train.optim import ema_update_flat as jax_ema_flat

    from dfine_tpu_torch.train.flat_optim import ema_update_flat

    rng = np.random.default_rng(9)
    moved = jax.tree.map(lambda v: (v + rng.normal(0, 0.05, np.shape(v))).astype(np.float32),
                         variables)
    ema = port_model_from(variables, SIZE, NUM_CLASSES, False)
    model = port_model_from(moved, SIZE, NUM_CLASSES, False)
    for m in model.modules():
        if hasattr(m, "num_batches_tracked"):
            m.num_batches_tracked.fill_(7)
    ema_update_flat(ema, model, 500, 0.9999)
    ref = jax_ema_flat(jax.tree.map(jnp.asarray, variables), jax.tree.map(jnp.asarray, moved),
                       jnp.asarray(500), 0.9999)
    view = port_view(ema, jax.tree.map(np.asarray, ref))
    for k, t in ema.state_dict().items():
        if k.endswith("num_batches_tracked"):
            assert int(t) == 7, k
            continue
        np.testing.assert_allclose(t.numpy(), view[k], atol=1e-6, rtol=0, err_msg=k)


def test_flat_optimizer_matches_the_group_optimizer(variables):
    """The flat optimizer and the four-group ``Optimizer`` on the same
    gradients, frozen parameters and accumulation: after each optimizer
    step every parameter within 1e-6, the frozen ones bit-unchanged; the
    moments within rtol 1e-5, atol 1e-10 of AdamW's."""
    from dfine_tpu_torch.train.optim import OptimConfig, build_optimizer, freeze_mask

    port_a, frozen = _frozen_port(variables)
    port_b, _ = _frozen_port(variables)
    opt_a = build_optimizer(port_a, OptimConfig(**KW))
    opt_b = build_optimizer(port_b, OptimConfig(**KW), flat=True)
    params = variables["params"]
    mask = freeze_mask(port_a, True, True)
    jmask = jax.tree.map(lambda _: True, params)
    init = {k: p.detach().clone() for k, p in port_a.named_parameters()}
    for micro in range(MICRO):
        view = port_view(port_a, {"params": _grads(params, jmask, seed=40 + micro),
                                  "batch_stats": variables["batch_stats"]})
        view = {k: v * mask.get(k, True) for k, v in view.items()}
        _set_grads(port_a, opt_a, view)
        _set_grads(port_b, opt_b, view)
        opt_a.write_lr()  # the group optimizer's rates, written as the train step writes them
        na, nb = opt_a.step(), opt_b.step()
        np.testing.assert_allclose(float(nb), float(na), rtol=1e-5)
        if opt_a.mini_step:
            continue
        for (k, a), b in zip(port_a.named_parameters(), port_b.parameters()):
            np.testing.assert_allclose(b.detach().numpy(), a.detach().numpy(), atol=1e-6,
                                       rtol=0, err_msg=k)
            if k in frozen:
                assert torch.equal(a, init[k]) and torch.equal(b, init[k]), k
    moments = _port_layout(port_b, opt_b.m)
    for k, p in port_a.named_parameters():
        if p in opt_a.adamw.state:
            np.testing.assert_allclose(moments[k], opt_a.adamw.state[p]["exp_avg"].numpy(),
                                       rtol=1e-5, atol=1e-10, err_msg=k)


def test_flat_train_step_matches_the_group_step_and_resumes(variables, tmp_path):
    """Two fp32 train steps of n at 320 px, one with each optimizer, same
    weights, batch and CDN noise, held by ``check_step``'s element rules
    to each other, the model and the EMA (``ema_update_flat`` against
    ``ema_update``) alike: every element within 2 lr + 2e-6 and 99.5 % of
    them within 2e-6 (lr = 2e-5, the first rate of the schedule). The
    clip's norms differ in rounding, so an element whose gradient is
    rounding-sized may take AdamW's normalized step of lr with the other
    sign, and after the first step the backbone's train-mode BatchNorms
    amplify the difference in the weights.
    The flat state saved by ``save_state`` and restored into a fresh flat
    optimizer gives a bit-equal third step."""
    from dfine_tpu_torch.models.denoising import draw_cdn_noise
    from dfine_tpu_torch.train.criterion import CriterionConfig
    from dfine_tpu_torch.train.optim import OptimConfig, build_optimizer
    from dfine_tpu_torch.train.train_step import TrainState, make_train_step
    from dfine_tpu_torch.utils.checkpoint import restore_state, save_state

    images, targets = variant_batch()
    x, tgt = torch_batch(images, targets)
    crit = CriterionConfig(num_classes=NUM_CLASSES)
    step = make_train_step(crit, compute_dtype=torch.float32, ema_base=0.99)

    def noise(seed):
        return draw_cdn_noise(2, 4, NUM_CLASSES, 100, 0.5, torch.Generator().manual_seed(seed))

    states = []
    for flat in (False, True):
        port = port_model_from(variables, SIZE, NUM_CLASSES, False)
        states.append(TrainState.create(port, build_optimizer(port, OptimConfig(), flat=flat)))
    lr = 2e-5
    for seed in (1, 2):
        for st in states:
            step(st, {"images": x, "targets": tgt}, dn_noise=noise(seed))
        for part in ("model", "ema"):
            far = total = 0
            for (k, a), b in zip(getattr(states[0], part).state_dict().items(),
                                 getattr(states[1], part).state_dict().values()):
                diff = (a.double() - b.double()).abs()
                assert diff.max().item() <= 2 * lr + 2e-6, (part, k, diff.max().item())
                far += int((diff > 2e-6).sum())
                total += diff.numel()
            assert far <= 0.005 * total, (part, far, total)

    flat_state = states[1]
    save_state(tmp_path / "flat.ckpt", flat_state)
    port = port_model_from(variables, SIZE, NUM_CLASSES, False)
    fresh = TrainState.create(port, build_optimizer(port, OptimConfig(), flat=True))
    restore_state(tmp_path / "flat.ckpt", fresh)
    assert fresh.optimizer.count == 2 and torch.equal(fresh.optimizer.v, flat_state.optimizer.v)
    for st in (flat_state, fresh):
        step(st, {"images": x, "targets": tgt}, dn_noise=noise(3))
    for (k, a), b in zip(flat_state.model.state_dict().items(),
                         fresh.model.state_dict().values()):
        assert torch.equal(a, b), k
