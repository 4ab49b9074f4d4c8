"""What makes the train step capturable as a CUDA graph, on the CPU: the
step's constants made once on the device (the FDR bin values, the DN
matching rows), the optimizer's tensor learning rates against the float
ones it replaced, the EMA update with a momentum tensor against the float
formula, a state dict of either kind loaded, the step taking its eager
body where no graph can replay it, and the number of graphs a step keeps
against the batch sizes the loader makes. The graph itself runs only on
the card (``tests/test_torch_port_cuda.py``)."""

import copy
import types

import numpy as np
import pytest
import torch

from dfine_tpu_torch.utils import profiling

SMALL = (("decoder.num_layers", 1), ("decoder.num_queries", 50), ("decoder.num_denoising", 10))


def _model(seed=0):
    from dfine_tpu_torch.models.dfine import build_model

    torch.manual_seed(seed)
    return build_model("n", 5, False, device="cpu", cfg_overrides=SMALL)


def test_fdr_bin_values_are_made_once_and_equal_the_per_call_tensor():
    from dfine_tpu_torch.ops import fdr

    for reg_max, up, scale in ((32, 0.5, 4.0), (16, 0.5, 8.0)):
        got = fdr.bin_values(reg_max, up, scale, "cpu")
        want = torch.tensor(fdr.weighting_function(reg_max, up, scale), dtype=torch.float32)
        assert got.dtype == torch.float32 and torch.equal(got, want)
        assert fdr.bin_values(reg_max, up, scale, torch.device("cpu")) is got


def test_bbox2distance_unchanged_by_the_cached_bins():
    """``translate_gt`` on the cached bins against the same formula on a
    tensor made in the call, over gt on the bins, between, below and past
    them."""
    from dfine_tpu_torch.ops import fdr

    rng = np.random.default_rng(3)
    pts = torch.from_numpy(rng.uniform(0.2, 0.8, (64, 4)).astype(np.float32))
    gt = torch.from_numpy(rng.uniform(0.0, 1.0, (64, 4)).astype(np.float32))
    gt = torch.cat([gt[:, :2].minimum(gt[:, 2:]), gt[:, :2].maximum(gt[:, 2:])], -1)
    got = fdr.bbox2distance(pts, gt, 32, 4.0, 0.5)

    fv = torch.tensor(fdr.weighting_function(32, 0.5, 4.0), dtype=torch.float32)
    sx = pts[:, 2] / 4.0 + 1e-16
    sy = pts[:, 3] / 4.0 + 1e-16
    edges = torch.stack([(pts[:, 0] - gt[:, 0]) / sx - 2.0, (pts[:, 1] - gt[:, 1]) / sy - 2.0,
                         (gt[:, 2] - pts[:, 0]) / sx - 2.0, (gt[:, 3] - pts[:, 1]) / sy - 2.0],
                        -1).reshape(-1)
    edges = torch.cat([edges, fv, torch.tensor([fv[0] - 1.0, fv[-1] + 1.0])])
    left = (fv[None, :] <= edges[:, None]).sum(1).float() - 1.0
    idx_safe = left.clamp(0, 31).long()
    ld, rd = (edges - fv[idx_safe]).abs(), (fv[idx_safe + 1] - edges).abs()
    wr = ld / (ld + rd).clamp_min(1e-16)
    inside = (left >= 0) & (left < 32)
    want_wr = torch.where(left >= 32, 1.0, torch.where(inside, wr, 0.0))
    want_idx = torch.where(left >= 32, 31.9, torch.where(left < 0, 0.0, left))
    idx, w_r, w_l = fdr.translate_gt(edges, 32, 4.0, 0.5)
    assert torch.equal(idx, want_idx) and torch.equal(w_r, want_wr)
    assert torch.equal(w_l, torch.where(left < 0, 1.0, torch.where(inside, 1.0 - wr, 0.0)))
    assert torch.equal(got[0], want_idx[:256].clamp(0, 31.9)) and torch.equal(got[1],
                                                                             want_wr[:256])


def test_dn_match_rows_are_made_once_and_equal_the_per_call_rows():
    from dfine_tpu_torch.models.denoising import dn_match_indices

    valid = torch.tensor([[True, False, True, True], [False, False, True, False]])
    q, t, v = dn_match_indices(valid, 3)
    g = valid.shape[1]
    want_q = np.concatenate([k * 2 * g + np.arange(g) for k in range(3)])
    assert torch.equal(q, torch.from_numpy(want_q)[None].expand(2, -1))
    assert torch.equal(t, torch.from_numpy(np.tile(np.arange(g), 3))[None].expand(2, -1))
    assert torch.equal(v, valid.repeat(1, 3))
    q2, t2, _ = dn_match_indices(valid, 3)
    assert q2.data_ptr() == q.data_ptr() and t2.data_ptr() == t.data_ptr()


def _float_lr_step(adamw, params, schedules, clip, count):
    """The optimizer step with float learning rates, as the port had it."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    torch._foreach_mul_(grads, clip / torch.maximum(norm, torch.tensor(clip)))
    for group in adamw.param_groups:
        group["lr"] = schedules[group["group"]](count)
    adamw.step()


@pytest.mark.parametrize("per_group", [False, True])
def test_tensor_learning_rates_match_the_float_ones(per_group):
    """Three steps of ``Optimizer`` (0-d fp32 rate tensors written from the
    schedule) against AdamW with the schedule's float rates, on the same
    gradients, through the warm-up: every parameter and first moment within
    1e-6 relative (atol 1e-10 for elements near 0)."""
    from dfine_tpu_torch.train.optim import OptimConfig, build_optimizer

    cfg = OptimConfig(epochs=1, steps_per_epoch=20, pct_start=0.5, per_group_max_lr=per_group)
    model = _model()
    ref_model = copy.deepcopy(model)
    opt = build_optimizer(model, cfg)
    assert all(isinstance(g["lr"], torch.Tensor) and g["lr"].dtype == torch.float32
               and g["lr"].dim() == 0 for g in opt.adamw.param_groups)
    ref_opt = build_optimizer(ref_model, cfg)
    ref_adamw = torch.optim.AdamW(
        [{"params": g["params"], "weight_decay": g["weight_decay"], "group": g["group"],
          "lr": ref_opt.schedules[g["group"]](0)} for g in ref_opt.adamw.param_groups],
        betas=cfg.betas, eps=1e-8)
    gen = torch.Generator().manual_seed(5)
    for count in range(3):
        for p, q in zip(opt.params, ref_opt.params):
            p.grad = torch.randn(p.shape, generator=gen) * 1e-2
            q.grad = p.grad.clone()
        opt.write_lr()
        opt.step()
        _float_lr_step(ref_adamw, ref_opt.params, ref_opt.schedules, cfg.clip_max_norm, count)
        for group, ref in zip(opt.adamw.param_groups, ref_adamw.param_groups):
            np.testing.assert_allclose(float(group["lr"]), ref["lr"], rtol=1e-7)
    assert opt.count == 3
    for p, q in zip(opt.params, ref_opt.params):
        torch.testing.assert_close(p.detach(), q.detach(), rtol=1e-6, atol=1e-10)
        torch.testing.assert_close(opt.adamw.state[p]["exp_avg"], ref_adamw.state[q]["exp_avg"],
                                   rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("iteration", [1, 700, 20000])
def test_ema_update_with_a_momentum_tensor_equals_the_float_formula(iteration):
    """``ema_update`` reading [m, 1 - m] from a tensor that
    ``write_ema_momentum`` wrote, against the float formula the port had
    (``ema * m + (1 - m) * model`` with m a Python float); the batch
    counters copied."""
    from dfine_tpu_torch.train.optim import ema_momentum, ema_update, write_ema_momentum

    model = _model(1)
    ema = _model(2).eval()
    for b in model.buffers():
        if b.dtype == torch.int64:
            b.fill_(7)
    ema_t = copy.deepcopy(ema)
    m = ema_momentum(iteration, 0.9998)
    src = model.state_dict()
    with torch.no_grad():
        for k, t in ema.state_dict().items():
            if t.is_floating_point():
                t.mul_(m).add_(src[k], alpha=1.0 - m)
            else:
                t.copy_(src[k])
    momentum = torch.empty(2)
    write_ema_momentum(momentum, iteration, 0.9998)
    assert momentum.tolist() == torch.tensor([m, 1.0 - m]).tolist()
    ema_update(ema_t, model, momentum)
    for (k, a), b in zip(ema.state_dict().items(), ema_t.state_dict().values()):
        if a.is_floating_point():
            torch.testing.assert_close(b, a, rtol=1e-6, atol=1e-9, msg=k)
        else:
            assert torch.equal(b, a) and int(b.max()) == 7, k


def test_load_state_dict_keeps_the_rate_tensors_and_marks_a_new_state():
    """A state dict with tensor rates (this optimizer's) or float ones (an
    older checkpoint's) loads; the groups keep this optimizer's tensors, the
    version rises (a captured step must capture again), and the next steps
    equal those of the optimizer it was saved from."""
    from dfine_tpu_torch.train.optim import OptimConfig, build_optimizer

    cfg = OptimConfig(epochs=1, steps_per_epoch=20)
    a_model = _model()
    a = build_optimizer(a_model, cfg)

    def grads(params, seed):
        g = torch.Generator().manual_seed(seed)
        for p in params:
            p.grad = torch.randn(p.shape, generator=g) * 1e-2

    grads(a.params, 0)
    a.write_lr()
    a.step()
    for old_format in (False, True):
        sd = copy.deepcopy(a.state_dict())
        if old_format:
            for group in sd["adamw"]["param_groups"]:
                group["lr"] = float(group["lr"])
        b_model = copy.deepcopy(a_model)
        b = build_optimizer(b_model, cfg)
        lrs = list(b.lrs)
        b.load_state_dict(sd)
        assert b.version == 1 and b.count == 1
        assert all(g["lr"] is lr for g, lr in zip(b.adamw.param_groups, lrs))
        a2_model = copy.deepcopy(a_model)
        a2 = build_optimizer(a2_model, cfg)
        a2.load_state_dict(copy.deepcopy(a.state_dict()))
        for opt in (a2, b):
            grads(opt.params, 1)
            opt.write_lr()
            opt.step()
        for p, q in zip(a2.params, b.params):
            assert torch.equal(p, q)


def test_the_step_runs_eagerly_on_the_cpu():
    """On CPU tensors the step takes its eager body: each call counts
    ``train.eager_steps``, none captures or replays, ``graphs`` stays
    empty, and ``step.eager`` gives the same step."""
    from dfine_tpu_torch.train.criterion import CriterionConfig
    from dfine_tpu_torch.train.optim import OptimConfig, build_optimizer
    from dfine_tpu_torch.train.train_step import TrainState, make_train_step

    batch = {"images": torch.rand(1, 3, 160, 160, generator=torch.Generator().manual_seed(0)),
             "targets": {"labels": torch.tensor([[1, 2, 0]]),
                         "boxes": torch.tensor([[[.5, .5, .2, .2], [.3, .3, .1, .2],
                                                 [.5, .5, .1, .1]]]),
                         "valid": torch.tensor([[True, True, False]])}}
    runs = []
    for use_eager in (False, True):
        model = _model()
        state = TrainState.create(model, build_optimizer(model, OptimConfig()))
        step = make_train_step(CriterionConfig(num_classes=5), compute_dtype=torch.float32)
        fn = step.eager if use_eager else step
        profiling.drain()
        with profiling.tracing(True):
            for _ in range(2):
                _, m = fn(state, batch, generator=torch.Generator().manual_seed(0))
        counters = profiling.drain()["counters"]
        assert counters.get("train.eager_steps") == 2
        assert "train.graph_captures" not in counters and "train.graph_replays" not in counters
        assert step.graphs == {} and state.step == 2 and state.optimizer.count == 2
        runs.append((m, {k: v.clone() for k, v in model.state_dict().items()}))
    (m0, p0), (m1, p1) = runs
    assert all(torch.equal(m0[k], m1[k]) for k in m0)
    assert all(torch.equal(p0[k], p1[k]) for k in p0)


def test_the_graph_cap_covers_the_loaders_batch_sizes():
    """A trainer's batches take at most ``MAX_GRAPHS`` signatures: over
    epochs with multiscale on some or every batch, the loader draws exactly
    ``MAX_GRAPHS`` image sizes, the base size among them, and drop_last
    keeps every batch full."""
    from dfine_tpu_torch.data.loader import BatchIterator
    from dfine_tpu_torch.train.train_step import MAX_GRAPHS

    class Samples:
        mode = "train"
        cfg = types.SimpleNamespace(img_size=(640, 640))

        def __len__(self):
            return 8 * 150 + 5

        def set_epoch(self, epoch):
            pass

    for prob in (0.5, 1.0):
        it = BatchIterator(Samples(), 8, shuffle=True, seed=3, multiscale_prob=prob)
        sizes = set()
        for epoch in range(3):
            it.set_epoch(epoch)
            sizes.update(it.batch_sizes())
        assert len(it) == 150
        assert len(sizes) == MAX_GRAPHS and (640, 640) in sizes, sorted(sizes)
