"""The flat optimizer (``build_optimizer(flat=True)``) under data
parallelism on the CPU: two gloo ranks, each a process that imports the
port only, run two micro-steps of the DP step (``b_accum_steps`` 2, the
freeze mask of backbone norms and stem, n detect at 320 px, fp32, SyncBN),
held against the JAX DP step over ``make_mesh(2)`` with JAX's
``build_optimizer(flat=True)`` (``flat_adamw`` under ``optax.MultiSteps``)
and against the port's own single-process flat step on the global batch.
The inputs and the JAX reference are those of ``test_torch_port_dp.py``.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_port_dp import (NUM_CLASSES, PER, RANKS, REPO, SIZE, STEP_LOSSES, _batch,
                                _free_port, _jax_dp_step, _rank_noise, DN_KEY_SEED)
from test_torch_port_helpers import (check_step, jax_template_shapes, port_model_from,
                                     port_view, random_variables)

ACCUM = 2

WORKER = r"""
import sys
sys.path.insert(0, {repo!r})
import numpy as np
import torch

torch.set_num_threads(2)
from dfine_tpu_torch.models.dfine import build_model
from dfine_tpu_torch.models.layers import set_bn_axis
from dfine_tpu_torch.parallel import dp as par
from dfine_tpu_torch.train.criterion import CriterionConfig
from dfine_tpu_torch.train.optim import OptimConfig, build_optimizer, freeze_mask
from dfine_tpu_torch.train.train_step import TrainState, make_train_step
from dfine_tpu_torch.utils.checkpoint import load_jax_variables, state_dict_of

rank, port, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
par.init_multihost(f"localhost:{{port}}", {ranks}, rank, device="cpu")
job = torch.load(f"{{tmp}}/inputs.pt", weights_only=False)
rows = slice(rank * {per}, (rank + 1) * {per})
t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
model = build_model("n", job["c"], False, device="cpu")
load_jax_variables(model, job["variables"])
state = TrainState.create(model, build_optimizer(model, OptimConfig(b_accum_steps={accum}),
                                                 flat=True))
step = par.make_dp_train_step(make_train_step(
    CriterionConfig(num_classes=job["c"], losses=job["losses"]), compute_dtype=torch.float32,
    axis_name="dp", update_mask=freeze_mask(model, True, True)))
out = []
set_bn_axis("dp")
try:
    for (images, targets), noise in zip(job["batches"], job["noise"]):
        tgt = {{k: t(v[rows]) for k, v in targets.items()}}
        tgt["labels"] = tgt["labels"].long()
        x = t(images[rows].transpose(0, 3, 1, 2))
        _, metrics = step(state, {{"images": x, "targets": tgt}}, dn_noise=noise[rank])
        out.append({{"metrics": {{k: float(v) for k, v in metrics.items()}},
                     "state": state_dict_of(state)}})
finally:
    set_bn_axis(None)
torch.save(out, f"{{tmp}}/rank{{rank}}.pt")
par.shutdown()
print(f"RANK{{rank}}_OK")
"""


def _flat_state(variables, frozen, saved=None, path=None):
    """A port model (its frozen parameters off ``requires_grad``) and a
    TrainState with the flat optimizer, filled from ``saved``."""
    from dfine_tpu_torch.train.optim import OptimConfig, build_optimizer
    from dfine_tpu_torch.train.train_step import TrainState
    from dfine_tpu_torch.utils.checkpoint import restore_state

    port = port_model_from(variables, SIZE, NUM_CLASSES, False)
    state = TrainState.create(port, build_optimizer(port, OptimConfig(b_accum_steps=ACCUM),
                                                    flat=True))
    if saved is not None:
        torch.save(saved, path)
        restore_state(path, state)
    for k in frozen:
        port.get_parameter(k).requires_grad_(False)
    return port, state


def _single_steps(variables, batches, noise):
    """The port's single-process flat step on the global batches, SyncBN
    on (one process: the statistics of the whole batch), the ranks' CDN
    draws side by side; the state and each micro-step's metrics."""
    from dfine_tpu_torch.models.denoising import CdnNoise
    from dfine_tpu_torch.models.layers import set_bn_axis
    from dfine_tpu_torch.train.criterion import CriterionConfig
    from dfine_tpu_torch.train.optim import freeze_mask
    from dfine_tpu_torch.train.train_step import make_train_step

    port, state = _flat_state(variables, ())
    step = make_train_step(CriterionConfig(num_classes=NUM_CLASSES, losses=STEP_LOSSES),
                           compute_dtype=torch.float32, update_mask=freeze_mask(port, True, True))
    metrics = []
    set_bn_axis("dp")
    try:
        for (images, targets), rank_noise in zip(batches, noise):
            tgt = {k: torch.from_numpy(v.copy()) for k, v in targets.items()}
            tgt["labels"] = tgt["labels"].long()
            x = torch.from_numpy(images.transpose(0, 3, 1, 2).copy())
            _, m = step(state, {"images": x, "targets": tgt},
                        dn_noise=CdnNoise(*(torch.cat(f) for f in zip(*rank_noise))))
            metrics.append({k: float(v) for k, v in m.items()})
    finally:
        set_bn_axis(None)
    return state, metrics


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from dfine_tpu.train.optim import OptimConfig as JOpt
    from dfine_tpu.train.optim import build_optimizer as jax_optimizer
    from dfine_tpu.train.optim import freeze_mask as jax_freeze_mask

    tmp = tmp_path_factory.mktemp("dp_flat")
    jmodel, shapes = jax_template_shapes(SIZE, NUM_CLASSES, False)
    variables = jax.tree.map(np.asarray, random_variables(shapes, seed=23))
    noise = _rank_noise(DN_KEY_SEED)
    batches = [_batch(4), _batch(8)]
    torch.save({"c": NUM_CLASSES, "variables": variables, "losses": STEP_LOSSES,
                "batches": batches, "noise": [noise] * ACCUM}, tmp / "inputs.pt")
    code = WORKER.format(repo=str(REPO), ranks=RANKS, per=PER, accum=ACCUM)
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), str(port), str(tmp)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(RANKS)]
    try:  # the references while the ranks run
        jmask = jax_freeze_mask(variables["params"], True, True)
        tx = jax_optimizer(jax.tree.map(jnp.asarray, variables["params"]),
                           JOpt(b_accum_steps=ACCUM), update_mask=jmask, flat=True)
        ref = _jax_dp_step(jmodel, variables, tx, batches, STEP_LOSSES, b_accum_steps=ACCUM,
                           update_mask=jmask)
        single = _single_steps(variables, batches, [noise] * ACCUM)
    finally:
        outs = [p.communicate(timeout=600) for p in procs]
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"RANK{r}_OK" in out, f"rank {r}:\n{err[-4000:]}"
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(RANKS)]
    from dfine_tpu_torch.train.optim import freeze_mask

    probe = port_model_from(variables, SIZE, NUM_CLASSES, False)
    frozen = [k for k, keep in freeze_mask(probe, True, True).items() if not keep]
    return {"ref": ref, "single": single, "ranks": ranks, "variables": variables,
            "frozen": frozen, "tmp": tmp}


def _ranks_equal(a, b):
    """Both ranks' parameters, buffers, EMA and flat AdamW state bit-equal."""
    for part in ("model", "ema"):
        for k, v in a[part].items():
            assert torch.equal(v, b[part][k]), (part, k)
    for k in ("m", "v"):
        assert torch.equal(a["flat_adamw"][k], b["flat_adamw"][k]), k


def test_flat_dp_micro_steps_match_jax_flat_dp_step(runs):
    """Two micro-steps on two global batches against the JAX DP step with
    ``flat_adamw`` under ``MultiSteps`` and the same freeze mask (a pmean of
    each micro-step's gradients): after the first, the metrics at rtol 1e-4
    (grad_norm 1e-3) and no update; after the second, ``check_step``'s rules
    (the flat first moment against JAX's flat ``m``, the frozen parameters
    bit-unchanged); both ranks bit-equal."""
    (_, jm0), (jstate, jmetrics) = runs["ref"]
    frozen = runs["frozen"]
    assert frozen
    for r, res in enumerate(runs["ranks"]):
        first, second = res
        for k, v in jm0.items():
            np.testing.assert_allclose(first["metrics"][k], v, rtol=1e-3 if k == "grad_norm"
                                       else 1e-4, err_msg=k)
        assert first["state"]["mini_step"] == 1 and first["state"]["count"] == 0
        assert second["state"]["mini_step"] == 0 and second["state"]["count"] == 1
        port, state = _flat_state(runs["variables"], frozen, second["state"],
                                  runs["tmp"] / f"flat{r}.ckpt")
        before = port_view(port_model_from(runs["variables"], SIZE, NUM_CLASSES, False),
                           runs["variables"])
        assert int(jstate.opt_state.gradient_step) == 1 and state.step == 2
        check_step(port, state, second["metrics"], jstate, jmetrics, before, frozen=frozen)
    _ranks_equal(runs["ranks"][0][1]["state"], runs["ranks"][1][1]["state"])


def test_flat_dp_step_matches_single_process_flat_step(runs):
    """The two ranks against the port's single-process flat step on the
    4-row global batches (SyncBN on, the ranks' CDN draws side by side), by
    ``test_torch_port_dp.py``'s single-process rules: each micro-step's loss
    rtol 1e-5 and grad_norm rtol 1e-4; after the optimizer step the
    BatchNorm statistics atol 1e-5, their counters equal, every parameter
    element within 2 lr + 2e-6 and at most 0.5 % of them beyond rtol 1e-4 /
    atol 1e-5; the optimizer count 1 on both sides, and the flat first
    moments within a tenth of the largest of the single process's."""
    state, metrics = runs["single"]
    ref = state.model.state_dict()
    lr = 2e-5
    for res in runs["ranks"]:
        for got, want in zip(res, metrics):
            np.testing.assert_allclose(got["metrics"]["loss"], want["loss"], rtol=1e-5,
                                       atol=1e-6)
            np.testing.assert_allclose(got["metrics"]["grad_norm"], want["grad_norm"],
                                       rtol=1e-4, atol=1e-6)
        saved = res[-1]["state"]
        far, n_el = 0, 0
        for k, v in saved["model"].items():
            if k.endswith("num_batches_tracked"):
                assert torch.equal(v, ref[k]), k
            elif k.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(v.numpy(), ref[k].numpy(), atol=1e-5, err_msg=k)
            else:
                assert (v - ref[k]).abs().max() <= 2 * lr + 2e-6, k
                far += int((~torch.isclose(v, ref[k], rtol=1e-4, atol=1e-5)).sum())
                n_el += v.numel()
        assert far <= 0.005 * n_el, (far, n_el)
        assert saved["count"] == state.optimizer.count == 1
        m, m_ref = saved["flat_adamw"]["m"], state.optimizer.m
        scale = float(m_ref.abs().max())
        assert 0 < scale and float((m - m_ref).abs().max()) <= 0.1 * scale
