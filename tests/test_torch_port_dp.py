"""Data parallelism of the port (``dfine_tpu_torch.parallel``) on the CPU:
two gloo ranks, each a process that imports the port only (no jax, no
conftest), against the JAX package's DP over a 2-device mesh (the
conftest's virtual CPU devices) and against the port's own single-process
step on the global batch. Size n at 320 px, fp32.

One module fixture writes every input (weights re-drawn from a numpy seed,
global batches, the JAX per-replica CDN noise), starts both ranks on all
jobs, computes the JAX references while they run, and collects each rank's
results; each test holds one job. The JAX decoder's CDN key is pinned to
``fold_in(key(5), axis_index("dp"))`` and rank r gets the same draws.
"""

import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_port_helpers import (check_step, jax_cdn_noise, jax_template_shapes,
                                     port_model_from, port_view, random_outputs,
                                     random_variables)

REPO = Path(__file__).resolve().parents[1]
SIZE, IMG, NUM_CLASSES, B, G, RANKS = "n", 320, 5, 4, 4, 2
PER = B // RANKS
DN_KEY_SEED = 5
VALID = np.asarray([[1, 1, 1, 0], [1, 1, 0, 0], [1, 0, 0, 0], [1, 1, 1, 1]], bool)
# the one-step comparisons leave out DDF ("local"): its weights scale with
# the rank's own batch by design (8 / b, criterion.py:384), in JAX too; the
# criterion job and the accumulated steps hold it
STEP_LOSSES = ("vfl", "boxes")
FULL_LOSSES = ("vfl", "boxes", "local")
BN_C, BN_HW, BN_ROWS = 6, (5, 7), 4

WORKER = r"""
import sys
sys.path.insert(0, {repo!r})
import numpy as np
import torch

torch.set_num_threads(2)
from dfine_tpu_torch.models.dfine import build_model
from dfine_tpu_torch.models.layers import BatchNorm2d, set_bn_axis
from dfine_tpu_torch.parallel import dp as par
from dfine_tpu_torch.train.criterion import CriterionConfig, criterion_forward
from dfine_tpu_torch.train.optim import OptimConfig, build_optimizer
from dfine_tpu_torch.train.train_step import TrainState, bn_statistics, make_train_step
from dfine_tpu_torch.utils.checkpoint import load_jax_variables, state_dict_of

rank, port, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
backend = par.init_multihost(f"localhost:{{port}}", {ranks}, rank, device="cpu")
inp = torch.load(f"{{tmp}}/inputs.pt", weights_only=False)
rows = slice(rank * {per}, (rank + 1) * {per})
rows4 = slice(rank * {per4}, (rank + 1) * {per4})
t = lambda a: torch.from_numpy(np.ascontiguousarray(a))


def collectives(_):
    batch = {{"x": torch.arange(8)[:, None], "t": {{"y": torch.arange(16).reshape(8, 2)}}}}
    mine = par.shard_batch(batch)
    try:
        par.shard_batch({{"x": torch.zeros(7)}})
        refused = None
    except ValueError as e:
        refused = str(e)
    objs = [{{"rank": rank, "i": i, "pad": "x" * (10 + 37 * rank)}} for i in range(2 + rank)]
    par.barrier("collectives")
    layer = torch.nn.Linear(3, 2)
    with torch.no_grad():
        layer.weight.fill_(float(rank + 1))
        layer.bias.fill_(-float(rank + 1))
    par.replicate(layer)
    return {{"x": mine["x"], "y": mine["t"]["y"], "refused": refused,
             "gathered": par.gather_objects(objs), "preds": par.gather_predictions([objs]),
             "scalar": par.broadcast_scalar(123.0 if rank == 0 else -1.0),
             "count": par.process_count(), "index": par.process_index(),
             "main": par.is_main_process(), "backend": backend,
             "replicated": par.unreplicate(layer)}}


def _bn(job):
    bn = BatchNorm2d(job["c"])
    with torch.no_grad():
        for k in ("weight", "bias", "running_mean", "running_var"):
            getattr(bn, k).copy_(t(job[k]))
    return bn.train()


def sync_bn(job):
    bn = _bn(job)
    set_bn_axis("dp")
    try:
        x = t(job["x"][rows4]).requires_grad_()
        y = bn(x)
        (y * t(job["w"][rows4])).sum().backward()
    finally:
        set_bn_axis(None)
    return {{"y": y.detach(), "x_grad": x.grad, "weight_grad": bn.weight.grad,
             "bias_grad": bn.bias.grad, "running_mean": bn.running_mean,
             "running_var": bn.running_var}}


def bn_pmean(job):
    bn = _bn(job)
    with torch.no_grad():
        bn(t(job["x"][rows4]))
    par.all_reduce_mean_(bn_statistics(bn))
    return {{"running_mean": bn.running_mean, "running_var": bn.running_var}}


def criterion(job):
    def tree(x):
        if isinstance(x, dict):
            return {{k: tree(v) for k, v in x.items()}}
        if isinstance(x, list):
            return [tree(v) for v in x]
        return t(x[rows4]) if isinstance(x, np.ndarray) else x

    out = tree(job["outputs"])
    tgt = tree(job["targets"])
    tgt["labels"] = tgt["labels"].long()
    losses = criterion_forward(out, tgt, CriterionConfig(num_classes=job["c"]), axis_name="dp")
    return {{k: float(v) for k, v in losses.items()}}


def step_job(job):
    model = build_model("n", job["c"], False, device="cpu")
    load_jax_variables(model, job["variables"])
    set_bn_axis("dp")
    state = TrainState.create(model, build_optimizer(model, OptimConfig(**job["optim"])))
    step = par.make_dp_train_step(make_train_step(
        CriterionConfig(num_classes=job["c"], losses=job["losses"]), compute_dtype=torch.float32,
        axis_name="dp"))
    out = []
    try:
        for batch, noise in zip(job["batches"], job["noise"]):
            images, targets = batch
            tgt = {{k: t(v[rows]) for k, v in targets.items()}}
            tgt["labels"] = tgt["labels"].long()
            x = t(images[rows].transpose(0, 3, 1, 2))
            _, metrics = step(state, {{"images": x, "targets": tgt}},
                              dn_noise=None if noise is None else noise[rank])
            out.append({{"metrics": {{k: float(v) for k, v in metrics.items()}},
                         "state": state_dict_of(state)}})
    finally:
        set_bn_axis(None)
    return out


JOBS = {{"collectives": collectives, "sync_bn": sync_bn, "bn_pmean": bn_pmean,
         "criterion": criterion, "dp_step": step_job, "accum": step_job}}
res = {{name: JOBS[name](job) for name, job in inp.items()}}
torch.save(res, f"{{tmp}}/rank{{rank}}.pt")
par.shutdown()
print(f"RANK{{rank}}_OK")
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _batch(seed):
    rng = np.random.default_rng(seed)
    images = rng.uniform(size=(B, IMG, IMG, 3)).astype(np.float32)
    targets = {"labels": rng.integers(0, NUM_CLASSES, (B, G)).astype(np.int32),
               "boxes": rng.uniform(0.25, 0.6, (B, G, 4)).astype(np.float32),
               "valid": VALID}
    return images, targets


def _rank_noise(seed):
    """Rank r's CDN draws: JAX's replica r key, fold_in(key(seed), r)."""
    return [jax_cdn_noise(jax.random.fold_in(jax.random.key(seed), r), PER, G, NUM_CLASSES)
            for r in range(RANKS)]


def _bn_inputs():
    rng = np.random.default_rng(11)
    shape = (BN_ROWS, BN_C, *BN_HW)
    return {"c": BN_C, "x": rng.normal(0.5, 2.0, shape).astype(np.float32),
            "w": rng.normal(size=shape).astype(np.float32),
            "weight": rng.uniform(0.8, 1.2, BN_C).astype(np.float32),
            "bias": rng.uniform(-0.1, 0.1, BN_C).astype(np.float32),
            "running_mean": rng.normal(0, 0.1, BN_C).astype(np.float32),
            "running_var": rng.uniform(0.5, 1.5, BN_C).astype(np.float32)}


def _criterion_inputs():
    """A train-mode output tree of 4 images, 2 a rank; rank 0's images hold
    3 and 2 valid GT, rank 1's 1 and 0."""
    rng = np.random.default_rng(8)
    out = random_outputs(7, b=4, q=24, c=NUM_CLASSES, g=G)
    targets = {"labels": rng.integers(0, NUM_CLASSES, (4, G)).astype(np.int32),
               "boxes": rng.uniform(0.2, 0.6, (4, G, 4)).astype(np.float32),
               "valid": np.asarray([[1, 1, 1, 0], [1, 1, 0, 0], [1, 0, 0, 0], [0, 0, 0, 0]],
                                   bool)}
    return {"c": NUM_CLASSES, "outputs": out, "targets": targets}


def _jax_dp_step(jmodel, variables, tx, batches, losses, b_accum_steps=1, update_mask=None):
    """The JAX DP step over a 2-device mesh with SyncBN, the CDN key of
    replica r fold_in(key(DN_KEY_SEED), r); the state and metrics after each
    of ``batches``. ``update_mask``: the step's freeze mask (JAX
    ``freeze_mask``)."""
    import dfine_tpu.models.decoder as jdec
    from dfine_tpu.models.layers import set_bn_axis
    from dfine_tpu.parallel import make_dp_train_step, make_mesh, replicate, shard_batch
    from dfine_tpu.train.criterion import CriterionConfig as JCrit
    from dfine_tpu.train.train_step import TrainState as JState
    from dfine_tpu.train.train_step import make_train_step as jax_step

    orig = jdec.build_cdn_queries

    def pinned(labels, boxes, valid, rng, *a, **k):
        key = jax.random.fold_in(jax.random.key(DN_KEY_SEED), jax.lax.axis_index("dp"))
        return orig(labels, boxes, valid, key, *a, **k)

    mesh = make_mesh(RANKS)
    out = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jdec, "build_cdn_queries", pinned)
        set_bn_axis("dp")
        try:
            step = make_dp_train_step(jax_step(jmodel, tx, JCrit(num_classes=NUM_CLASSES,
                                                                 losses=losses),
                                               axis_name="dp", b_accum_steps=b_accum_steps,
                                               update_mask=update_mask),
                                      mesh)
            # each leaf its own buffer: the flat optimizer's init gives m and v
            # one zeros array, which the step (it donates its state) refuses
            jstate = jax.tree.map(jnp.copy, replicate(JState.create(variables, tx), mesh))
            for images, targets in batches:
                batch = {"images": jnp.asarray(images),
                         "targets": jax.tree.map(jnp.asarray, targets)}
                jstate, jmetrics = step(jstate, shard_batch(batch, mesh), jax.random.key(0))
                out.append((jax.tree.map(np.array, jstate),
                            {k: float(v) for k, v in jmetrics.items()}))
        finally:
            set_bn_axis(None)
    return out


def _jax_bn_pmean(job):
    """flax BatchNorm (the JAX package's settings) on each replica's rows,
    then the running statistics pmean'ed, as the JAX DP step does."""
    import flax.linen as nn
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P

    from dfine_tpu.parallel import make_mesh

    bn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5,
                      dtype=jnp.float32)
    variables = {"params": {"scale": job["weight"], "bias": job["bias"]},
                 "batch_stats": {"mean": job["running_mean"], "var": job["running_var"]}}

    def body(x):
        _, mutated = bn.apply(variables, x, mutable=["batch_stats"])
        return jax.lax.pmean(mutated["batch_stats"], "dp")

    x = jnp.asarray(job["x"].transpose(0, 2, 3, 1))  # NHWC
    stats = jax.jit(shard_map(body, mesh=make_mesh(RANKS), in_specs=(P("dp"),), out_specs=P(),
                              check_rep=False))(x)
    return {k: np.asarray(v) for k, v in stats.items()}


def _jax_criterion(job):
    """The JAX criterion on each replica's rows with axis_name='dp'; each
    replica's losses."""
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P

    from dfine_tpu.parallel import make_mesh
    from dfine_tpu.train.criterion import CriterionConfig as JCrit
    from dfine_tpu.train.criterion import criterion_forward as jcrit

    out = job["outputs"]
    dn_meta = out.pop("dn_meta")
    enc_meta = out.pop("enc_meta")
    keys = None

    def body(outputs, targets):
        nonlocal keys
        losses = jcrit({**outputs, "dn_meta": dn_meta, "enc_meta": enc_meta}, targets,
                       JCrit(num_classes=NUM_CLASSES), axis_name="dp")
        keys = sorted(losses)
        return jnp.stack([losses[k] for k in keys])[None]

    vals = jax.jit(shard_map(body, mesh=make_mesh(RANKS), in_specs=(P("dp"), P("dp")),
                             out_specs=P("dp"), check_rep=False))(
        jax.tree.map(jnp.asarray, out), jax.tree.map(jnp.asarray, job["targets"]))
    out.update(dn_meta=dn_meta, enc_meta=enc_meta)
    return [dict(zip(keys, np.asarray(v).tolist())) for v in vals]


def _single_step(variables, noise):
    """The port's own single-process step on the global batch, SyncBN on
    (one process: the statistics of the whole batch, by the same formula),
    the ranks' CDN draws side by side."""
    from dfine_tpu_torch.models.denoising import CdnNoise
    from dfine_tpu_torch.models.layers import set_bn_axis
    from dfine_tpu_torch.train.criterion import CriterionConfig
    from dfine_tpu_torch.train.optim import OptimConfig, build_optimizer
    from dfine_tpu_torch.train.train_step import TrainState, make_train_step

    port = port_model_from(variables, SIZE, NUM_CLASSES, False)
    state = TrainState.create(port, build_optimizer(port, OptimConfig()))
    step = make_train_step(CriterionConfig(num_classes=NUM_CLASSES, losses=STEP_LOSSES),
                           compute_dtype=torch.float32)
    images, targets = _batch(4)
    tgt = {k: torch.from_numpy(v.copy()) for k, v in targets.items()}
    tgt["labels"] = tgt["labels"].long()
    set_bn_axis("dp")
    try:
        _, metrics = step(state, {"images": torch.from_numpy(images.transpose(0, 3, 1, 2).copy()),
                                  "targets": tgt},
                          dn_noise=CdnNoise(*(torch.cat(f) for f in zip(*noise))))
    finally:
        set_bn_axis(None)
    return state, {k: float(v) for k, v in metrics.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from dfine_tpu.train.optim import OptimConfig as JOpt
    from dfine_tpu.train.optim import build_optimizer as jax_optimizer

    tmp = tmp_path_factory.mktemp("dp")
    jmodel, shapes = jax_template_shapes(SIZE, NUM_CLASSES, False, IMG)
    variables = jax.tree.map(np.asarray, random_variables(shapes, seed=23))
    noise = _rank_noise(DN_KEY_SEED)
    step_kw = dict(c=NUM_CLASSES, variables=variables)
    inputs = {
        "collectives": None, "sync_bn": _bn_inputs(), "bn_pmean": _bn_inputs(),
        "criterion": _criterion_inputs(),
        "dp_step": dict(step_kw, optim={}, losses=STEP_LOSSES, batches=[_batch(4)],
                        noise=[noise]),
        "accum": dict(step_kw, optim={"b_accum_steps": 2}, losses=FULL_LOSSES,
                      batches=[_batch(4), _batch(8)], noise=[noise] * 2),
    }
    torch.save(inputs, tmp / "inputs.pt")
    code = WORKER.format(repo=str(REPO), ranks=RANKS, per=PER, per4=BN_ROWS // RANKS)
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), str(port), str(tmp)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(RANKS)]
    try:  # the references while the ranks run
        ref = {"dp_step": _jax_dp_step(jmodel, variables,
                                       jax_optimizer(variables["params"], JOpt()),
                                       inputs["dp_step"]["batches"], STEP_LOSSES),
               "accum": _jax_dp_step(jmodel, variables,
                                     jax_optimizer(variables["params"], JOpt(b_accum_steps=2)),
                                     inputs["accum"]["batches"], FULL_LOSSES, b_accum_steps=2),
               "bn_pmean": _jax_bn_pmean(inputs["bn_pmean"]),
               "criterion": _jax_criterion(inputs["criterion"]),
               "single": _single_step(variables, noise)}
    finally:
        outs = [p.communicate(timeout=600) for p in procs]
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"RANK{r}_OK" in out, f"rank {r}:\n{err[-4000:]}"
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(RANKS)]
    return {"inputs": inputs, "ref": ref, "ranks": ranks, "variables": variables, "tmp": tmp}


def _port_state(variables, saved, optim, path):
    """A port model, TrainState and optimizer filled from a rank's
    ``state_dict_of`` (written to ``path``)."""
    from dfine_tpu_torch.train.optim import OptimConfig, build_optimizer
    from dfine_tpu_torch.train.train_step import TrainState
    from dfine_tpu_torch.utils.checkpoint import restore_state

    port = port_model_from(variables, SIZE, NUM_CLASSES, False)
    before = port_view(port, variables)
    state = TrainState.create(port, build_optimizer(port, OptimConfig(**optim)))
    torch.save(saved, path)
    restore_state(path, state)
    return port, state, before


def _ranks_equal(a, b):
    """Both ranks' parameters, buffers, EMA and AdamW state bit-equal."""
    for part in ("model", "ema"):
        for k, v in a[part].items():
            assert torch.equal(v, b[part][k]), (part, k)
    for i, s in a["adamw"]["state"].items():
        for k, v in s.items():
            assert torch.equal(v, b["adamw"]["state"][i][k]), (i, k)


def test_collectives(runs):
    """shard_batch keeps rank r's rows [2r, 2r + 2) of every leaf and refuses
    a batch that does not divide; gather_objects and gather_predictions are
    ordered by rank; broadcast_scalar gives rank 0's value; replicate gives
    every rank rank 0's parameters (unreplicate: their CPU copies); the
    backend is gloo on the CPU."""
    for r, res in enumerate(runs["ranks"]):
        c = res["collectives"]
        assert torch.equal(c["x"], torch.arange(8)[4 * r: 4 * r + 4, None])
        assert torch.equal(c["y"], torch.arange(16).reshape(8, 2)[4 * r: 4 * r + 4])
        assert "does not divide" in c["refused"]
        assert [(o["rank"], o["i"]) for o in c["gathered"]] == [(0, 0), (0, 1), (1, 0), (1, 1),
                                                                 (1, 2)]
        assert c["preds"] == c["gathered"] and c["scalar"] == 123.0
        assert (c["count"], c["index"], c["main"], c["backend"]) == (2, r, r == 0, "gloo")
        assert torch.equal(c["replicated"]["weight"], torch.ones(2, 3))
        assert torch.equal(c["replicated"]["bias"], -torch.ones(2))


def test_sync_bn_matches_global_batch_bn(runs):
    """SyncBN on 2 x 2 rows against the port's BatchNorm2d over all 4 rows
    (two-pass variance there): outputs and input gradients atol 1e-5, the
    scale and bias gradients summed over the ranks rtol 1e-5 (each rank's
    backward all-reduces the statistics' gradients), the running statistics
    (biased variance, flax's momentum) equal on both ranks and atol 1e-6."""
    from dfine_tpu_torch.models.layers import BatchNorm2d

    job = runs["inputs"]["sync_bn"]
    bn = BatchNorm2d(BN_C).train()
    with torch.no_grad():
        for k in ("weight", "bias", "running_mean", "running_var"):
            getattr(bn, k).copy_(torch.from_numpy(job[k]))
    x = torch.from_numpy(job["x"]).requires_grad_()
    y = bn(x)
    (y * torch.from_numpy(job["w"])).sum().backward()
    got = [res["sync_bn"] for res in runs["ranks"]]
    np.testing.assert_allclose(torch.cat([g["y"] for g in got]).numpy(), y.detach().numpy(),
                               atol=1e-5)
    np.testing.assert_allclose(torch.cat([g["x_grad"] for g in got]).numpy(), x.grad.numpy(),
                               atol=1e-5)
    for k in ("weight_grad", "bias_grad"):
        ref = getattr(bn, k.split("_")[0]).grad.numpy()
        np.testing.assert_allclose(sum(g[k] for g in got).numpy(), ref, rtol=1e-5, atol=1e-5)
    for k in ("running_mean", "running_var"):
        assert torch.equal(got[0][k], got[1][k])
        np.testing.assert_allclose(got[0][k].numpy(), getattr(bn, k).detach().numpy(), atol=1e-6)


def test_bn_statistics_average_matches_jax_pmean(runs):
    """SyncBN off: each rank's BatchNorm statistics of its own rows, then
    averaged over the ranks, against flax BatchNorm per replica and
    ``pmean`` (atol 1e-6)."""
    ref = runs["ref"]["bn_pmean"]
    for res in runs["ranks"]:
        got = res["bn_pmean"]
        np.testing.assert_allclose(got["running_mean"].numpy(), ref["mean"], atol=1e-6)
        np.testing.assert_allclose(got["running_var"].numpy(), ref["var"], atol=1e-6)


def test_criterion_normalizers_with_unequal_gt(runs):
    """The criterion on each rank's rows (5 valid GT on rank 0, 1 on rank 1)
    with axis_name='dp' against the JAX criterion under shard_map: every
    loss term of each rank at rtol 1e-4 (the box normalizers are the mean
    over ranks; per rank they would differ by 5x)."""
    for r, res in enumerate(runs["ranks"]):
        got, ref = res["criterion"], runs["ref"]["criterion"][r]
        assert set(got) == set(ref), set(got) ^ set(ref)
        for k, v in ref.items():
            np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=1e-7, err_msg=(r, k))


def test_dp_step_matches_jax_dp_step(runs):
    """One 2-rank step (SyncBN, n detect, vfl and boxes) against the JAX step
    under shard_map over make_mesh(2) from the same weights, global batch
    and per-replica CDN noise, by ``check_step``'s rules on each rank; both
    ranks bit-equal after it."""
    jstate, jmetrics = runs["ref"]["dp_step"][0]
    saved = [res["dp_step"][0] for res in runs["ranks"]]
    _ranks_equal(saved[0]["state"], saved[1]["state"])
    for r, s in enumerate(saved):
        port, state, before = _port_state(runs["variables"], s["state"], {},
                                          runs["tmp"] / f"dp_step{r}.ckpt")
        assert state.step == 1
        check_step(port, state, s["metrics"], jstate, jmetrics, before)


def test_accumulated_dp_micro_steps_match_multisteps(runs):
    """Two micro-steps with ``b_accum_steps = 2`` on two global batches
    (every loss, DDF's per-rank weights too),
    against ``optax.MultiSteps`` inside the JAX DP step (a pmean of each
    micro-step's gradients): after the first, the metrics at rtol 1e-4
    (grad_norm 1e-3) and no update; after the second, ``check_step``'s
    rules; both ranks bit-equal."""
    (_, jm0), (jstate, jmetrics) = runs["ref"]["accum"]
    for r, res in enumerate(runs["ranks"]):
        first, second = res["accum"]
        for k, v in jm0.items():
            np.testing.assert_allclose(first["metrics"][k], v, rtol=1e-3 if k == "grad_norm"
                                       else 1e-4, err_msg=k)
        assert first["state"]["mini_step"] == 1 and first["state"]["count"] == 0
        assert second["state"]["mini_step"] == 0 and second["state"]["count"] == 1
        port, state, before = _port_state(runs["variables"], second["state"],
                                          {"b_accum_steps": 2}, runs["tmp"] / f"accum{r}.ckpt")
        assert int(jstate.opt_state.gradient_step) == 1 and state.step == 2
        check_step(port, state, second["metrics"], jstate, jmetrics, before)
    _ranks_equal(runs["ranks"][0]["accum"][1]["state"], runs["ranks"][1]["accum"][1]["state"])


def test_dp_step_matches_single_process_step(runs):
    """The 2-rank step against the port's single-process step on the 4-row
    global batch (SyncBN on, the ranks' CDN draws side by side), at
    tests/test_multichip.py's tolerances: loss rtol 1e-5, grad_norm rtol
    1e-4, parameters rtol 1e-4 / atol 1e-5; the BatchNorm statistics atol
    1e-5, their counters equal. AdamW's first step moves an element by
    lr * g / (|g| + 1e-8), about lr = 2e-5 with the sign of its gradient;
    where a gradient is one of rounding (a conv ahead of a train-mode
    BatchNorm at random weights: its gradient cancels, and the two sides
    sum the batch in other orders) the element may step another way. So,
    by ``check_step``'s bound, every element is within 2 lr + 2e-6 and at
    most 0.5 % of them beyond the tolerance."""
    state, metrics = runs["ref"]["single"]
    ref = state.model.state_dict()
    lr = 2e-5
    for res in runs["ranks"]:
        got = res["dp_step"][0]
        np.testing.assert_allclose(got["metrics"]["loss"], metrics["loss"], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got["metrics"]["grad_norm"], metrics["grad_norm"], rtol=1e-4,
                                   atol=1e-6)
        far, n_el = 0, 0
        for k, v in got["state"]["model"].items():
            if k.endswith("num_batches_tracked"):
                assert torch.equal(v, ref[k]), k
            elif k.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(v.numpy(), ref[k].numpy(), atol=1e-5, err_msg=k)
            else:
                assert (v - ref[k]).abs().max() <= 2 * lr + 2e-6, k
                far += int((~torch.isclose(v, ref[k], rtol=1e-4, atol=1e-5)).sum())
                n_el += v.numel()
        assert far <= 0.005 * n_el, (far, n_el)
