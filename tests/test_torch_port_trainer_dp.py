"""The port's trainer under data parallelism on the CPU: two processes, each
``python -m dfine_tpu_torch.apps.train``'s ``main`` with
``train.dp.multihost.enabled`` and its own ``process_id`` (gloo), n det+seg
at 320 px, fp32, one epoch on a 10-image synthetic dataset (6 train, 4
val), then both resumed for a second epoch. The workers import the port
only."""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_port_helpers import write_dataset

REPO = Path(__file__).resolve().parents[1]
IMG, RANKS = 320, 2

WORKER = r"""
import json, os, sys
sys.path.insert(0, {repo!r})
import torch

torch.set_num_threads(2)
import dfine_tpu_torch.apps.train as app
from dfine_tpu_torch.parallel import dp as par
from dfine_tpu_torch.train import trainer as tr

rank, out, run_dir = int(sys.argv[1]), sys.argv[2], os.path.realpath(sys.argv[3])
argv = sys.argv[4:] + [f"train.dp.multihost.process_id={{rank}}"]
writes = []


def audit(event, args):
    # every file this process opens for writing in the run directory
    if event == "open" and isinstance(args[0], str):
        path = os.path.realpath(args[0])
        flags = args[2] if isinstance(args[2], int) else 0
        mode = args[1] or ""
        if path.startswith(run_dir) and (any(c in mode for c in "wax+")
                                         or flags & (os.O_WRONLY | os.O_RDWR | os.O_CREAT)):
            writes.append(path)


sys.addaudithook(audit)
save = torch.save  # writes through its own file writer, which the hook does not see


def counted_save(obj, f, *args, **kwargs):
    audit("open", (str(f), "wb", 0))
    return save(obj, f, *args, **kwargs)


torch.save = counted_save
gathered = []
gather = par.gather_objects
par.gather_objects = lambda local: gathered.append(gather(local)) or gathered[-1]
seen = {{}}


class Kept(tr.Trainer):
    def __init__(self, cfg, device=None):
        super().__init__(cfg, device)
        seen.update(trainer=self, start_step=self.state.step)

    def _train_epochs(self):
        super()._train_epochs()  # the state at the end of training, before the final eval
        seen.update(start_epoch=self.start_epoch, world=self.world, dp=self.dp_enabled,
                    sync_bn=self.sync_bn, backend=par.backend(), step=self.state.step,
                    count=self.state.optimizer.count,
                    model={{k: v.clone() for k, v in self.state.model.state_dict().items()}},
                    ema={{k: v.clone() for k, v in self.state.ema.state_dict().items()}})

    def train(self):
        seen["final"] = super().train()
        return seen["final"]


app.Trainer = Kept
app.main(argv, device="cpu")
ids = [sorted(i for i, _ in g) for g in gathered if g and isinstance(g[0], tuple)]
torch.save({{k: v for k, v in seen.items() if k != "trainer"}} | {{"writes": writes, "ids": ids}},
           f"{{out}}/rank{{rank}}.pt")
print(f"RANK{{rank}}_OK")
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _overrides(root: Path, **extra):
    kw = {"train.root": str(root), "train.path_to_save": str(root / "run"), "model_name": "n",
          "task": "segment", "train.img_size": f"[{IMG}, {IMG}]", "train.batch_size": 2,
          "train.epochs": 1, "train.num_workers": 2, "train.max_gt": 8,
          "train.label_to_name": "{0: a, 1: b, 2: c}", "train.dtype": "float32",
          "train.pretrained_model_path": "", "train.conf_thresh": 0.005,
          "train.mosaic_augs.mosaic_prob": 0.0, "train.cache_images_mb": 16,
          "train.eval_preds_path": str(root / "run" / "previews"), **extra}
    return [f"{k}={v}" for k, v in kw.items()]


def _dp_overrides(root: Path, port: int, **extra):
    return _overrides(root, **{"train.dp.enabled": True, "train.dp.n_devices": 1,
                               "train.dp.multihost.enabled": True,
                               "train.dp.multihost.coordinator_address": f"localhost:{port}",
                               "train.dp.multihost.num_processes": RANKS, **extra})


def _run_ranks(root: Path, out: Path, argv):
    out.mkdir()
    code = WORKER.format(repo=str(REPO))
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), str(out), str(root / "run"),
                               str(REPO / "config.yaml"), *argv],
                              cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(RANKS)]
    outs = [p.communicate(timeout=600) for p in procs]
    for r, (p, (o, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"RANK{r}_OK" in o, f"rank {r}:\n{err[-4000:]}"
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(RANKS)], outs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("project")
    write_dataset(root / "data" / "dataset", 10, (90, 120), seed=3, n_val=4)
    first, logs = _run_ranks(root, root / "out1", _dp_overrides(root, _free_port()))
    files = sorted(p.name for p in (root / "run").iterdir())
    last = (root / "run" / "last.ckpt").read_bytes()
    metrics_csv = (root / "run" / "metrics.csv").read_text()
    resumed, _ = _run_ranks(root, root / "out2", _dp_overrides(
        root, _free_port(), **{"train.resume": True, "train.epochs": 2}))
    return {"root": root, "first": first, "resumed": resumed, "files": files, "last": last,
            "metrics_csv": metrics_csv, "logs": logs}


def test_two_ranks_train_alike(runs):
    """Both ranks ran DP (gloo on the CPU, SyncBN: a rank's batch is 1) and
    end with bit-equal parameters, buffers and EMA, at the same step."""
    a, b = runs["first"]
    for r in (a, b):
        assert (r["world"], r["dp"], r["sync_bn"], r["backend"]) == (RANKS, True, True, "gloo")
        assert r["start_step"] == 0 and r["step"] == 3 and r["count"] == 3
    for part in ("model", "ema"):
        for k, v in a[part].items():
            assert torch.equal(v, b[part][k]), (part, k)
    assert "backend gloo" in runs["logs"][0][0]
    # the checkpoint keeps each rank's CDN generator, so each resumes its own
    import io

    gens = torch.load(io.BytesIO(runs["last"]), weights_only=True)["rank_generators"]
    assert len(gens) == RANKS and not torch.equal(gens[0], gens[1])


def test_only_rank0_writes(runs):
    """The run's files are rank 0's: rank 1 opened no file of the run
    directory for writing (an audit hook saw every open, and every
    ``torch.save``)."""
    a, b = runs["first"]
    assert b["writes"] == [], b["writes"]
    assert any(p.endswith("last.ckpt.tmp") for p in a["writes"])
    assert {"last.ckpt", "best.ckpt", "last.meta.json", "best.meta.json", "metrics.csv",
            "extended_metrics.csv", "config.yaml", "train_log.txt", "plots",
            "previews"} <= set(runs["files"])
    assert len(runs["metrics_csv"].strip().splitlines()) == 2  # the header and one epoch


def test_gathered_eval_matches_single_process_eval(runs):
    """Each eval's gather covers the 4 val images once, in image order, on
    both ranks; the final metrics (best = last after one epoch) equal a
    single-process ``Trainer.evaluate`` of ``last.ckpt`` (rtol 1e-6)."""
    from dfine_tpu_torch.config import load_config
    from dfine_tpu_torch.train.trainer import Trainer

    a, b = runs["first"]
    for r in (a, b):
        assert r["ids"] and all(ids == list(range(4)) for ids in r["ids"]), r["ids"]
    assert a["final"] == b["final"]
    root = runs["root"]
    (root / "single").mkdir()
    (root / "single" / "last.ckpt").write_bytes(runs["last"])
    trainer = Trainer(load_config(REPO / "config.yaml", _overrides(
        root, **{"train.path_to_save": str(root / "single")})), device="cpu")
    trainer.load_checkpoint("last")
    ref = trainer.evaluate("val", extended=True)
    got = dict(a["final"]["val"])
    assert set(got) == set(ref) - {"extended_metrics"}
    for k, v in got.items():
        if isinstance(v, float):
            np.testing.assert_allclose(v, ref[k], rtol=1e-6, atol=1e-9, err_msg=k)
        else:
            assert v == ref[k], k


def test_resume_carries_the_step(runs):
    """Both ranks resumed from ``last`` at epoch 1, step 3, took 3 more
    steps and stayed bit-equal; metrics.csv gained the second epoch and
    the sidecar kept best_metric."""
    a, b = runs["resumed"]
    for r in (a, b):
        assert (r["start_step"], r["start_epoch"], r["step"], r["count"]) == (0, 1, 6, 6)
    for k, v in a["model"].items():
        assert torch.equal(v, b["model"][k]), k
    run = runs["root"] / "run"
    rows = (run / "metrics.csv").read_text().strip().splitlines()
    assert len(rows) == 3 and rows[2].startswith("1,")
    assert json.loads((run / "last.meta.json").read_text())["best_metric"] >= -1.0


_SPAWNED = r"""
import sys
sys.path.insert(0, {repo!r})
import torch

torch.set_num_threads(2)
from dfine_tpu_torch.apps import train as app

app.main(sys.argv[1:], device="cpu")
"""


def test_spawned_ranks_one_per_device(tmp_path):
    """``train.dp.enabled`` without ``multihost``: ``apps.train.main``
    spawns ``train.dp.n_devices`` ranks (on the CPU that many; on a host
    with cards one a card) meeting on a free local port, which train an
    epoch data-parallel (n detect, batch 2) and write the run's files."""
    write_dataset(tmp_path / "data" / "dataset", 10, (90, 120), seed=3, n_val=4)
    argv = [str(REPO / "config.yaml"), *_overrides(tmp_path, **{
        "task": "detect", "train.dp.enabled": True, "train.dp.n_devices": RANKS})]
    env = {**os.environ, "OMP_NUM_THREADS": "2"}  # the spawned ranks' torch threads
    proc = subprocess.run([sys.executable, "-c", _SPAWNED.format(repo=str(REPO)), *argv],
                          cwd=REPO, capture_output=True, text=True, timeout=600, env=env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.count("data parallelism: 2 ranks of 1 rows, backend gloo") == RANKS
    run = tmp_path / "run"
    assert {"last.ckpt", "best.ckpt", "metrics.csv", "extended_metrics.csv"} <= \
        {p.name for p in run.iterdir()}
    assert "data parallelism: 2 ranks" in (run / "train_log.txt").read_text()
