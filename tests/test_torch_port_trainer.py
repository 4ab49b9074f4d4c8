"""The port's trainer entry point on the CPU, n det+seg at 320 px on an
8-image synthetic dataset (6 train, 2 val): a 2-epoch run and its files, an
exact resume, serving a trainer checkpoint, the offline pretrained weights,
``train.dp`` with one process, and the raises (no CUDA, a JAX orbax
state). Its eval against
the JAX composition: ``test_torch_port_trainer_eval.py``."""

import json
import math
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from test_torch_port_helpers import write_dataset

REPO = Path(__file__).resolve().parents[1]
IMG, NUM_CLASSES = 320, 3


def _overrides(root: Path, name: str, **extra):
    kw = {"train.root": str(root), "train.path_to_save": str(root / name), "model_name": "n",
          "task": "segment", "train.img_size": f"[{IMG}, {IMG}]", "train.batch_size": 2,
          "train.epochs": 2, "train.num_workers": 2, "train.max_gt": 8,
          "train.label_to_name": "{0: a, 1: b, 2: c}", "train.dtype": "float32",
          "train.pretrained_model_path": "", "train.conf_thresh": 0.005,
          "train.mosaic_augs.mosaic_prob": 0.5,
          "train.mosaic_augs.no_mosaic_epochs": 1, "train.cache_images_mb": 16,
          "train.eval_preds_path": str(root / name / "previews"), **extra}
    return [f"{k}={v}" for k, v in kw.items()]


def _config(root: Path, name: str, **extra):
    from dfine_tpu_torch.config import load_config

    return load_config(REPO / "config.yaml", _overrides(root, name, **extra))


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("project")
    write_dataset(root / "data" / "dataset", 8, (90, 120), seed=3, n_val=2)
    return root


@pytest.fixture(scope="module")
def straight(root):
    """Two epochs in one run (fp32)."""
    from dfine_tpu_torch.train.trainer import Trainer

    trainer = Trainer(_config(root, "straight"), device="cpu")
    final = trainer.train()
    return trainer, final


def test_two_epoch_segment_run(straight):
    """Its files, finite metrics, both epochs in metrics.csv, the plots and
    the previews, the sidecar, the per-step and per-eval timings."""
    import csv

    trainer, final = straight
    out = trainer.path_to_save
    assert trainer.failure is None
    assert {"last.ckpt", "best.ckpt", "last.meta.json", "best.meta.json", "metrics.csv",
            "extended_metrics.csv", "config.yaml", "train_log.txt", "plots"} <= \
        {p.name for p in out.iterdir()}
    with open(out / "metrics.csv", newline="") as f:
        rows = list(csv.DictReader(f))
    assert [int(r["epoch"]) for r in rows] == [0, 1]
    assert all(math.isfinite(float(r[k])) for r in rows for k in ("loss", "decision", "f1"))
    assert set(final) == {"val"} and "mAP_50_mask" in final["val"]
    assert all(math.isfinite(v) for v in final["val"].values() if isinstance(v, float))
    assert json.loads((out / "best.meta.json").read_text())["best_metric"] == trainer.best_metric
    assert trainer.plot_writer == "matplotlib" and (out / "plots" / "confusion_matrix.csv").exists()
    assert len(list((out / "previews").glob("*.png"))) == 2
    assert len(trainer.timing["step_s"]) == 6 and len(trainer.timing["eval"]) == 3
    # each step notes whether the loader was still making its epoch's batches
    assert len(trainer.timing["loader_busy"]) == 6 and not trainer.train_iter.producing
    assert [c["tag"] for c in trainer.timing["checkpoint"]][:2] == ["last", "best"]
    assert trainer.state.step == 3  # the final eval reloaded best: epoch 0's


def _assert_states_equal(a, b, path="state"):
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b), path
    elif isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _assert_states_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_states_equal(x, y, f"{path}[{i}]")
    else:
        assert a == b, path


def test_resume_is_exact(root, straight):
    """One epoch, an interrupt, a fresh trainer with ``train.resume`` for
    the second: its ``last`` equals the straight run's bit for bit (model,
    EMA, AdamW's moments and steps, the counts, the CDN generator)."""
    from dfine_tpu_torch.train.trainer import Trainer
    from dfine_tpu_torch.utils.checkpoint import read_state

    first = Trainer(_config(root, "resumed"), device="cpu")
    set_epoch = first.train_iter.set_epoch

    def stop_at_epoch_1(epoch):
        if epoch == 1:
            raise KeyboardInterrupt
        set_epoch(epoch)

    first.train_iter.set_epoch = stop_at_epoch_1
    first.train()
    assert isinstance(first.failure, KeyboardInterrupt)
    assert read_state(root / "resumed" / "last.ckpt")["step"] == 3
    second = Trainer(_config(root, "resumed", **{"train.resume": True}), device="cpu")
    second.train()
    assert second.failure is None and second.start_epoch == 1
    ours = read_state(root / "resumed" / "last.ckpt")
    ref = read_state(straight[0].path_to_save / "last.ckpt")
    assert ours["step"] == ref["step"] == 6 and ours["count"] == 6
    _assert_states_equal(ours, ref)
    rows = (root / "resumed" / "metrics.csv").read_text().splitlines()
    assert rows[0] == (straight[0].path_to_save / "metrics.csv").read_text().splitlines()[0]
    assert [r.split(",")[0] for r in rows[1:]] == ["0", "1"]


def test_torch_model_serves_a_trainer_checkpoint(straight, tmp_path):
    from dfine_tpu_torch import TorchModel
    from dfine_tpu_torch.infer.base import load_weights
    from dfine_tpu_torch.models.dfine import build_model

    trainer, _ = straight
    served = TorchModel("n", str(trainer.path_to_save / "best.ckpt"), NUM_CLASSES, IMG, IMG,
                        conf_thresh=0.0, half=False, enable_mask_head=True, device="cpu")
    ema = trainer.state.ema.state_dict()  # the final eval reloaded best
    for k, v in served.model.state_dict().items():
        assert torch.equal(v, ema[k]), k
    assert not all(torch.equal(v, trainer.state.model.state_dict()[k]) for k, v in ema.items())
    (tmp_path / "orbax").mkdir()
    with pytest.raises(NotImplementedError, match="orbax"):
        load_weights(build_model("n", NUM_CLASSES, True, device="cpu"), str(tmp_path / "orbax"))


def test_early_stop_and_a_crash_reach_the_final_eval(root):
    """``early_stopping`` 1: epoch 0 improves, epoch 1 does not, the run
    stops there; a step of epoch 1 that raises is logged, kept in
    ``failure``, and the final eval of epoch 0's ``best`` still runs. Eval is
    stubbed: its metrics fall."""
    from dfine_tpu_torch.train.trainer import Trainer

    def stub(trainer, decisions):
        calls = []

        def evaluate(split="val", extended=False, save_previews=False):
            calls.append((split, extended))
            f1 = decisions[min(len(calls), len(decisions)) - 1]
            return {"f1": f1, "mAP_50": f1, "iou": f1, "TPs": 1}

        trainer.evaluate = evaluate
        trainer._last_validator = type("V", (), {"save_plots": lambda *a, **k: "csv"})()
        return calls

    trainer = Trainer(_config(root, "early", **{"train.epochs": 4, "train.early_stopping": 1}),
                      device="cpu")
    calls = stub(trainer, [0.5, 0.4, 0.3])
    final = trainer.train()
    assert trainer.failure is None and calls == [("val", False)] * 2 + [("val", True)]
    assert trainer.state.step == 3 and trainer.best_metric == 0.5 and final["val"]["f1"] == 0.3

    crashing = Trainer(_config(root, "crash"), device="cpu")
    calls = stub(crashing, [0.5])
    steps = []

    def step_then_crash(state, batch, generator=None):
        steps.append(1)
        if len(steps) > len(crashing.train_iter):  # the first step of epoch 1
            raise RuntimeError("boom")
        return state, {"loss": torch.tensor(1.0)}

    crashing.train_step = step_then_crash
    final = crashing.train()
    assert isinstance(crashing.failure, RuntimeError)
    assert calls == [("val", False), ("val", True)] and final["val"]["f1"] == 0.5
    assert "training failed: boom" in (root / "crash" / "train_log.txt").read_text()
    assert (root / "crash" / "extended_metrics.csv").exists()


_CRASHING_CLI = """
import runpy, sys
import dfine_tpu_torch.train.trainer as tr

class CrashingTrainer(tr.Trainer):
    def __init__(self, cfg, device=None):
        super().__init__(cfg, device="cpu")
        self.train_step = self.crash

    @staticmethod
    def crash(*args, **kwargs):
        raise RuntimeError("boom")

tr.Trainer = CrashingTrainer
sys.argv = ["train"] + sys.argv[1:]
runpy.run_module("dfine_tpu_torch.apps.train", run_name="__main__")
"""


def test_cli_exits_nonzero_on_a_crash(root):
    """``python -m dfine_tpu_torch.apps.train`` with a step that raises
    before any eval: the trainer logs it, skips the final eval (there is no
    ``best``, and the random weights are not scored as one) and the command
    exits non-zero with the step's error."""
    proc = subprocess.run([sys.executable, "-c", _CRASHING_CLI, str(REPO / "config.yaml")]
                          + _overrides(root, "cli_crash"),
                          cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and "RuntimeError: boom" in proc.stderr, proc.stderr[-2000:]
    log = (root / "cli_crash" / "train_log.txt").read_text()
    assert "training failed: boom" in log and "the final eval is skipped" in log
    assert not (root / "cli_crash" / "extended_metrics.csv").exists()


def test_dp_and_no_cuda_raise(root):
    """``train.dp.enabled`` with one process: data parallelism is off and the
    log says so; ``train.dp.multihost`` with one process joins a one-rank
    group (gloo on the CPU) and stays off too. Without CUDA the trainer and
    the entry point raise."""
    import socket

    from dfine_tpu_torch.parallel import dp as par
    from dfine_tpu_torch.train.trainer import Trainer

    trainer = Trainer(_config(root, "dp", **{"train.dp.enabled": True}), device="cpu")
    assert not trainer.dp_enabled and trainer.world == 1
    assert "data parallelism is off" in (root / "dp" / "train_log.txt").read_text()
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    try:
        mh = Trainer(_config(root, "dp_mh", **{
            "train.dp.enabled": True, "train.dp.multihost.enabled": True,
            "train.dp.multihost.coordinator_address": f"localhost:{port}",
            "train.dp.multihost.num_processes": 1}), device="cpu")
        assert par.backend() == "gloo" and mh.world == 1 and not mh.dp_enabled
    finally:
        par.shutdown()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            Trainer(_config(root, "card"))
        # the entry point, as a user runs it: the card or a raise
        proc = subprocess.run([sys.executable, "-m", "dfine_tpu_torch.apps.train",
                               str(REPO / "config.yaml")] + _overrides(root, "cli"),
                              cwd=REPO, capture_output=True, text=True, timeout=300)
        assert proc.returncode != 0 and "CUDA" in proc.stderr, proc.stderr[-2000:]


def test_pretrained_is_offline(tmp_path, monkeypatch):
    """"auto" with nothing staged: unavailable (random init); a staged
    stage-1 file fills the backbone; a whole-model .pth goes through
    ``load_torch_checkpoint``; the port never names urllib."""
    from dfine_tpu_torch.models.dfine import build_model
    from dfine_tpu_torch.utils.pretrained import load_pretrained, resolve_pretrained

    monkeypatch.setenv("DFINE_WEIGHTS_DIR", str(tmp_path))
    assert resolve_pretrained("auto", "n") is None
    assert resolve_pretrained("https://example.invalid/x/PPHGNetV2_B0_stage1.pth", "n") is None
    assert resolve_pretrained(str(tmp_path / "missing.pth"), "n") is None
    src = build_model("n", NUM_CLASSES, True, device="cpu")
    with torch.no_grad():
        for p in src.parameters():
            p.add_(1.0)
    torch.save(src.backbone.state_dict(), tmp_path / "PPHGNetV2_B0_stage1.pth")
    staged = resolve_pretrained("auto", "n")
    assert staged == tmp_path / "PPHGNetV2_B0_stage1.pth"
    dst = load_pretrained(staged, build_model("n", NUM_CLASSES, True, device="cpu"))
    for k, v in src.backbone.state_dict().items():
        assert torch.equal(dst.backbone.state_dict()[k], v), k
    assert not torch.equal(dst.decoder.enc_score_head.weight, src.decoder.enc_score_head.weight)
    torch.save({"model": src.state_dict()}, tmp_path / "whole.pth")
    whole = load_pretrained(tmp_path / "whole.pth", build_model("n", NUM_CLASSES, True,
                                                                 device="cpu"))
    for k, v in src.state_dict().items():
        assert torch.equal(whole.state_dict()[k], v), k
    assert not any("urllib" in p.read_text() for p in (REPO / "dfine_tpu_torch").rglob("*.py"))


def test_logging_and_profiling_helpers(tmp_path, monkeypatch):
    """``MetricsCSV`` keeps a resumed file's header; ``WandbGate`` is off
    unless enabled and wandb imports, and its ``watch`` logs one histogram
    per top-level module; ``trace`` (a Chrome trace of the region holding
    the program's spans) and ``device_memory_stats`` (empty without CUDA)."""
    import types

    from dfine_tpu_torch.utils.logging import MetricsCSV, WandbGate
    from dfine_tpu_torch.utils.profiling import device_memory_stats, span, trace

    MetricsCSV(tmp_path / "m.csv").log({"epoch": 0, "loss": torch.tensor(1.5)})
    MetricsCSV(tmp_path / "m.csv").log({"epoch": 1, "extra": 3, "loss": 0.5})
    assert (tmp_path / "m.csv").read_text().splitlines() == ["epoch,loss", "0,1.5", "1,0.5"]

    logged = []
    run = types.SimpleNamespace(log=lambda d, step=None: logged.append((step, d)),
                                finish=lambda: logged.append("finish"))
    fake = types.SimpleNamespace(init=lambda **kw: run, Histogram=lambda x: ("hist", len(x)))
    monkeypatch.setitem(sys.modules, "wandb", fake)
    assert WandbGate(False, "p", "e", {}).run is None
    gate = WandbGate(True, "p", "e", {})
    model = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.Linear(4, 2))
    gate.watch(model, grad_norm=2.0, step=5)
    gate.finish()
    assert logged[0][0] == 5 and logged[0][1]["grad_norm"] == 2.0
    assert logged[0][1]["params/0"] == ("hist", 16) and logged[0][1]["params/1"] == ("hist", 10)
    assert logged[-1] == "finish"

    with trace(tmp_path / "trace"):
        with span("train.step", root=0):
            torch.ones(8).sum()
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]
    step = [e for e in events if e.get("name") == "train.step"]
    assert step and any(e.get("name") == "aten::sum" and step[0]["ts"] <= e["ts"]
                        for e in events)
    if not torch.cuda.is_available():
        assert device_memory_stats() == []
