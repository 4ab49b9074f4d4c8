"""The port's apps (``dfine_tpu_torch.apps``) on the CPU: ``run_images``,
``check_results`` and ``test_model`` against the JAX apps' with one stub
model (fixed per-image results, the same for both); every app's ``main``
end to end at n@320 on a few synthetic frames from a ``Trainer``
checkpoint; and the raises (no CUDA, videos, a failed bench backend).
``quant``'s ranking, reverts and artifact against JAX's:
``test_torch_port_apps_quant.py``.

The app modules are imported as modules: ``bench.test_model`` and the
``test_batching`` module would otherwise be collected as tests."""

import csv
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_port_helpers import write_dataset
from test_torch_port_trainer import IMG, _overrides

REPO = Path(__file__).resolve().parents[1]
NAMES = {0: "a", 1: "b", 2: "c"}
APPS = ("export", "infer", "bench", "check_errors", "quant", "test_batching", "demo")
METRIC_ATOL = 1e-9


def _files(root: Path, suffix=None):
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file() and (suffix is None or p.suffix == suffix)}


class Stub:
    """A serving backend's contract with fixed answers: the ``i``-th call
    returns ``results[i]`` (copied); ``mask2poly`` is the package's own."""

    def __init__(self, results, mask2poly=None):
        self.results, self.calls = results, 0
        self.mask2poly = mask2poly

    def __call__(self, img):
        res = {k: v.copy() for k, v in self.results[self.calls].items()}
        self.calls += 1
        return [res]


def _random_result(rng, h, w, masks: bool):
    """2-6 detections, one label outside the class names, boxes partly
    over the frame's edge; masks with one or two parts each."""
    n = int(rng.integers(2, 7))
    xy = rng.uniform([-8, -8], [w * 0.7, h * 0.7], (n, 2))
    wh = rng.uniform(6, 40, (n, 2))
    res = {"boxes": np.concatenate([xy, xy + wh], 1).astype(np.float32),
           "labels": rng.integers(0, 4, n).astype(np.int64),
           "scores": rng.uniform(0.5, 1, n).astype(np.float32)}
    if masks:
        yy, xx = np.mgrid[:h, :w]
        m = np.zeros((n, h, w), np.uint8)
        for i in range(n):
            for _ in range(1 + i % 2):
                cy, cx = rng.uniform(5, h - 5), rng.uniform(5, w - 5)
                ry, rx = rng.uniform(2, h / 4), rng.uniform(2, w / 4)
                m[i] |= (((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1).astype(np.uint8)
        res["masks"] = m
    return res


def _frames(root: Path, n: int, seed: int):
    import cv2

    rng = np.random.default_rng(seed)
    root.mkdir(parents=True)
    paths = []
    for i in range(n):
        img = cv2.GaussianBlur(rng.integers(0, 256, (70 + 8 * i, 96, 3), dtype=np.uint8), (5, 5), 0)
        paths.append(root / f"f{i}.{'jpg' if i % 2 else 'png'}")
        cv2.imwrite(str(paths[-1]), img)
    return paths


@pytest.mark.parametrize("segment,paddings", [(False, {"w": 0.05, "h": 0.1}),
                                              (True, {"w": 7, "h": 3})])
def test_run_images_matches_jax(tmp_path, segment, paddings):
    """Annotations (boxes, or a polygon line per contour) and labels.txt
    byte-equal, the same crop files."""
    import cv2

    from dfine_tpu.apps import infer as jax_infer
    from dfine_tpu.infer.base import BaseServing as JaxServing

    from dfine_tpu_torch.apps import infer as infer_app
    from dfine_tpu_torch.infer.base import BaseServing

    paths = _frames(tmp_path / "in", 4, seed=1)
    rng = np.random.default_rng(2)
    results = [_random_result(rng, *cv2.imread(str(p)).shape[:2], segment) for p in paths]
    jax_infer.run_images(Stub(results, JaxServing.mask2poly), paths, tmp_path / "jax", NAMES,
                         segment, True, paddings)
    infer_app.run_images(Stub(results, BaseServing.mask2poly), paths, tmp_path / "port", NAMES,
                         segment, True, paddings)
    ref, ours = _files(tmp_path / "jax"), _files(tmp_path / "port")
    assert set(ours) == set(ref)
    texts = [k for k in ref if k.endswith(".txt")]
    assert len(texts) == 5 and all(ours[k] == ref[k] for k in texts)
    assert len([k for k in ref if k.startswith("crops/")]) > 10
    if segment:  # more polygon lines than instances: the two-part masks
        lines = sum(ours[k].count(b"\n") for k in texts if k.startswith("annotations"))
        assert lines > sum(len(r["labels"]) for r in results)


def _datasets(root: Path, task: str):
    """The JAX package's and the port's bench-mode datasets over the same
    frames (6 PNG frames, 2 in val)."""
    from dfine_tpu.data.dataset import DatasetConfig as JaxConfig
    from dfine_tpu.data.dataset import DetectionDataset as JaxDataset

    from dfine_tpu_torch.data.dataset import DatasetConfig, DetectionDataset

    names = write_dataset(root, 6, (90, 120), seed=3, n_val=2)
    kw = dict(img_size=(IMG, IMG), task=task, max_gt=8)
    return (JaxDataset(root, names, JaxConfig(**kw), mode="bench"),
            DetectionDataset(root, names, DatasetConfig(**kw), mode="bench"))


def _gt_results(ds, seed: int):
    """Predictions made from each frame's ground truth: most boxes kept and
    moved a little, some relabelled or dropped, plus false positives."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(len(ds)):
        raw = ds.load_raw(i)
        h, w = raw["image"].shape[:2]
        boxes, labels = raw["boxes"].copy(), raw["labels"].astype(np.int64).copy()
        keep = rng.uniform(size=len(boxes)) > 0.2
        boxes = boxes[keep] + rng.normal(0, 1.5, (keep.sum(), 4)).astype(np.float32)
        labels = labels[keep]
        flip = rng.uniform(size=len(labels)) < 0.2
        labels[flip] = (labels[flip] + 1) % 3
        extra = _random_result(rng, h, w, False)
        out.append({"boxes": np.concatenate([boxes, extra["boxes"]]).astype(np.float32),
                    "labels": np.concatenate([labels, extra["labels"] % 3]),
                    "scores": rng.uniform(0.5, 1, len(labels) + len(extra["labels"]))
                    .astype(np.float32)})
    return out


def test_check_results_matches_jax(tmp_path, capsys):
    from dfine_tpu.apps import check_errors as jax_check

    from dfine_tpu_torch.apps import check_errors as check_app

    jds, ds = _datasets(tmp_path / "data", "detect")
    results = _gt_results(ds, seed=4)
    jax_check.check_results(Stub(results), jds, NAMES, 0.5, tmp_path / "jax", "train")
    counts = check_app.check_results(Stub(results), ds, NAMES, 0.5, tmp_path / "port", "train")
    ref, ours = _files(tmp_path / "jax"), _files(tmp_path / "port")
    assert set(ours) == set(ref)
    assert counts["fp"] == len([k for k in ours if "/FP/" in k]) > 0
    assert counts["fn"] == len([k for k in ours if "/FN/" in k]) > 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].split(" -> ")[0] == out[1].split(" -> ")[0]


def test_bench_test_model_matches_jax(tmp_path):
    """F1, precision, recall and IoU of the same answers within 1e-9; the
    first 10 frames drawn."""
    from dfine_tpu.apps import bench as jax_bench

    from dfine_tpu_torch.apps import bench as bench_app

    jds, ds = _datasets(tmp_path / "data", "detect")
    results = _gt_results(ds, seed=5)
    ref = jax_bench.test_model(Stub(results), jds, NAMES, 0.5, viz_dir=tmp_path / "jax")
    ours = bench_app.test_model(Stub(results), ds, NAMES, 0.5, viz_dir=tmp_path / "port")
    assert ours.keys() == ref.keys()
    for k in ("f1", "precision", "recall", "iou"):
        assert abs(ours[k] - ref[k]) <= METRIC_ATOL, k
    assert 0 < ours["f1"] < 1
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == \
        sorted(p.name for p in (tmp_path / "jax").iterdir())


def test_bench_exits_nonzero_when_a_backend_fails(project, monkeypatch, capsys):
    """The other backends run and the table is printed, then SystemExit."""
    from dfine_tpu_torch.apps import bench as bench_app

    root, argv = project
    stub = lambda *a, **kw: Stub([{"boxes": np.zeros((0, 4), np.float32),  # noqa: E731
                                   "labels": np.zeros(0, np.int64),
                                   "scores": np.zeros(0, np.float32)}] * 2)

    def broken(*a, **kw):
        raise RuntimeError("backend broke")

    monkeypatch.setattr(bench_app, "TorchModel", stub)
    monkeypatch.setattr(bench_app, "AOTModel", broken)
    monkeypatch.setattr(bench_app, "ExportedModel", stub)
    with pytest.raises(SystemExit, match="torch-cuda-graph"):
        bench_app.main(argv, device="cpu")
    out = capsys.readouterr().out
    assert "torch-cuda-graph: FAILED (RuntimeError: backend broke)" in out
    assert "| torch-eager |" in out and "| torch-export |" in out


def _config_of(argv):
    from dfine_tpu_torch.config import cli_config

    return cli_config(argv)


# ------------------------------------------------------------ end to end --


def relabel_val(trainer, keep: int = 30) -> float:
    """Write, as each val frame's labels, ``trainer``'s own detections of
    it through its eval path (4-point polygons) above a threshold that keeps
    at most ``keep`` a frame (the eval keeps the masks of the top 100 only),
    so that its F1 is near 1 and int8 has something to lose. Returns the
    threshold."""
    from dfine_tpu_torch.postprocess import postprocess_predictions

    ds = trainer.loader.dataset("val", mode="val")
    decoded = []
    for i in range(len(ds)):
        sample, gt = ds.load_for_eval(i)
        x = torch.from_numpy(sample["image"][None]).permute(0, 3, 1, 2)
        decoded.append((trainer.decode(x), gt))
    conf = max(float(d["scores"][0, keep]) for d, _ in decoded) + 1e-6
    for i, (dec, gt) in enumerate(decoded):
        (pred,) = postprocess_predictions(dec, trainer.img_size, [gt["orig_size"]], conf, False)
        h, w = gt["orig_size"]
        rows = [f"{c} " + " ".join(f"{v:.6f}" for v in (x1, y1, x2, y1, x2, y2, x1, y2))
                for (x1, y1, x2, y2), c in zip(pred["boxes"] / [w, h, w, h], pred["labels"])]
        assert len(rows) >= 5
        _, label_path = ds._paths(i)
        label_path.write_text("\n".join(rows) + "\n")
    return conf


@pytest.fixture(scope="module")
def project(tmp_path_factory):
    """A segment dataset (6 PNG frames, 2 in val, relabelled by
    ``relabel_val``), test images, and ``best.ckpt`` from
    ``Trainer.save_checkpoint`` (random init: no step), fp32."""
    from dfine_tpu_torch.train.trainer import Trainer

    root = tmp_path_factory.mktemp("apps")
    data = root / "data" / "dataset"
    names = write_dataset(data, 6, (90, 120), seed=3, n_val=2)
    tests = root / "data" / "test"
    tests.mkdir(parents=True)
    for name in names[:3]:
        (tests / name).write_bytes((data / "images" / name).read_bytes())
    argv = [str(REPO / "config.yaml")] + _overrides(root, "run", **{"train.dtype": "float32"})
    trainer = Trainer(_config_of(argv), device="cpu")
    trainer.save_checkpoint("best")
    return root, argv + [f"train.conf_thresh={relabel_val(trainer)}"]


def test_export_main(project):
    """The repo's ``formats: [aot, stablehlo]``: the manifest and the .pt2."""
    from dfine_tpu_torch.apps import export as export_app

    root, argv = project
    artifacts = export_app.main(argv, device="cpu")
    assert sorted(artifacts) == ["aot", "exported"]
    assert artifacts["exported"] == root / "run" / "export" / "dfine_n.pt2"
    assert all(p.exists() for p in artifacts.values())


def test_infer_main(project):
    from dfine_tpu_torch.apps import infer as infer_app

    root, argv = project
    out = infer_app.main(argv, device="cpu")
    files = _files(out["out_dir"])
    assert out["images"] == 3 and len([k for k in files if k.startswith("images/")]) == 3
    notes = [k for k in files if k.startswith("annotations/")]
    assert len(notes) == 3 and any(files[k] for k in notes)
    assert files["labels.txt"].strip() and any(k.startswith("crops/") for k in files)


def test_infer_refuses_videos_before_any_image(project, tmp_path):
    from dfine_tpu_torch.apps import infer as infer_app

    root, argv = project
    src = tmp_path / "src"
    src.mkdir()
    (src / "a.png").write_bytes(next((root / "data" / "test").iterdir()).read_bytes())
    (src / "clip.mp4").write_bytes(b"\0" * 16)
    with pytest.raises(NotImplementedError, match="clip.mp4"):
        infer_app.main(argv + [f"train.path_to_test_data={src}",
                               f"train.infer_path={tmp_path / 'out'}"], device="cpu")
    assert not (tmp_path / "out").exists()


def test_check_errors_main(project):
    from dfine_tpu_torch.apps import check_errors as check_app

    root, argv = project
    counts = check_app.main(argv, device="cpu")
    assert set(counts) == {"train", "val"}
    crops = _files(root / "output" / "check_errors", ".jpg")
    assert len(crops) == sum(c["fp"] + c["fn"] for c in counts.values()) > 0


def test_bench_main(project):
    """Three rows; eager and CUDA-graph (eager on the CPU) read the same
    metrics; the .pt2 of ``test_export_main`` or one exported in process."""
    from dfine_tpu_torch.apps import bench as bench_app

    root, argv = project
    rows = bench_app.main(argv, device="cpu")
    assert [r["backend"] for r in rows] == ["torch-eager", "torch-cuda-graph", "torch-export"]
    for k in ("f1", "precision", "recall", "iou"):
        assert rows[0][k] == rows[1][k], k
    assert all(r["latency_ms"] > 0 for r in rows)


def test_quant_main_forced_full_revert(project):
    """``export.int8_max_drop=-1`` forces every revert round: it ends at
    ``count_int8 = (0, n)`` with the fp F1, rejected (no file written)."""
    from dfine_tpu_torch.apps import quant as quant_app

    root, argv = project
    out = quant_app.main(argv + ["export.int8_max_drop=-1"], device="cpu")
    nq, nk = out["count_int8"]
    assert nq == 0 and nk > 0 and not out["accepted"] and out["fp_f1"] > 0.9
    assert out["int8_f1"] == out["fp_f1"]
    k = len(out["reverted"])
    assert [r["reverted"] for r in out["rounds"]] == [min(2 ** i - 1, k) for i in
                                                        range(1, len(out["rounds"]) + 1)]
    accepted = quant_app.main(argv + ["export.int8_max_drop=1"], device="cpu")
    assert accepted["accepted"] and accepted["reverted"] == []
    assert accepted["path"] == root / "run" / "export_int8.npz" and accepted["path"].exists()


def test_test_batching_main(project, monkeypatch):
    from dfine_tpu_torch.apps import test_batching as batching_app

    root, argv = project
    monkeypatch.setattr(batching_app, "N_IMAGES", 2)
    monkeypatch.setattr(batching_app, "BATCH_SIZES", (1, 2))
    rows = batching_app.main(argv, device="cpu")
    assert [r["batch_size"] for r in rows] == [1, 2]
    with open(root / "run" / "batching.csv", newline="") as f:
        got = list(csv.DictReader(f))
    assert [int(r["batch_size"]) for r in got] == [1, 2]
    assert list(got[0]) == ["batch_size", "throughput_img_s", "latency_per_img_ms"]


def test_demo_main_cli(project, tmp_path):
    from dfine_tpu_torch.apps import demo as demo_app

    root, argv = project
    img = tmp_path / "frame.png"
    img.write_bytes(next((root / "data" / "test").iterdir()).read_bytes())
    (written,) = demo_app.main(argv + [str(img)], device="cpu")
    assert written == tmp_path / "frame.pred.jpg" and written.stat().st_size > 0


@pytest.mark.parametrize("name", APPS)
def test_apps_need_cuda_by_default(name):
    """Without CUDA and without ``device="cpu"`` every app raises naming
    CUDA, before it reads anything."""
    import importlib

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    app = importlib.import_module(f"dfine_tpu_torch.apps.{name}")
    with pytest.raises(RuntimeError, match="CUDA"):
        app.main([str(REPO / "config.yaml"), "train.root=/nonexistent"])


def test_infer_command_without_cuda_exits_nonzero():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    proc = subprocess.run([sys.executable, "-m", "dfine_tpu_torch.apps.infer"], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and "CUDA" in proc.stderr, proc.stderr[-2000:]
