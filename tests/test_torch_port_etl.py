"""The port's dataset tools (``dfine_tpu_torch.etl``) and the cv2
counterparts they stand on, against the JAX package's tools and cv2 on the
CPU: each tool runs through both packages on copies of one tmp tree and the
files written are compared byte for byte (JPEGs by their decoded pixels);
``resize_area`` bit for bit against ``cv2.resize(INTER_AREA)``; the contour
tools and ``mask2poly`` point for point against cv2; the image readers
against ``cv2.imread``. ``preprocess`` differs by design where a conversion
fails: the port keeps the original, the JAX tool deletes it."""

import json
import shutil
from pathlib import Path

import cv2
import numpy as np
import pytest

from test_torch_port_serving_modes import _blob_mask

REPO = Path(__file__).resolve().parents[1]


def _files(root: Path):
    """{relative path: bytes} of every file under ``root``."""
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file()}


def _twins(tmp_path: Path, src: Path):
    """Two copies of ``src``: the JAX tool's and the port's."""
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    shutil.copytree(src, jax_dir)
    shutil.copytree(src, port_dir)
    return jax_dir, port_dir


def _image(rng, hw, channels=3):
    """A smooth random image (JPEG keeps its structure)."""
    img = rng.integers(0, 256, (*hw, channels), dtype=np.uint8)
    return cv2.GaussianBlur(img, (7, 7), 0).reshape(*hw, channels)


def _image_tree(root: Path, seed: int):
    """images/ of PNG, JPEG and BMP frames (gray and colour, two exact
    duplicates and one near duplicate) and labels/ with box and polygon
    rows, one empty and one missing."""
    rng = np.random.default_rng(seed)
    (root / "images").mkdir(parents=True)
    (root / "labels").mkdir()
    base = _image(rng, (48, 64))
    frames = {"a.png": base, "b.jpg": _image(rng, (60, 80)), "c.png": _image(rng, (33, 41))[..., 0],
              "d.bmp": _image(rng, (40, 30)), "e.png": base.copy(), "f.jpeg": _image(rng, (64, 48)),
              "g.png": np.clip(base.astype(int) + 1, 0, 255).astype(np.uint8),
              "h.png": _image(rng, (90, 70))}
    for name, img in frames.items():
        cv2.imwrite(str(root / "images" / name), img)
    (root / "images" / "notes.txt").write_text("not an image\n")
    for i, name in enumerate(sorted(frames)):
        stem = Path(name).stem
        if stem == "c":
            continue  # no label file
        rows = []
        for _ in range(0 if stem == "e" else int(rng.integers(1, 4))):
            cls = int(rng.integers(0, 3))
            if rng.uniform() < 0.5:
                rows.append(f"{cls} " + " ".join(f"{v:.6f}" for v in rng.uniform(0.2, 0.8, 4)))
            else:
                rows.append(f"{cls} " + " ".join(f"{v:.6f}" for v in rng.uniform(0, 1, 8)))
        (root / "labels" / f"{stem}.txt").write_text("\n".join(rows) + ("\n" if rows else ""))
    return sorted(frames)


# ------------------------------------------------------------- cv2 seams --


@pytest.mark.parametrize("src_hw,dst_hw", [((64, 64), (8, 8)), ((48, 80), (16, 40)),
                                           ((100, 75), (8, 8)), ((37, 53), (8, 8)),
                                           ((720, 1280), (8, 8)), ((63, 65), (21, 13)),
                                           ((10, 7), (3, 7))])
def test_resize_area_equals_cv2(src_hw, dst_hw):
    """Integer factors (the block-sum path, 2x2 with its own rounding) and
    non-integer ones (float32 area weights), gray and 3 / 4 channels."""
    from dfine_tpu_torch.data.augment import resize_area

    rng = np.random.default_rng(sum(src_hw) + sum(dst_hw))
    for shape in (src_hw, (*src_hw, 3), (*src_hw, 4)):
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        ref = cv2.resize(img, dst_hw[::-1], interpolation=cv2.INTER_AREA)
        np.testing.assert_array_equal(resize_area(img, dst_hw[::-1]), ref)
    with pytest.raises(ValueError, match="shrinks only"):
        resize_area(img, (src_hw[1] + 1, src_hw[0]))


def test_contour_tools_equal_cv2():
    """``find_external_contours`` (its order included), ``contour_area``,
    ``arc_length``, ``approx_poly_closed`` and so ``mask2poly`` equal cv2's
    and the JAX ``BaseServing.mask2poly`` exactly. The port's contours came
    in the reverse order of cv2's, and its approxPolyDP measured to the line
    (not the segment) and had no clean-up pass: the polygons of the JAX
    package's infer annotations and ``png_mask_to_yolo`` differed."""
    from dfine_tpu.infer.base import BaseServing as JaxServing

    from dfine_tpu_torch.infer.contours import (approx_poly_closed, arc_length, contour_area,
                                                find_external_contours, mask2poly)

    rng = np.random.default_rng(0)
    for t in range(60):
        m = _blob_mask(rng, t)
        if t % 2:
            m = np.kron(m, np.ones((3, 2), np.uint8))
        ref, _ = cv2.findContours(m, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)
        ours = find_external_contours(m)
        assert [c.reshape(-1, 2).tolist() for c in ref] == [c.tolist() for c in ours], t
        for c in ref:
            assert contour_area(c.reshape(-1, 2)) == cv2.contourArea(c)
            assert arc_length(c.reshape(-1, 2)) == cv2.arcLength(c, True)
        jax_polys, polys = JaxServing.mask2poly(m), mask2poly(m)
        assert len(polys) == len(jax_polys), t
        for a, b in zip(jax_polys, polys):
            assert b.dtype == np.float32 and np.array_equal(a, b), t
    for t in range(400):  # arbitrary closed point lists: repeats, collinear runs, ties
        n = int(rng.integers(3, 60))
        pts = rng.integers(0, int(rng.choice([5, 20, 300])), (n, 2)).astype(np.int32)
        eps = float(rng.choice([0.0, 0.5, 1.0, 3.0, 10.0])) * rng.uniform(0.5, 1.5)
        ref = cv2.approxPolyDP(pts.reshape(-1, 1, 2), eps, True).reshape(-1, 2)
        np.testing.assert_array_equal(approx_poly_closed(pts, eps), ref, err_msg=str(t))


def test_image_readers_equal_cv2(tmp_path):
    """``read_bgr`` / ``read_gray`` / ``image_size`` against ``cv2.imread``
    on gray, colour and RGBA PNG, JPEG (one turned by its EXIF orientation),
    BMP, a file that is no image and a missing file; ``write_image``'s JPEG
    equals cv2's (quality 95) and its PNG decodes to the image."""
    from PIL import Image

    from dfine_tpu_torch.data import image_io

    rng = np.random.default_rng(3)
    img = _image(rng, (61, 83))
    cv2.imwrite(str(tmp_path / "c.png"), img)
    cv2.imwrite(str(tmp_path / "g.png"), img[..., 0])
    cv2.imwrite(str(tmp_path / "a.png"), np.concatenate([img, img[..., :1]], 2))
    cv2.imwrite(str(tmp_path / "c.jpg"), img)
    cv2.imwrite(str(tmp_path / "c.bmp"), img)
    exif = Image.Exif()
    exif[0x0112] = 6  # turned 90 degrees
    Image.fromarray(img[..., ::-1]).save(tmp_path / "r.jpg", exif=exif.tobytes(), quality=92)
    (tmp_path / "bad.jpg").write_bytes(b"not an image")
    for name in ("c.png", "g.png", "a.png", "c.jpg", "c.bmp", "r.jpg", "bad.jpg", "none.png"):
        p = tmp_path / name
        for ours, ref in ((image_io.read_bgr(p), cv2.imread(str(p))),
                          (image_io.read_gray(p), cv2.imread(str(p), cv2.IMREAD_GRAYSCALE))):
            assert (ours is None) == (ref is None), name
            if ref is not None:
                np.testing.assert_array_equal(ours, ref, err_msg=name)
        ref = cv2.imread(str(p))
        assert image_io.image_size(p) == (None if ref is None else ref.shape[:2]), name
    image_io.write_image(tmp_path / "w.jpg", img)
    cv2.imwrite(str(tmp_path / "cv.jpg"), img)
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "w.jpg")),
                                  cv2.imread(str(tmp_path / "cv.jpg")))
    image_io.write_image(tmp_path / "w.png", img)
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "w.png")), img)


def test_jpeg_without_pil_raises_naming_pil(tmp_path, monkeypatch):
    from dfine_tpu_torch.data import image_io

    img = np.zeros((4, 5, 3), np.uint8)
    cv2.imwrite(str(tmp_path / "x.jpg"), img)
    monkeypatch.setattr(image_io, "_PIL", False)
    for call in (lambda: image_io.write_image(tmp_path / "y.jpg", img),
                 lambda: image_io.read_bgr(tmp_path / "x.jpg"),
                 lambda: image_io.image_size(tmp_path / "x.jpg")):
        with pytest.raises(RuntimeError, match="PIL"):
            call()
    image_io.write_image(tmp_path / "y.png", img)  # PNG needs no PIL
    np.testing.assert_array_equal(image_io.read_bgr(tmp_path / "y.png"), img)
    assert image_io.image_size(tmp_path / "y.png") == (4, 5)


# ------------------------------------------------------------ the tools --


@pytest.mark.parametrize("shuffle,ignore_negatives", [(True, False), (True, True), (False, False)])
def test_split_matches_jax(tmp_path, shuffle, ignore_negatives):
    from dfine_tpu.etl.split import split_dataset as jax_split

    from dfine_tpu_torch.etl.split import split_dataset

    _image_tree(tmp_path / "src", seed=1)
    jax_dir, port_dir = _twins(tmp_path, tmp_path / "src")
    for fn, root in ((jax_split, jax_dir), (split_dataset, port_dir)):
        fn(root, 0.5, 0.3, shuffle, ignore_negatives, seed=7)
    assert _files(jax_dir) == _files(port_dir)
    assert (port_dir / "test.csv").exists()


@pytest.mark.parametrize("segment", [False, True])
def test_coco_to_yolo_and_back_match_jax(tmp_path, segment):
    """``coco_to_yolo`` on a COCO json (category ids 3 and 9, polygons and
    boxes), then ``yolo_to_coco`` on the image tree (image sizes from the
    headers)."""
    from dfine_tpu.etl.coco_yolo import coco_to_yolo as jax_c2y
    from dfine_tpu.etl.coco_yolo import yolo_to_coco as jax_y2c

    from dfine_tpu_torch.etl.coco_yolo import coco_to_yolo, yolo_to_coco

    rng = np.random.default_rng(2)
    coco = {"images": [{"id": i + 1, "file_name": f"im{i}.jpg", "width": 640 + 32 * i,
                        "height": 480} for i in range(4)],
            "categories": [{"id": 9, "name": "dog"}, {"id": 3, "name": "cat"}],
            "annotations": []}
    for k in range(9):
        x, y = rng.uniform(0, 300, 2)
        ann = {"id": k + 1, "image_id": int(rng.integers(1, 4)), "category_id": [3, 9][k % 2],
               "bbox": [x, y, *rng.uniform(10, 200, 2)]}
        if k % 3:
            ann["segmentation"] = [rng.uniform(0, 480, 10).tolist()]
        coco["annotations"].append(ann)
    (tmp_path / "src").mkdir()
    (tmp_path / "src" / "coco.json").write_text(json.dumps(coco))
    _image_tree(tmp_path / "src" / "ds", seed=2)
    jax_dir, port_dir = _twins(tmp_path, tmp_path / "src")
    names = {0: "cat", 1: "dog", 2: "eel"}
    assert jax_c2y(jax_dir / "coco.json", jax_dir / "out", segment) == \
        coco_to_yolo(port_dir / "coco.json", port_dir / "out", segment)
    jax_y2c(jax_dir / "ds", jax_dir / "ds" / "coco.json", names, segment)
    yolo_to_coco(port_dir / "ds", port_dir / "ds" / "coco.json", names, segment)
    assert _files(jax_dir) == _files(port_dir)
    assert len(json.loads((port_dir / "ds" / "coco.json").read_text())["images"]) == 8


def test_mask_tools_match_jax(tmp_path):
    """``convert_png_masks`` (``png_mask_to_yolo`` on gray PNG masks with
    several parts, holes and specks under the minimum area),
    ``remove_class``, ``split_from_yolo``, ``clean_csv``, ``create_test_csv``
    and ``remove_dups`` (dry run, then deleting; exact and shifted
    duplicates among gray, colour, JPEG and BMP frames)."""
    from dfine_tpu.etl import mask_tools as jax_tools

    from dfine_tpu_torch.etl import mask_tools

    rng = np.random.default_rng(4)
    src = tmp_path / "src"
    (src / "masks").mkdir(parents=True)
    for i in range(6):
        m = _blob_mask(rng, i) * 255
        if i % 2:
            m = np.kron(m, np.ones((2, 3), np.uint8))
        m[0, 0] = 200  # a speck under min_area
        cv2.imwrite(str(src / "masks" / f"m{i}.png"), m)
    _image_tree(src / "ds", seed=5)
    for split in ("train", "val"):
        d = src / "yolo" / "images" / split
        d.mkdir(parents=True)
        for k in range(3):
            cv2.imwrite(str(d / f"{split}{k}.png"), _image(rng, (8, 8)))
    (src / "ds" / "train.csv").write_text("a.png\nmissing.png\nb.jpg\n")
    jax_dir, port_dir = _twins(tmp_path, src)
    dups = {}
    for tools, root in ((jax_tools, jax_dir), (mask_tools, port_dir)):
        tools.convert_png_masks(root / "masks", root / "mask_labels", class_id=2)
        tools.remove_class(root / "ds" / "labels", 1)
        tools.split_from_yolo(root / "yolo", root / "ds")
        tools.clean_csv(root / "ds")
        tools.create_test_csv(root / "ds", root / "ds" / "images")
        dry = [p.name for p in tools.remove_dups(root / "ds" / "images", dry_run=True)]
        dups[root.name] = dry, [p.name for p in tools.remove_dups(root / "ds" / "images")]
    assert dups["jax"] == dups["port"] and dups["port"][0] == ["e.png", "g.png"]
    assert len(list((port_dir / "mask_labels").glob("*.txt"))) == 6
    assert _files(jax_dir) == _files(port_dir)


def _preprocess_tree(root: Path):
    rng = np.random.default_rng(6)
    (root / "images").mkdir(parents=True)
    (root / "labels").mkdir()
    cv2.imwrite(str(root / "images" / "p.png"), _image(rng, (30, 40)))
    cv2.imwrite(str(root / "images" / "q.bmp"), _image(rng, (20, 24)))
    cv2.imwrite(str(root / "images" / "r.jpeg"), _image(rng, (16, 16)))
    cv2.imwrite(str(root / "images" / "s.jpg"), _image(rng, (18, 22)))
    (root / "images" / "broken.png").write_bytes(b"\x89PNG\r\n\x1a\n truncated")
    (root / "labels" / "p.txt").write_text("0 0.5 0.5 0.2 0.2\n")
    (root / "labels" / "empty.txt").write_text("\n")


def test_preprocess_matches_jax_but_keeps_failed_originals(tmp_path):
    """Both convert every image to .jpg (the JPEGs decode to the same
    pixels) and drop the empty label file; the JAX tool also deletes
    ``broken.png``, whose conversion failed, and the port keeps it."""
    from dfine_tpu.etl.preprocess import preprocess as jax_preprocess

    from dfine_tpu_torch.etl.preprocess import preprocess

    _preprocess_tree(tmp_path / "src")
    jax_dir, port_dir = _twins(tmp_path, tmp_path / "src")
    jax_preprocess(jax_dir / "images", jax_dir / "labels", workers=2)
    errors = preprocess(port_dir / "images", port_dir / "labels", workers=2)
    assert len(errors) == 1 and "broken.png" in errors[0]
    jax_files, port_files = _files(jax_dir), _files(port_dir)
    assert set(port_files) - set(jax_files) == {"images/broken.png"}
    assert set(jax_files) - set(port_files) == set()
    assert port_files["images/broken.png"] == (tmp_path / "src/images/broken.png").read_bytes()
    assert "labels/empty.txt" not in port_files
    for name, data in jax_files.items():
        if name.endswith(".jpg"):
            np.testing.assert_array_equal(cv2.imread(str(port_dir / name)),
                                          cv2.imread(str(jax_dir / name)), err_msg=name)
        else:
            assert port_files[name] == data, name


def test_etl_entry_points(tmp_path):
    """``main`` of each tool as its command line runs it, from the repo's
    config.yaml with overrides."""
    from dfine_tpu_torch.etl import coco_yolo, mask_tools, preprocess, split

    root = tmp_path / "project"
    data = root / "data" / "dataset"
    _image_tree(data, seed=8)
    cfg = [str(REPO / "config.yaml"), f"train.root={root}", "train.num_workers=2",
           "train.label_to_name={0: a, 1: b, 2: c}", "split.train_split=0.5",
           "split.val_split=0.25"]
    splits = split.main(cfg)
    assert [len(splits[k]) for k in ("train", "val", "test")] == [4, 2, 2]
    coco_yolo.main(["yolo2coco"] + cfg)
    assert len(json.loads((data / "coco.json").read_text())["images"]) == 8
    coco_yolo.main(["coco2yolo", str(data / "coco.json"), str(tmp_path / "back")])
    assert sorted(p.name for p in (tmp_path / "back").iterdir()) == \
        sorted(p.name for p in (data / "labels").iterdir() if p.stat().st_size > 1)
    mask_tools.main(["remove_dups", str(data / "images"), "--dry-run"])
    assert preprocess.main(cfg) == []
    assert sorted(p.suffix for p in (data / "images").iterdir() if p.suffix != ".txt") == \
        [".jpg"] * 8
