"""The port's data pipeline (no cv2) against cv2 and the JAX package's.

- ``read_image``: bit-equal to ``cv2.imread`` (BGR -> RGB) on PNGs written
  by cv2, by PIL and by a hand encoder that uses every row filter, on PPM /
  PGM and on ``.npy``, with PIL and with the built-in reader; JPEG without
  PIL raises.
- The cv2 replacements: ``resize_linear``, ``gaussian_blur``,
  ``rgb_to_gray``, ``rotation_matrix`` and ``fill_poly`` on polygons inside
  the image are bit-equal; ``warp_affine`` is within WARP_ATOL on at most
  WARP_SHARE of the values (measured: 1 on 8.8e-6 of them, an FMA emulated in
  float64 rounds twice), and ``fill_poly`` on polygons that cross the
  image's edge differs only on the image's first or last column.
- ``DetectionDataset`` and ``BatchIterator`` against the JAX package's at
  fixed seeds and epochs: labels and ``valid`` equal, boxes within 1e-5,
  images within IMAGE_ATOL on at most IMAGE_SHARE of a sample's values (the
  warp's rounding; measured over every case here: 1 on 3.5e-7 of the
  values, boxes equal), masks different only on pixels at a polygon's edge
  (measured: 3 pixels).
"""

import struct
import sys
import zlib
import cv2
import numpy as np
import pytest

from test_torch_port_helpers import write_dataset

WARP_ATOL, WARP_SHARE = 1, 1e-4
IMAGE_ATOL, IMAGE_SHARE = 1, 1e-3
BOX_ATOL = 1e-5
AUGS = ("brightness", "gamma", "blur", "noise", "to_gray", "coarse_dropout",
        "left_right_flip", "up_down_flip", "rotate_90", "rotation_p")


def _rgb(path) -> np.ndarray:
    return cv2.cvtColor(cv2.imread(str(path), cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)


def encode_png(img: np.ndarray, filters) -> bytes:
    """An 8-bit PNG whose row r uses filter ``filters[r % len(filters)]``."""
    h, w = img.shape[:2]
    c = 1 if img.ndim == 2 else img.shape[2]
    x = img.reshape(h, w * c).astype(np.int32)
    rows, prev = [], np.zeros(w * c, np.int32)
    for r in range(h):
        f, cur = filters[r % len(filters)], x[r]
        a = np.concatenate([np.zeros(c, np.int32), cur[:-c]])
        up_left = np.concatenate([np.zeros(c, np.int32), prev[:-c]])
        p = a + prev - up_left
        pa, pb, pc = np.abs(p - a), np.abs(p - prev), np.abs(p - up_left)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, prev, up_left))
        pred = [0, a, prev, (a + prev) >> 1, paeth][f]
        rows.append(np.concatenate([[f], (cur - pred) & 255]).astype(np.uint8))
        prev = cur

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", zlib.crc32(kind + body) & 0xFFFFFFFF)

    ihdr = struct.pack(">IIBBBBB", w, h, 8, {1: 0, 2: 4, 3: 2, 4: 6}[c], 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(np.stack(rows).tobytes())) + chunk(b"IEND", b""))


@pytest.fixture
def no_pil(monkeypatch):
    """``read_image`` as it runs where PIL does not import."""
    from dfine_tpu_torch.data import image_io

    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setattr(image_io, "_PIL", None)
    assert image_io._pil() is None
    return image_io


@pytest.mark.parametrize("with_pil", [True, False])
def test_read_image_matches_cv2(with_pil, tmp_path, request):
    from PIL import Image

    from dfine_tpu_torch.data.image_io import read_image, write_png

    rng = np.random.default_rng(0)
    files = []
    for c in (1, 2, 3, 4):
        for filters in ([0], [1], [2], [3], [4], [4, 3, 2, 1, 0]):
            shape = (37, 53, c) if c > 1 else (37, 53)
            p = tmp_path / f"hand_{c}_{''.join(map(str, filters))}.png"
            p.write_bytes(encode_png(rng.integers(0, 256, shape, dtype=np.uint8), filters))
            files.append(p)
    smooth = (np.linspace(0, 255, 61)[None, :, None] * np.ones((45, 1, 3))).astype(np.uint8)
    for mode in ("RGB", "L", "RGBA", "P", "LA"):
        for name, img in (("noise", rng.integers(0, 256, (41, 29, 3), dtype=np.uint8)),
                          ("smooth", smooth)):
            files.append(tmp_path / f"pil_{mode}_{name}.png")
            Image.fromarray(img).convert(mode).save(files[-1])
    for ext, img in ((".png", smooth), (".ppm", smooth), (".pgm", smooth[..., 0]),
                     ("_gray.png", smooth[..., 1])):
        files.append(tmp_path / f"cv2{ext}")
        cv2.imwrite(str(files[-1]), img)
    files.append(tmp_path / "ours.png")
    write_png(files[-1], rng.integers(0, 256, (19, 23, 3), dtype=np.uint8))
    if not with_pil:  # the files are written: from here on PIL does not import
        request.getfixturevalue("no_pil")
    for p in files:
        np.testing.assert_array_equal(read_image(p), _rgb(p), err_msg=p.name)
    arr = rng.integers(0, 256, (5, 7, 3), dtype=np.uint8)
    np.save(tmp_path / "a.npy", arr)
    np.testing.assert_array_equal(read_image(tmp_path / "a.npy"), arr)


def test_jpeg_without_pil_raises(tmp_path, no_pil):
    cv2.imwrite(str(tmp_path / "x.jpg"), np.zeros((8, 8, 3), np.uint8))
    with pytest.raises(RuntimeError, match="PIL"):
        no_pil.read_image(tmp_path / "x.jpg")
    assert no_pil.decoder_name().startswith("builtin")


@pytest.mark.parametrize("src,dst", [((37, 53), (64, 96)), ((120, 200), (45, 71)),
                                     ((720, 1280), (640, 640)), ((100, 100), (100, 100)),
                                     ((7, 300), (320, 3))])
@pytest.mark.parametrize("channels", [1, 3])
def test_resize_linear_is_cv2(src, dst, channels):
    from dfine_tpu_torch.data.augment import resize_linear

    img = np.random.default_rng(sum(src)).integers(0, 256, src + (channels,), dtype=np.uint8)
    img = img[..., 0] if channels == 1 else img
    np.testing.assert_array_equal(resize_linear(img, dst[::-1]),
                                  cv2.resize(img, dst[::-1], interpolation=cv2.INTER_LINEAR))


@pytest.mark.parametrize("seed", range(4))
def test_warp_affine_blur_gray_rotation_match_cv2(seed):
    from dfine_tpu_torch.data import augment as A

    rng = np.random.default_rng(seed)
    differ, total = 0, 0
    for _ in range(8):
        h, w, oh, ow = (int(v) for v in rng.integers(20, 300, 4))
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        center, deg, scale = (w / 2, h / 2), rng.uniform(-30, 30), rng.uniform(0.5, 1.5)
        ref_m = cv2.getRotationMatrix2D(center, deg, scale)
        np.testing.assert_array_equal(A.rotation_matrix(center, deg, scale), ref_m)
        m = ref_m.astype(np.float32)
        m[:, 2] += rng.uniform(-30, 30, 2).astype(np.float32)
        m[0, 1] += np.float32(rng.uniform(-0.05, 0.05))
        ref = cv2.warpAffine(img, m, (ow, oh), flags=cv2.INTER_LINEAR, borderValue=(114, 114, 114))
        d = np.abs(A.warp_affine(img, m, (ow, oh)).astype(int) - ref)
        assert d.max() <= WARP_ATOL
        differ, total = differ + int((d > 0).sum()), total + d.size
        for k in (3, 5, 7):
            np.testing.assert_array_equal(A.gaussian_blur(img, k), cv2.GaussianBlur(img, (k, k), 0))
        np.testing.assert_array_equal(A.rgb_to_gray(img), cv2.cvtColor(img, cv2.COLOR_RGB2GRAY))
    assert differ <= WARP_SHARE * total


@pytest.mark.parametrize("segment", [False, True])
def test_label_files_match_jax(tmp_path, segment):
    """``parse_yolo_label_file`` against JAX's on box rows, polygon rows, an
    odd coordinate count and a blank line; ``save_yolo_label_file`` reads
    back to what it wrote; ``clip_polygon`` against JAX's."""
    from dfine_tpu.data import labels as jl

    from dfine_tpu_torch.data import labels as pl

    p = tmp_path / "a.txt"
    p.write_text("0 0.5 0.5 0.2 0.3\n\n2 0.1 0.1 0.4 0.1 0.3 0.5 0.9\n1 0.2 0.2 0.6 0.3 0.4 0.7\n")
    ours, ref = pl.parse_yolo_label_file(p, segment), jl.parse_yolo_label_file(p, segment)
    for a, b in zip(ours[:2], ref[:2]):
        np.testing.assert_array_equal(a, b)
    assert (ours[2] is None) == (ref[2] is None) == (not segment)
    for a, b in zip(ours[2] or [], ref[2] or []):
        np.testing.assert_array_equal(a, b)
    pl.save_yolo_label_file(tmp_path / "b.txt", ours[0], ours[1], ours[2])
    back = pl.parse_yolo_label_file(tmp_path / "b.txt", segment)
    np.testing.assert_array_equal(back[0], ours[0])
    np.testing.assert_allclose(back[1], ours[1], atol=1e-6)
    poly = np.asarray([[-5, 3], [50, -8], [70, 40], [10, 65]], np.float32)
    np.testing.assert_array_equal(pl.clip_polygon(poly, 60, 50), jl.clip_polygon(poly, 60, 50))


def _polygons(rng, h, w, n, inside):
    out = []
    for _ in range(n):
        k = int(rng.integers(3, 30))
        if inside:
            ang, r = np.sort(rng.uniform(0, 2 * np.pi, k)), rng.uniform(0.05, 0.5, k)
            out.append(np.stack([(w - 1) * (0.5 + r * np.cos(ang)),
                                 (h - 1) * (0.5 + r * np.sin(ang))], 1).astype(np.float32))
        else:
            out.append(np.stack([rng.uniform(-0.2, 1.2, k) * w, rng.uniform(-0.2, 1.2, k) * h],
                                1).astype(np.float32))
    return out


@pytest.mark.parametrize("inside", [True, False])
def test_polygons_to_masks_at_stride_4_match_cv2(inside):
    """The JAX package's ``polygons_to_masks`` (``cv2.fillPoly``) against
    the port's at full size and at the mask stride 1/4, on random star and
    self-crossing polygons."""
    from dfine_tpu.data.labels import polygons_to_masks as jax_masks

    from dfine_tpu_torch.data.labels import polygons_to_masks

    rng = np.random.default_rng(int(inside))
    for _ in range(30):
        h, w = (int(v) for v in rng.integers(16, 200, 2))
        polys = _polygons(rng, h, w, 4, inside)
        for scale in (1.0, 0.25):
            ours, ref = polygons_to_masks(polys, h, w, scale), jax_masks(polys, h, w, scale)
            if inside:
                np.testing.assert_array_equal(ours, ref)
            else:
                cols = np.nonzero((ours != ref).any(axis=(0, 1)))[0]
                assert set(cols.tolist()) <= {0, ours.shape[2] - 1}, cols


# --------------------------------------------------------------- datasets --


@pytest.fixture(scope="module")
def dataset_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("ds")
    write_dataset(root, 8, (90, 120), seed=0)
    return root


def _edge(mask: np.ndarray) -> np.ndarray:
    """Pixels of ``mask`` [..., H, W] with a 4-neighbour of the other value."""
    p = np.pad(mask, [(0, 0)] * (mask.ndim - 2) + [(1, 1), (1, 1)], mode="edge")
    c = p[..., 1:-1, 1:-1]
    return ((c != p[..., :-2, 1:-1]) | (c != p[..., 2:, 1:-1]) | (c != p[..., 1:-1, :-2])
            | (c != p[..., 1:-1, 2:]))


def assert_sample_close(ours, ref, tag):
    assert set(ours) == set(ref), tag
    for k in ("labels", "valid", "mask_valid"):
        if k in ref:
            np.testing.assert_array_equal(ours[k], ref[k], err_msg=f"{tag} {k}")
    np.testing.assert_allclose(ours["boxes"], ref["boxes"], rtol=0, atol=BOX_ATOL, err_msg=tag)
    assert ours["image"].shape == ref["image"].shape and ours["image"].dtype == np.uint8, tag
    d = np.abs(ours["image"].astype(int) - ref["image"])
    assert d.max() <= IMAGE_ATOL and (d > 0).mean() <= IMAGE_SHARE, (tag, d.max(), (d > 0).mean())
    if "masks" in ref:
        off = ours["masks"] != ref["masks"]
        assert not (off & ~(_edge(ref["masks"]) | _edge(ours["masks"]))).any(), tag


def _datasets(root, task, mode, keep_ratio=False, augs=None, mosaic=0.0, epochs=10, size=(96, 128)):
    from dfine_tpu.data.dataset import DatasetConfig as JConfig
    from dfine_tpu.data.dataset import DetectionDataset as JDataset

    from dfine_tpu_torch.data.dataset import DatasetConfig, DetectionDataset

    names = (root / "train.csv").read_text().split()
    kw = dict(img_size=size, task=task, keep_ratio=keep_ratio, max_gt=12, seed=5,
              augs=dict(augs or {}), epochs=epochs, ignore_background_epochs=1,
              mosaic_augs={"mosaic_prob": mosaic, "no_mosaic_epochs": 2, "mosaic_scale": (0.5, 1.5),
                           "degrees": 5.0, "translate": 0.2, "shear": 2.0})
    return (DetectionDataset(root, names, DatasetConfig(**kw), mode=mode),
            JDataset(root, names, JConfig(**kw), mode=mode))


@pytest.mark.parametrize("task", ["detect", "segment"])
@pytest.mark.parametrize("case", ["mosaic", "plain", "keep_ratio"] + list(AUGS))
def test_train_samples_match_jax(dataset_root, task, case):
    """Train samples at epochs 0 (background skipped), 3 and 9 (mosaic
    closed): mosaic with the photometric augs, no mosaic, letterbox, and
    each aug at probability 1 alone."""
    augs = {a: 1.0 for a in AUGS[:6]} if case == "mosaic" else \
        {case: 1.0, "rotation_degree": 12} if case in AUGS else {}
    ours, ref = _datasets(dataset_root, task, "train", keep_ratio=case == "keep_ratio", augs=augs,
                          mosaic=1.0 if case == "mosaic" else 0.0)
    for epoch in (0, 3, 9):
        ours.set_epoch(epoch)
        ref.set_epoch(epoch)
        for i in range(len(ours)):
            assert_sample_close(ours[i], ref[i], f"{case} epoch {epoch} sample {i}")


@pytest.mark.parametrize("task", ["detect", "segment"])
@pytest.mark.parametrize("keep_ratio", [False, True])
def test_eval_samples_match_jax(dataset_root, task, keep_ratio):
    ours, ref = _datasets(dataset_root, task, "val", keep_ratio=keep_ratio)
    for i in range(len(ours)):
        (s, g), (rs, rg) = ours.load_for_eval(i), ref.load_for_eval(i)
        assert_sample_close(s, rs, f"eval {i}")
        assert g["orig_size"] == rg["orig_size"] and g["pad"] == rg["pad"]
        assert g["scale"] == rg["scale"]
        np.testing.assert_array_equal(g["labels"], rg["labels"])
        np.testing.assert_array_equal(g["boxes_abs"], rg["boxes_abs"])
        if task == "segment":
            for a, b in zip(g["polygons"], rg["polygons"]):
                np.testing.assert_array_equal(a, b)


def test_batch_iterator_matches_jax(dataset_root):
    """Two epochs of shuffled batches with multiscale at probability 0.5:
    the same order, the same sizes, the same samples."""
    from dfine_tpu.data.loader import BatchIterator as JIterator

    from dfine_tpu_torch.data.loader import BatchIterator

    ours_ds, ref_ds = _datasets(dataset_root, "segment", "train", size=(128, 128))
    ours = BatchIterator(ours_ds, 3, shuffle=True, num_workers=2, seed=5, multiscale_prob=0.5)
    ref = JIterator(ref_ds, 3, shuffle=True, num_workers=2, seed=5, multiscale_prob=0.5)
    sizes = set()
    for epoch in (0, 1):
        ours.set_epoch(epoch)
        ref.set_epoch(epoch)
        a, b = list(ours), list(ref)
        assert len(a) == len(b) == len(ours) == 2
        for x, y in zip(a, b):
            sizes.add(x["images"].shape[1:3])
            assert x["images"].shape == y["images"].shape
            for k in y["targets"]:
                assert_sample_close({"image": x["images"][0], **{t: v[0] for t, v in
                                                                  x["targets"].items()}},
                                    {"image": y["images"][0], **{t: v[0] for t, v in
                                                                 y["targets"].items()}}, k)
        assert list(ours.batch_sizes()) == [tuple(x["images"].shape[1:3]) for x in a]
    assert len(sizes) > 1


def test_batch_iterator_reports_its_producer():
    """``producing`` is True while the producer still makes the epoch's
    batches (here held on the last one) and False once it has made them."""
    import threading
    import types

    from dfine_tpu_torch.data.loader import BatchIterator

    gate = threading.Event()

    class HeldDataset:
        cfg, mode = types.SimpleNamespace(img_size=(8, 8)), "train"

        def __len__(self):
            return 4

        def set_epoch(self, epoch):
            pass

        def __getitem__(self, j, img_size=None):
            if j >= 2:
                assert gate.wait(30)
            return {"image": np.zeros((8, 8, 3), np.uint8), "labels": np.zeros(1, np.int32)}

    it = BatchIterator(HeldDataset(), 2, shuffle=False, num_workers=2)
    assert not it.producing
    batches = iter(it)
    next(batches)
    assert it.producing
    gate.set()
    assert len(list(batches)) == 1 and not it.producing


def test_ram_cache_under_threads(dataset_root):
    """The decoded-sample cache shared by the loader's threads: 32 threads
    (more than the cores) on a short switch interval load every sample many
    times; each sample is cached once, the byte count is the cached
    entries' sum and within the budget, and a hit hands out its own dict."""
    import concurrent.futures as cf

    from dfine_tpu_torch.data.dataset import DatasetConfig, DetectionDataset

    names = (dataset_root / "train.csv").read_text().split()
    ds = DetectionDataset(dataset_root, names, DatasetConfig(task="segment", cache_images_mb=1))
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with cf.ThreadPoolExecutor(32) as pool:
            samples = list(pool.map(ds.load_raw, [i % len(ds) for i in range(400)], timeout=120))
    finally:
        sys.setswitchinterval(old)
    size = sum(v.nbytes for s in ds._cache.values() for k, v in s.items() if k != "polygons") + \
        sum(p.nbytes for s in ds._cache.values() for p in s["polygons"])
    assert ds._cache_bytes == size <= 1 << 20 and len(ds._cache) == len(ds)
    n = len(samples[0]["polygons"])
    samples[0]["polygons"].append(None)
    assert len(ds.load_raw(0)["polygons"]) == n


def test_debug_dump_writes_pngs(dataset_root, tmp_path):
    """``debug_img_path``: each augmented train sample as a PNG with its
    boxes and polygons drawn (the JAX package's JPEGs and text left out)."""
    from dfine_tpu_torch.data.dataset import DatasetConfig, DetectionDataset
    from dfine_tpu_torch.data.image_io import read_image

    names = (dataset_root / "train.csv").read_text().split()
    cfg = DatasetConfig(img_size=(96, 128), task="segment", max_gt=12,
                        debug_img_path=str(tmp_path / "debug"))
    ds = DetectionDataset(dataset_root, names, cfg, mode="train")
    sample = ds[0]
    dump = read_image(tmp_path / "debug" / "ep0_0.png")
    assert dump.shape == sample["image"].shape and (dump != sample["image"]).any()


def test_loader_splits_stats_and_device_batch(dataset_root):
    from dfine_tpu.data.loader import Loader as JLoader

    import torch

    from dfine_tpu_torch.data.loader import Loader, read_split_csv, to_device

    cfg = {"img_size": [96, 128], "label_to_name": {0: "a", 1: "b", 2: "c"}, "max_gt": 12}
    ours = Loader(dataset_root, cfg, task="segment")
    ref = JLoader(dataset_root, cfg, task="segment")
    assert ours.splits == ref.splits and ours.splits["test"] == []
    assert read_split_csv(dataset_root / "val.csv") == ours.splits["val"]
    assert ours.label_stats() == ref.label_stats()
    assert ours.background_count() == ref.background_count() == 2
    train, val, test = ours.build_dataloaders(4, num_workers=2)
    assert test is None and len(train) == 2 and len(val) == 2
    batch = to_device(next(iter(train)), torch.device("cpu"))
    images = batch["images"]
    assert images.dtype == torch.uint8 and images.shape == (4, 3, 96, 128)
    assert images.is_contiguous()
    assert batch["targets"]["labels"].dtype == torch.int64
    assert batch["targets"]["masks"].shape == (4, 12, 24, 32)
