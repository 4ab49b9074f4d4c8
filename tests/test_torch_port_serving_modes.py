"""The port's serving modes against the JAX package on the CPU, n det+seg at
320 px, fp32, with re-drawn weights (shipped as the npz ``dfine_tpu``
writes): ``TorchModel`` in letterbox and rect mode against the JAX
composition preprocess -> apply -> topk_decode -> postprocess_predictions
(keep_ratio=True, pads=the true pads), the pads' round trip, class-wise
NMS, ``mask2poly`` against cv2, the rect buckets, the softmax decode and
``grid_sample_bilinear``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_port_helpers import align_by_box, jax_template_shapes, random_variables

IMG = 320
NUM_CLASSES = 4
_CACHE = {}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    from dfine_tpu.utils.checkpoint import save_params_npz

    if not _CACHE:
        jmodel, shapes = jax_template_shapes("n", NUM_CLASSES, True, IMG)
        variables = random_variables(shapes, seed=5)
        # wider mask logits, so that the served masks are not empty at the
        # detections' threshold (random weights keep them near 0.5)
        variables["params"]["decoder"]["mask_head"]["layers_2"]["kernel"] *= 30
        path = tmp_path_factory.mktemp("weights") / "n.npz"
        save_params_npz(path, variables)
        bgr = np.random.default_rng(8).integers(0, 256, (240, 400, 3), dtype=np.uint8)
        _CACHE.update(jmodel=jmodel, variables=variables, path=path, bgr=bgr)
    yield _CACHE
    _CACHE.clear()


def _jax_decode(jmodel, variables, bgr, mode):
    """The JAX serving program on the float frame: letterbox through
    ``dfine_tpu.ops.preprocess.preprocess_letterbox``, rect as the same
    resize anchored top-left on its stride-32 canvas. Returns (decoded,
    proc_hw, pad)."""
    from dfine_tpu.infer.base import rect_bucket
    from dfine_tpu.ops.preprocess import preprocess_letterbox, resize_bilinear
    from dfine_tpu.postprocess import topk_decode

    raw = jnp.asarray(bgr[None, ..., ::-1].copy())
    h, w = bgr.shape[:2]
    scale = min(IMG / h, IMG / w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    if mode == "letterbox":
        x = preprocess_letterbox(raw, (IMG, IMG))
        pad = ((IMG - nh) // 2, (IMG - nw) // 2)
    else:
        ph, pw = rect_bucket(h, w, (IMG, IMG))
        x = jnp.full((1, ph, pw, 3), 114.0 / 255.0, jnp.float32)
        x = x.at[:, :nh, :nw].set(resize_bilinear(raw.astype(jnp.float32) / 255.0, (nh, nw)))
        pad = (0, 0)

    @jax.jit
    def infer(v, x):
        out = jmodel.apply(v, x, train=False)
        dec = topk_decode(out["pred_logits"], out["pred_boxes"], 300, masks=out["pred_masks"])
        dec["masks"] = dec["masks"][:, :100].astype(jnp.bfloat16)
        return dec

    return jax.tree.map(np.asarray, infer(variables, x)), x.shape[1:3], pad


def _mask_iou(a, b):
    union = (a | b).sum()
    return (a & b).sum() / union if union else 1.0


@pytest.mark.parametrize("mode", ["letterbox", "rect"])
def test_keep_ratio_modes_match_jax_composition(setup, mode):
    """Scores atol 1e-4, boxes atol 0.5 px, each binary mask's IoU with
    JAX's >= 0.98 (bf16 masks; cv2 against F.interpolate resizing); 30-60
    detections kept, cut at the widest score gap, many of whose boxes lie in
    the frame so that their masks are not empty."""
    from dfine_tpu_torch import TorchModel

    from dfine_tpu.postprocess import postprocess_predictions

    bgr = setup["bgr"]
    dec, proc_hw, pad = _jax_decode(setup["jmodel"], setup["variables"], bgr, mode)
    s = np.sort(dec["scores"][0])[::-1]
    n_keep = 30 + int(np.argmax(s[29:59] - s[30:60]))
    conf = float((s[n_keep - 1] + s[n_keep]) / 2)
    ref = postprocess_predictions(dec, proc_hw, [bgr.shape[:2]], conf_thresh=conf,
                                  keep_ratio=True, pads=[pad])[0]
    model = TorchModel("n", str(setup["path"]), NUM_CLASSES, IMG, IMG, conf_thresh=conf,
                       half=False, enable_mask_head=True, device="cpu",
                       keep_ratio=mode == "letterbox", rect=mode == "rect",
                       prebuild_rect_buckets=False)
    ours = model(bgr)[0]
    h, w = bgr.shape[:2]
    assert len(ours["scores"]) == len(ref["scores"]) == n_keep
    scale = np.asarray([w, h, w, h], np.float32)
    match, keep = align_by_box(ref["boxes"] / scale, ours["boxes"] / scale)
    assert keep.all()
    np.testing.assert_array_equal(ours["labels"][match], ref["labels"])
    np.testing.assert_allclose(ours["scores"][match], ref["scores"], atol=1e-4)
    np.testing.assert_allclose(ours["boxes"][match], ref["boxes"], atol=0.5)
    assert ours["masks"].shape == ref["masks"].shape == (n_keep, h, w)
    assert (ref["masks"].reshape(n_keep, -1).sum(1) > 0).sum() >= 5
    ious = [_mask_iou(ours["masks"][j].astype(bool), ref["masks"][i].astype(bool))
            for i, j in enumerate(match)]
    assert min(ious) >= 0.98, ious


@pytest.mark.parametrize("rect,keep_ratio", [(True, False), (False, True)])
def test_preprocess_pads_round_trip_boxes(rect, keep_ratio):
    """tests/test_serving.py:66 on the port: a box mapped into the processed
    frame with the pads preprocessing reports unmaps back to itself (rect
    anchors top-left: (0, 0), on the minimal stride-32 canvas)."""
    from dfine_tpu_torch.infer.base import BaseServing

    m = object.__new__(BaseServing)
    m.device, m.input_size = torch.device("cpu"), (640, 640)
    m.rect, m.keep_ratio, m.use_nms = rect, keep_ratio, False
    m.conf_thresh, m.per_class_conf = 0.5, None
    h0, w0 = 480, 1000
    batch, proc_sizes, orig_sizes, pads = m._prepare_inputs(np.zeros((h0, w0, 3), np.uint8))
    ph, pw = proc_sizes[0]
    assert tuple(batch.shape[2:]) == (ph, pw)
    if rect:
        assert pads[0] == (0, 0) and (ph, pw) == (320, 640)
    else:
        assert pads[0] == ((640 - 307) // 2, 0) and (ph, pw) == (640, 640)
    box = np.asarray([100.0, 50.0, 700.0, 400.0])
    gain = min(ph / h0, pw / w0)
    pt, pl = pads[0]
    bp = box * gain + np.asarray([pl, pt, pl, pt])
    cxcywh = np.asarray([[[(bp[0] + bp[2]) / 2 / pw, (bp[1] + bp[3]) / 2 / ph,
                           (bp[2] - bp[0]) / pw, (bp[3] - bp[1]) / ph]]], np.float32)
    decoded = {"scores": torch.tensor([[0.9]]), "labels": torch.tensor([[0]], dtype=torch.int32),
               "boxes": torch.from_numpy(cxcywh)}
    (res,) = m._postprocess(decoded, proc_sizes, orig_sizes, pads)
    np.testing.assert_allclose(res["boxes"][0], box, atol=1.5)


def test_letterbox_pixels_match_jax():
    """The letterboxed input itself, NCHW against JAX's NHWC: atol 1e-5 on
    [0, 1] values, as for plain resize (test_torch_port_ops.py:152: float32
    interpolation weights computed in another order)."""
    from dfine_tpu.ops.preprocess import preprocess_letterbox as jax_letterbox

    from dfine_tpu_torch.ops.preprocess import preprocess_letterbox

    raw = np.random.default_rng(3).integers(0, 256, (2, 150, 260, 3), dtype=np.uint8)
    ref = np.asarray(jax_letterbox(jnp.asarray(raw), (128, 160)))
    ours, pad = preprocess_letterbox(torch.from_numpy(raw), (128, 160))
    assert pad == ((128 - 92) // 2, 0)
    np.testing.assert_allclose(ours.numpy().transpose(0, 2, 3, 1), ref, atol=1e-5, rtol=0)


def test_rect_buckets_match_jax():
    from dfine_tpu.infer.base import default_rect_buckets as jax_buckets
    from dfine_tpu.infer.base import rect_bucket as jax_bucket

    from dfine_tpu_torch.infer.base import default_rect_buckets
    from dfine_tpu_torch.ops.preprocess import rect_bucket

    assert len(default_rect_buckets((640, 640))) == 7
    for size in ((640, 640), (320, 320), (480, 640)):
        assert default_rect_buckets(size) == jax_buckets(size)
    rng = np.random.default_rng(0)
    for h, w in rng.integers(50, 3000, (200, 2)):
        assert rect_bucket(int(h), int(w), (640, 640)) == jax_bucket(int(h), int(w), (640, 640))


def test_rect_mode_warms_its_buckets_at_load(setup):
    """rect=True makes each canonical bucket's constants at load; a frame
    that lands in one adds none."""
    from dfine_tpu_torch import TorchModel
    from dfine_tpu_torch.infer.base import default_rect_buckets
    from dfine_tpu_torch.ops.preprocess import rect_bucket

    model = TorchModel("n", str(setup["path"]), NUM_CLASSES, IMG, IMG, conf_thresh=0.5,
                       half=False, enable_mask_head=True, device="cpu", rect=True)
    cached = {k[:2] for k in model.model.encoder._pos_cache}
    for h, w in default_rect_buckets((IMG, IMG)):
        assert (w // 32, h // 32) in cached
    n = len(model.model.encoder._pos_cache)
    h, w = default_rect_buckets((IMG, IMG))[0]
    assert rect_bucket(3 * h, 3 * w, (IMG, IMG)) == (h, w)
    model(np.zeros((3 * h, 3 * w, 3), np.uint8))
    assert len(model.model.encoder._pos_cache) == n


def _random_boxes(rng, n, span=100.0):
    xy = rng.uniform(0, span, (n, 2))
    wh = rng.uniform(2, span / 3, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def test_nms_matches_jax():
    """Keep masks equal to ``dfine_tpu.ops.nms`` on random boxes (tied
    scores included), class-wise and not, at three thresholds; and
    tests/test_serving.py:99's cases."""
    from dfine_tpu.ops.nms import batched_class_nms as jax_batched
    from dfine_tpu.ops.nms import nms as jax_nms

    from dfine_tpu_torch.ops.nms import batched_class_nms, nms

    boxes = torch.tensor([[0, 0, 10, 10], [1, 1, 11, 11], [50, 50, 60, 60]], dtype=torch.float32)
    scores = torch.tensor([0.9, 0.8, 0.7])
    assert nms(boxes, scores, 0.5).tolist() == [True, False, True]
    assert batched_class_nms(boxes, scores, torch.tensor([0, 1, 0]), 0.5).tolist() == [True] * 3
    rng = np.random.default_rng(0)
    for trial in range(6):
        n = int(rng.integers(5, 120))
        b = _random_boxes(rng, n)
        s = rng.uniform(size=n).astype(np.float32)
        if trial % 2:
            s = np.round(s * 4) / 4  # ties
        lab = rng.integers(0, 3, n).astype(np.int32)
        for thr in (0.3, 0.5, 0.7):
            ours = nms(torch.from_numpy(b), torch.from_numpy(s), thr).numpy()
            np.testing.assert_array_equal(ours, np.asarray(jax_nms(jnp.asarray(b), jnp.asarray(s), thr)))
            ours = batched_class_nms(torch.from_numpy(b), torch.from_numpy(s),
                                     torch.from_numpy(lab), thr).numpy()
            ref = jax_batched(jnp.asarray(b), jnp.asarray(s), jnp.asarray(lab), thr)
            np.testing.assert_array_equal(ours, np.asarray(ref))


def test_serving_nms_drops_overlaps(setup):
    """``use_nms=True``: the served detections are the plain ones with
    class-wise NMS applied (labels, boxes, scores and masks alike). The
    random weights' boxes rarely overlap: IoU threshold 0.05 suppresses some."""
    from dfine_tpu_torch import TorchModel
    from dfine_tpu_torch.ops.nms import batched_class_nms

    kw = dict(conf_thresh=0.0, half=False, enable_mask_head=True, device="cpu")
    plain = TorchModel("n", str(setup["path"]), NUM_CLASSES, IMG, IMG, **kw)(setup["bgr"])[0]
    served = TorchModel("n", str(setup["path"]), NUM_CLASSES, IMG, IMG, use_nms=True,
                        nms_iou_thresh=0.05, **kw)(setup["bgr"])[0]
    keep = batched_class_nms(*(torch.from_numpy(plain[k]) for k in ("boxes", "scores", "labels")),
                             0.05).numpy()
    assert 0 < keep.sum() < len(keep)
    for k in ("labels", "boxes", "scores", "masks"):
        np.testing.assert_array_equal(served[k], plain[k][keep])


def _cv2_polys(mask, eps=0.005):
    import cv2

    contours, _ = cv2.findContours(mask.astype(np.uint8), cv2.RETR_EXTERNAL,
                                   cv2.CHAIN_APPROX_SIMPLE)
    out = []
    for c in contours:
        if len(c) < 3:
            continue
        a = cv2.approxPolyDP(c, eps * cv2.arcLength(c, True), True).reshape(-1, 2)
        if len(a) >= 3:
            out.append(a.astype(np.float32))
    return out


def _fill(poly, hw):
    import cv2

    m = np.zeros(hw, np.uint8)
    cv2.fillPoly(m, [np.round(poly).astype(np.int32)], 1)
    return m.astype(bool)


def _blob_mask(rng, t):
    h, w = (int(v) for v in rng.integers(30, 160, 2))
    yy, xx = np.mgrid[:h, :w]
    m = np.zeros((h, w), bool)
    for _ in range(int(rng.integers(1, 6))):
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        ry, rx = rng.uniform(1, h / 3), rng.uniform(1, w / 3)
        m |= ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1
    if t % 3 == 0:  # a ring with components in its hole: RETR_EXTERNAL drops them
        m[h // 4 : 3 * h // 4, w // 4 : 3 * w // 4] = True
        m[h // 4 + 3 : 3 * h // 4 - 3, w // 4 + 3 : 3 * w // 4 - 3] = False
        m[h // 2, w // 2] = True
        m[h // 2 - 2 : h // 2 + 3, w // 2 + 5 : w // 2 + 9] = True
    if t % 4 == 0:  # pixels and lines on the border: under 3 points, dropped
        m[0, :5] = True
        m[-1, -1] = True
        m[5:8, -1] = True
    return m.astype(np.uint8)


def test_mask2poly_matches_cv2():
    """cv2 as the witness: the same number of polygons, and each of cv2's
    polygons rasterized has IoU >= 0.98 with one of ours."""
    from dfine_tpu_torch.infer.base import BaseServing

    rng = np.random.default_rng(0)
    for t in range(24):
        m = _blob_mask(rng, t)
        ref, ours = _cv2_polys(m), BaseServing.mask2poly(m)
        assert len(ours) == len(ref), t
        assert all(p.dtype == np.float32 and p.shape[1] == 2 and len(p) >= 3 for p in ours)
        for r in ref:
            fr = _fill(r, m.shape)
            assert max(_mask_iou(fr, _fill(o, m.shape)) for o in ours) >= 0.98, t
    assert BaseServing.mask2poly(np.zeros((8, 8), np.uint8)) == []


def test_softmax_decode_matches_jax():
    from dfine_tpu.postprocess import topk_decode as jax_decode

    from dfine_tpu_torch.postprocess import topk_decode

    rng = np.random.default_rng(2)
    logits = rng.normal(size=(2, 40, 6)).astype(np.float32)
    boxes = rng.uniform(size=(2, 40, 4)).astype(np.float32)
    ref = jax_decode(jnp.asarray(logits), jnp.asarray(boxes), 25, use_focal_loss=False)
    ours = topk_decode(torch.from_numpy(logits), torch.from_numpy(boxes), 25, use_focal_loss=False)
    for k in ("scores", "labels", "boxes", "qidx"):
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(ref[k]), atol=1e-6, err_msg=k)


def test_grid_sample_bilinear_matches_jax():
    """tests/test_ops.py:144's inputs: atol 1e-5."""
    from dfine_tpu.ops.deform_attn import grid_sample_bilinear as jax_grid_sample

    from dfine_tpu_torch.ops.deform_attn import grid_sample_bilinear

    rng = np.random.default_rng(3)
    img = rng.normal(size=(2, 7, 9, 3)).astype(np.float32)
    grid = rng.uniform(-1.3, 1.3, size=(2, 5, 4, 2)).astype(np.float32)
    ref = np.asarray(jax_grid_sample(jnp.asarray(img), jnp.asarray(grid)))
    ours = grid_sample_bilinear(torch.from_numpy(img), torch.from_numpy(grid))
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-5)
