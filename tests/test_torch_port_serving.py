"""``TorchModel.__call__`` against the JAX composition it ports:
preprocess_plain -> model.apply -> topk_decode -> postprocess_predictions,
at size n det+seg, 320 px, fp32, with the same re-drawn weights (shipped to
the port as the npz that ``dfine_tpu`` writes)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_port_helpers import align_by_box, jax_template_shapes, random_variables

IMG = 320
NUM_CLASSES = 4


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    from dfine_tpu.utils.checkpoint import save_params_npz

    jmodel, shapes = jax_template_shapes("n", NUM_CLASSES, True, IMG)
    variables = random_variables(shapes, seed=5)
    path = tmp_path_factory.mktemp("weights") / "n.npz"
    save_params_npz(path, variables)
    bgr = np.random.default_rng(8).integers(0, 256, (240, 400, 3), dtype=np.uint8)
    return jmodel, variables, path, bgr


def _jax_serve(jmodel, variables, bgr, conf, per_class=None):
    from dfine_tpu.ops.preprocess import preprocess_plain
    from dfine_tpu.postprocess import postprocess_predictions, topk_decode

    @jax.jit
    def infer(v, raw):
        out = jmodel.apply(v, preprocess_plain(raw, (IMG, IMG)), train=False)
        dec = topk_decode(out["pred_logits"], out["pred_boxes"], 300, masks=out["pred_masks"])
        dec["masks"] = dec["masks"][:, :100].astype(jnp.bfloat16)
        return dec

    dec = jax.tree.map(np.asarray, infer(variables, jnp.asarray(bgr[None, ..., ::-1].copy())))
    return postprocess_predictions(dec, (IMG, IMG), [bgr.shape[:2]], conf_thresh=conf,
                                   per_class_conf=per_class)[0]


def _compare(ref, ours, hw):
    assert len(ours["scores"]) == len(ref["scores"]) > 0
    scale = np.asarray([hw[1], hw[0], hw[1], hw[0]], np.float32)
    match, keep = align_by_box(ref["boxes"] / scale, ours["boxes"] / scale)
    assert keep.all()
    np.testing.assert_array_equal(ours["labels"][match], ref["labels"])
    np.testing.assert_allclose(ours["scores"][match], ref["scores"], atol=1e-4)
    np.testing.assert_allclose(ours["boxes"][match], ref["boxes"], atol=0.5)  # pixels
    assert ours["masks"].shape == ref["masks"].shape and ours["masks"].dtype == np.uint8
    differ = (ours["masks"][match] != ref["masks"]).mean()
    assert differ <= 1e-3, f"{differ:.5f} of mask pixels differ"


def test_torch_model_matches_jax_composition(setup):
    """Scalar and per-class thresholds; scores atol 1e-4, boxes atol 0.5 px,
    at most 0.1% of mask pixels differing (bf16 masks and cv2 vs
    F.interpolate resizing)."""
    from dfine_tpu_torch import TorchModel

    jmodel, variables, path, bgr = setup
    first = _jax_serve(jmodel, variables, bgr, 0.0)
    s = np.sort(first["all_scores"])[::-1]
    conf = float((s[11] + s[12]) / 2)  # keep 12 detections, away from any tie
    ref = _jax_serve(jmodel, variables, bgr, conf)
    model = TorchModel("n", str(path), NUM_CLASSES, IMG, IMG, conf_thresh=conf, half=False,
                       enable_mask_head=True, device="cpu")
    _compare(ref, model(bgr)[0], bgr.shape[:2])

    per_class = [conf, float((s[5] + s[6]) / 2), conf, 1.0]
    ref_pc = _jax_serve(jmodel, variables, bgr, min(per_class), dict(enumerate(per_class)))
    model_pc = TorchModel("n", str(path), NUM_CLASSES, IMG, IMG, conf_thresh=per_class,
                          half=False, enable_mask_head=True, device="cpu")
    out = model_pc([bgr, bgr])
    assert len(out) == 2
    _compare(ref_pc, out[1], bgr.shape[:2])


def test_model_takes_a_backward_after_serving():
    """Constants cached during an inference-mode call (anchors, FDR
    projection, sampling scales, positional embedding) must not be inference
    tensors: the same model then takes a backward, as the gradient path does."""
    from dfine_tpu_torch.models.dfine import build_model

    model = build_model("n", 3, True, device="cpu")
    x = torch.from_numpy(np.random.default_rng(1).uniform(size=(1, 3, 128, 128)).astype(np.float32))
    with torch.inference_mode():
        model(x)
    out = model(x)
    (out["pred_boxes"].mean() + out["pred_masks"].mean()).backward()
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    assert grads and all(torch.isfinite(g).all() for g in grads)


def test_entry_points_need_the_card_unless_asked():
    from dfine_tpu_torch import TorchModel, build_model

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model("n", 3)
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchModel("n", None, 3, IMG, IMG)
