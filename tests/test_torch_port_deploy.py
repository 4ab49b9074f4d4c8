"""What the port does to a model before serving it, against the JAX package
on the CPU at n, 320 px, fp32, with re-drawn weights: reference ``.pth``
weights (with an 80 -> 3 class-head map) against
``dfine_tpu.utils.checkpoint.load_torch_checkpoint``, the serving fold
against the unfused model and JAX ``convert_to_deploy``, int8 conversion and both
int8 modes against JAX ``convert_params_int8`` / ``apply_int8``, and the
kernels' limits checked where a model reaches the card."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_port_helpers import (align_by_box, jax_template_shapes, port_model_from,
                                     random_variables)

IMG = 320
_CACHE = {}


def _setup(num_classes, mask_head, seed):
    key = (num_classes, mask_head, seed)
    if key not in _CACHE:
        jmodel, shapes = jax_template_shapes("n", num_classes, mask_head, IMG)
        _CACHE[key] = jmodel, random_variables(shapes, seed=seed)
    return _CACHE[key]


@pytest.fixture(scope="module", autouse=True)
def _drop_cache():
    yield
    _CACHE.clear()


def _image(seed=2):
    return np.random.default_rng(seed).uniform(size=(1, IMG, IMG, 3)).astype(np.float32)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _pairs(ref, ours):
    """Queries aligned by box: (the share matched 1:1, {output: (ours, ref)}
    of the matched rows, as numpy)."""
    ours = {k: np.asarray(v) for k, v in ours.items()}
    rb, ob = np.asarray(ref["pred_boxes"])[0], ours["pred_boxes"][0]
    match, keep = align_by_box(rb, ob)
    return keep.mean(), {k: (ours[k][0][match[keep]], np.asarray(ref[k])[0][keep]) for k in ref}


def _aligned(ref, ours):
    """``_pairs``, with >= 98 % of the queries matched 1:1."""
    share, pairs = _pairs(ref, ours)
    assert share >= 0.98, f"only {share:.3f} of queries matched 1:1"
    return pairs


def _over(pairs, tol):
    """The largest |ours - ref| / (atol + rtol |ref|) of each output of
    ``tol`` ({output: (atol, rtol)})."""
    return {k: float((np.abs(a - b) / (tol[k][0] + tol[k][1] * np.abs(b))).max())
            for k, (a, b) in pairs.items() if k in tol}


def _compare(ref, ours, box_tol=(5e-4, 1e-3)):
    """As test_torch_port_model.py holds the model: boxes (atol, rtol)
    ``box_tol``, logits atol 2e-3, rtol 1e-2, masks atol 1e-3."""
    pairs = _aligned(ref, ours)
    np.testing.assert_allclose(*pairs["pred_boxes"], atol=box_tol[0], rtol=box_tol[1])
    np.testing.assert_allclose(*pairs["pred_logits"], atol=2e-3, rtol=1e-2)
    if "pred_masks" in pairs:
        np.testing.assert_allclose(*pairs["pred_masks"], atol=1e-3)


def _reference_buffers(sd):
    """The buffers a reference state dict carries beside the weights, which
    both importers skip (dfine_tpu/utils/checkpoint.py:150-156)."""
    sd = dict(sd)
    sd["decoder.anchors"] = torch.zeros(1, 500, 4)
    sd["decoder.valid_mask"] = torch.zeros(1, 500, 1, dtype=torch.bool)
    sd["decoder.decoder.up"] = torch.tensor([0.5])
    sd["decoder.decoder.reg_scale"] = torch.tensor([4.0])
    sd["decoder.decoder.layers.0.cross_attn.num_points_scale"] = torch.ones(12)
    sd["decoder.decoder.project"] = torch.zeros(33)
    return sd


def test_pth_with_class_map_matches_jax_importer(tmp_path):
    """An 80-class detect state dict, saved as the reference saves it
    ({"model": ...} with its derived buffers), loaded into a 3-class model:
    the score heads' rows mapped COCO <- Objects365 and the denoising
    embedding kept, as JAX's importer does; the eval outputs against JAX on
    the same weights at the model parity test's tolerances."""
    from dfine_tpu.utils.checkpoint import load_torch_checkpoint as jax_load

    from dfine_tpu_torch.infer.base import load_weights
    from dfine_tpu_torch.models.dfine import build_model

    _, variables80 = _setup(80, False, 31)
    source = port_model_from(variables80, "n", 80, False)
    path = tmp_path / "ref.pth"
    torch.save({"model": _reference_buffers(source.state_dict())}, path)

    jmodel, template = _setup(3, False, 32)
    jvars = jax_load(path, template, verbose=False)
    port = load_weights(build_model("n", 3, False, device="cpu"), str(path))
    head = port.decoder.dec_score_head[0].weight
    src = source.decoder.dec_score_head[0].weight
    torch.testing.assert_close(head, src[[1, 47, 6]], rtol=0, atol=0)  # OBJ365_IDS[:3] + 1
    x = _image()
    ref = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(jvars, jnp.asarray(x))
    with torch.no_grad():
        ours = port(_nchw(x))
    _compare(ref, ours)


def test_pth_round_trip_and_strictness(tmp_path):
    """det+seg: port state_dict -> .pth -> ``TorchModel`` serves the same
    answers as from the JAX npz (the JAX importer maps the pixel decoder's
    ConvTranspose wrongly, so det+seg is held as a round trip). A stray or
    a missing key raises."""
    from dfine_tpu.utils.checkpoint import save_params_npz

    from dfine_tpu_torch import TorchModel
    from dfine_tpu_torch.infer.base import load_weights
    from dfine_tpu_torch.models.dfine import build_model

    _, variables = _setup(3, True, 33)
    sd = port_model_from(variables, "n", 3, True).state_dict()
    torch.save(_reference_buffers(sd), tmp_path / "w.pth")
    save_params_npz(tmp_path / "w.npz", variables)
    bgr = np.random.default_rng(4).integers(0, 256, (200, 260, 3), dtype=np.uint8)
    kw = dict(conf_thresh=0.0, half=False, enable_mask_head=True, device="cpu")
    a = TorchModel("n", str(tmp_path / "w.pth"), 3, IMG, IMG, **kw)(bgr)[0]
    b = TorchModel("n", str(tmp_path / "w.npz"), 3, IMG, IMG, **kw)(bgr)[0]
    for k in ("scores", "labels", "boxes", "masks"):
        np.testing.assert_array_equal(a[k], b[k])

    stray = dict(sd, **{"decoder.stray.weight": torch.zeros(2)})
    with pytest.raises(RuntimeError, match="stray"):
        load_weights(build_model("n", 3, True, device="cpu"), _save(tmp_path / "s.pth", stray))
    missing = {k: v for k, v in sd.items() if k != "decoder.enc_score_head.bias"}
    with pytest.raises(RuntimeError, match="enc_score_head.bias"):
        load_weights(build_model("n", 3, True, device="cpu"), _save(tmp_path / "m.pth", missing))
    with pytest.raises(NotImplementedError, match="trainer state"):
        load_weights(build_model("n", 3, True, device="cpu"), str(tmp_path))


def _save(path, sd):
    torch.save(sd, path)
    return str(path)


def test_deploy_fusion_matches_unfused_and_jax():
    """det+seg: the serving fold (``fold_for_serving``, fp32) against the
    unfused port model and against JAX ``convert_to_deploy`` on the same
    weights, queries aligned by box (test_serving.py:24: boxes rtol 2e-3,
    atol 2e-4; logits and masks at the model parity test's tolerances).
    After the fold every BatchNorm is a ``FoldedBatchNorm2d`` and every
    VGGBlock a ``FoldedVGGBlock`` (one 3x3 conv)."""
    from dfine_tpu.infer.fuse import convert_to_deploy as jax_deploy

    from dfine_tpu_torch.infer.fuse import FoldedBatchNorm2d, FoldedVGGBlock, fold_for_serving
    from dfine_tpu_torch.models.layers import BatchNorm2d, VGGBlock

    jmodel, variables = _setup(3, True, 34)
    x = _image(5)
    unfused = port_model_from(variables, "n", 3, True)
    with torch.no_grad():
        before = unfused(_nchw(x))
        fused = fold_for_serving(unfused, torch.float32)
        after = fused(_nchw(x))
    mods = list(fused.modules())
    assert any(isinstance(m, BatchNorm2d) for m in mods)
    assert all(type(m) is FoldedBatchNorm2d for m in mods if isinstance(m, BatchNorm2d))
    assert any(isinstance(m, VGGBlock) for m in mods)
    assert all(type(m) is FoldedVGGBlock for m in mods if isinstance(m, VGGBlock))
    _compare(before, after, box_tol=(2e-4, 2e-3))
    jfused = jax.tree.map(jnp.asarray, jax_deploy(jax.tree.map(np.asarray, variables)))
    ref = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(jfused, jnp.asarray(x))
    _compare(ref, after, box_tol=(2e-4, 2e-3))


def test_int8_weights_equal_jax_bit_for_bit():
    """Every 2-D kernel JAX quantizes is an ``Int8Linear`` in the port, with
    the same int8 values (transposed) and scales; ``count_int8`` agrees."""
    from flax import traverse_util

    from dfine_tpu.infer.int8 import convert_params_int8, count_int8 as jax_count

    from dfine_tpu_torch.infer.int8 import Int8Linear, convert_int8, count_int8
    from dfine_tpu_torch.models.layers import MultiHeadSelfAttention
    from dfine_tpu_torch.utils.checkpoint import flax_key

    _, variables = _setup(3, True, 35)
    v8 = convert_params_int8(jax.tree.map(np.asarray, variables))
    flat = traverse_util.flatten_dict(v8["params"], sep="/")
    scales = traverse_util.flatten_dict(v8["quant"], sep="/")
    port = convert_int8(port_model_from(variables, "n", 3, True))
    seen = set()
    for name, m in port.named_modules():
        if not isinstance(m, Int8Linear):
            continue
        parent = name.rsplit(".", 1)[0]
        is_in_proj = isinstance(port.get_submodule(parent), MultiHeadSelfAttention) and \
            name.endswith(".in_proj")
        key = (parent + ".in_proj_weight") if is_in_proj else (name + ".weight")
        fkey = flax_key(key, 2)[0][len("params/"):]
        np.testing.assert_array_equal(m.qweight[: m.out_features, : m.in_features].numpy(),
                                      flat[fkey].T, err_msg=fkey)
        np.testing.assert_array_equal(m.scale[: m.out_features].numpy(),
                                      scales[fkey[: -len("/kernel")] + "/scale"], err_msg=fkey)
        seen.add(fkey)
    assert seen == {k for k, v in flat.items() if np.asarray(v).dtype == np.int8}
    assert count_int8(port) == jax_count(v8)


@pytest.mark.parametrize("mode", ["w8a8", "w8a16"])
def test_int8_model_matches_jax_apply_int8(mode):
    """n detect, fp32 compute, the same int8 mode on both sides, queries
    aligned by box. w8a16 at the model parity test's tolerances. w8a8
    quantizes each activation row, so its output jumps where an element
    crosses a rounding edge: fp32 values that differ in their last bits (the
    port's and JAX's, after the backbone and encoder agree within 3e-7) can
    round to neighbouring int8 values, and the decoder carries that on. So
    w8a8 is held to JAX's own reaction to its input perturbed by 1e-7
    relative (the size of fp32 rounding): the port's largest logit and box
    differences within twice JAX's (at n@320, seed 36: 0.025 and 5.8e-4
    against 0.033 and 1.1e-3).

    Each mode's rule must fail the port run in the other mode, by 3 times a
    limit: with w8a16 in place of w8a8, 57 % of the queries match and their
    boxes read 67.3 times the limit (logits 1.23 times); with w8a8 in place
    of w8a16, 44 % match, boxes 94.7 and logits 118.7 times the tolerance."""
    from dfine_tpu.infer.int8 import apply_int8, convert_params_int8
    from dfine_tpu.infer.int8 import set_int8_mode as jax_set_mode

    from dfine_tpu_torch.infer.int8 import convert_int8, set_int8_mode

    other = {"w8a8": "w8a16", "w8a16": "w8a8"}[mode]
    jmodel, variables = _setup(3, False, 36)
    v8 = jax.tree.map(jnp.asarray, convert_params_int8(jax.tree.map(np.asarray, variables)))
    port = convert_int8(port_model_from(variables, "n", 3, False))
    x = _image(6)
    infer = jax.jit(lambda v, x: apply_int8(jmodel, v, x, train=False))
    jax_set_mode(mode)
    set_int8_mode(mode)
    try:
        ref = infer(v8, jnp.asarray(x))
        with torch.no_grad():
            ours = port(_nchw(x))
        if mode == "w8a8":
            noise = np.random.default_rng(9).standard_normal(x.shape)
            moved = infer(v8, jnp.asarray((x * (1 + 1e-7 * noise)).astype(np.float32)))
        set_int8_mode(other)
        with torch.no_grad():
            wrong = port(_nchw(x))
    finally:
        jax_set_mode("w8a16")
        set_int8_mode("w8a16")
    if mode == "w8a16":
        _compare(ref, ours)
        tol = {"pred_logits": (2e-3, 1e-2), "pred_boxes": (5e-4, 1e-3)}  # _compare's
    else:
        pairs, own = _aligned(ref, ours), _aligned(ref, moved)
        tol = {k: (2 * np.abs(own[k][0] - own[k][1]).max(), 0.0)
               for k in ("pred_logits", "pred_boxes")}
        over = _over(pairs, tol)
        assert max(over.values()) <= 1, over
    share, pairs = _pairs(ref, wrong)
    over = _over(pairs, tol)
    assert share < 0.98 and max(over.values()) >= 3, (share, over)


def test_int8_modes_and_product():
    from dfine_tpu_torch.infer.int8 import Int8Linear, _int_product, int8_mode, set_int8_mode

    assert int8_mode() == "w8a16"
    with pytest.raises(ValueError, match="not ported"):
        set_int8_mode("w8a16_packed")
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.integers(-127, 128, (5, 1024)).astype(np.int8))
    b = torch.from_numpy(rng.integers(-127, 128, (24, 1024)).astype(np.int8))
    exact = a.numpy().astype(np.int64) @ b.numpy().astype(np.int64).T
    np.testing.assert_array_equal(_int_product(a, b).numpy(), exact)
    lin = Int8Linear(torch.randn(20, 13), torch.randn(20))  # K, N not multiples of 8: padded
    assert lin.qweight.shape == (24, 16) and lin(torch.randn(2, 7, 13)).shape == (2, 7, 20)


def test_kernel_limits_are_checked_before_the_card():
    """17 sampling points over n's 2 levels raise and name the limit 16; a
    head dim the kernels refuse (48: n widened to 384) raises and names
    ``decoder.hidden_dim // encoder.nhead``; m with ``layer_scale`` 2 (head
    dim 64 in the wide layers) passes, and with ``encoder.nhead`` 4 as well
    (head dim 128 in the wide layers) raises and names
    ``decoder.layer_scale``; five levels raise; every shipped size passes."""
    from dfine_tpu_torch.models.dfine import DFINE
    from dfine_tpu_torch.ops.kernels import check_kernel_limits

    wide = (("decoder.layer_scale", 2), ("decoder.eval_idx", 1))
    with torch.device("meta"):
        with pytest.raises(ValueError, match="at most 16"):
            check_kernel_limits(DFINE("n", 3, cfg_overrides=(("decoder.num_points", [8, 9]),)))
        with pytest.raises(ValueError, match=r"head dim decoder\.hidden_dim // encoder\.nhead = 48"):
            check_kernel_limits(DFINE("n", 3, cfg_overrides=(("decoder.hidden_dim", 384),
                                                             ("encoder.hidden_dim", 384))))
        check_kernel_limits(DFINE("m", 3, cfg_overrides=wide))
        with pytest.raises(ValueError, match=r"layer 2: head dim decoder\.hidden_dim \* "
                                             r"decoder\.layer_scale // encoder\.nhead = 128"):
            check_kernel_limits(DFINE("m", 3, cfg_overrides=wide + (("encoder.nhead", 4),)))
        with pytest.raises(ValueError, match="decoder.num_levels = 5"):
            check_kernel_limits(DFINE("m", 3, cfg_overrides=(("decoder.num_levels", 5),
                                                             ("decoder.num_points", [3] * 5))))
        for size in ("n", "s", "m", "l", "x"):
            check_kernel_limits(DFINE(size, 80, True))
