"""The serving fold (``infer/fuse.py::fold_for_serving``) on the CPU, at l
detection and x det+seg, 160 px: the served model against the unfused one on
the same weights (``TorchModel``, and ``AOTModel``'s eager CPU program), its
state dict, a strict load after the build, the bf16 fold's rounding, the
``serve.folds`` counter, and the train path kept apart.

Weights: ``build_model``'s draw re-drawn from a seed, the leaves its
initializers zero (the box heads' last layers, the sampling offsets) drawn
too, so that the boxes are not the anchors, and every BatchNorm's affine
and statistics drawn away from the identity, so that each fold moves the
weights."""

import numpy as np
import pytest
import torch

IMG = 160
NUM_CLASSES = 3
CASES = {"l": ("l", False), "x_seg": ("x", True)}
# pairs plus VGGBlock branches folded by one fold: l 169 + 24, x det+seg
# 227 (222 that the JAX package folds and the pixel decoder's 5) + 24
FOLDS = {"l": 193, "x_seg": 251}
# backbone ConvBNs with a ReLU and groups 1 (one cuDNN conv-bias-ReLU call on the card)
RELU_CONVS = {"l": 29, "x_seg": 43}
_CACHE = {}


@pytest.fixture(scope="module", autouse=True)
def _drop_cache():
    yield
    _CACHE.clear()


def draw(size, mask, seed, num_classes=NUM_CLASSES):
    """An fp32 unfused model on the CPU holding weights drawn from ``seed``
    (the module doc's draw)."""
    from dfine_tpu_torch.models.dfine import build_model, reset_parameters
    from dfine_tpu_torch.models.layers import BatchNorm2d

    g = torch.Generator().manual_seed(seed)
    model = build_model(size, num_classes, mask, device="cpu")
    with torch.no_grad():
        reset_parameters(model, g)
        for p in model.parameters():
            if p.dim() > 1 and not p.any():
                p.uniform_(-0.5 / p.shape[1] ** 0.5, 0.5 / p.shape[1] ** 0.5, generator=g)
        for m in model.modules():
            if isinstance(m, BatchNorm2d):
                m.weight.uniform_(0.8, 1.2, generator=g)
                m.bias.normal_(0.0, 0.1, generator=g)
                m.running_mean.normal_(0.0, 0.1, generator=g)
                m.running_var.uniform_(0.7, 1.4, generator=g)
    return model


def _setup(case, tmp_path_factory):
    """(unfused model A, its .pth, unfused model B's state dict), cached."""
    if case not in _CACHE:
        size, mask = CASES[case]
        a = draw(size, mask, 1)
        path = tmp_path_factory.mktemp("weights") / f"{case}.pth"
        torch.save(a.state_dict(), path)
        b = draw(size, mask, 2).state_dict()
        _CACHE[case] = a, str(path), b
    return _CACHE[case]


def _backend(cls, case, path, half=False):
    size, mask = CASES[case]
    return cls(size, path, NUM_CLASSES, IMG, IMG, conf_thresh=0.0, half=half,
               enable_mask_head=mask, device="cpu")


def _image(seed=3):
    return torch.from_numpy(np.random.default_rng(seed).uniform(size=(1, 3, IMG, IMG))
                            .astype(np.float32))


def _compare(ref, ours, boxes="pred_boxes", logits="pred_logits", masks="pred_masks"):
    """test_torch_port_deploy.py's folded-against-unfused rule, queries aligned
    by box (>= 98 % 1:1): boxes atol 2e-4, rtol 2e-3; logits atol 2e-3, rtol
    1e-2; masks atol 1e-3, and one bf16 step (rtol 2^-7) where the decode
    rounds them to bf16."""
    from test_torch_port_helpers import align_by_box

    mask_rtol = 2.0 ** -7 if masks in ref and ref[masks].dtype == torch.bfloat16 else 0.0
    ref = {k: v[0].float().numpy() for k, v in ref.items() if v.is_floating_point()}
    ours = {k: v[0].float().numpy() for k, v in ours.items() if v.is_floating_point()}
    match, keep = align_by_box(ref[boxes], ours[boxes])
    assert keep.mean() >= 0.98, f"only {keep.mean():.3f} of queries matched 1:1"
    for k, atol, rtol in ((boxes, 2e-4, 2e-3), (logits, 2e-3, 1e-2), (masks, 1e-3, mask_rtol)):
        if k in ref:  # the decode keeps the masks of the first 100 queries
            rows = np.flatnonzero(keep & (np.arange(len(keep)) < len(ref[k]))
                                  & (match < len(ours[k])))
            np.testing.assert_allclose(ours[k][match[rows]], ref[k][rows], atol=atol, rtol=rtol,
                                       err_msg=k)


@pytest.mark.parametrize("case", list(CASES))
def test_torch_model_matches_unfused(case, tmp_path_factory):
    """``TorchModel``'s served model against the unfused model on the same
    weights: boxes, logits and masks."""
    from dfine_tpu_torch import TorchModel

    unfused, path, _ = _setup(case, tmp_path_factory)
    served = _backend(TorchModel, case, path)
    x = _image()
    with torch.no_grad():
        _compare(unfused(x), served.model(x))


@pytest.mark.parametrize("case", list(CASES))
def test_aot_program_matches_unfused(case, tmp_path_factory):
    """``AOTModel``'s fixed-shape program (eager on the CPU) against the
    serving program on the unfused model: top-k boxes, scores and masks."""
    from dfine_tpu_torch import AOTModel
    from dfine_tpu_torch.infer.torch_model import decode

    unfused, path, _ = _setup(case, tmp_path_factory)
    served = _backend(AOTModel, case, path)
    x = _image(4)
    with torch.inference_mode():
        ref = decode(unfused, x, served.num_top_queries)
        ours = served._predict(x)
    _compare(ref, ours, boxes="boxes", logits="scores", masks="masks")


@pytest.mark.parametrize("case", list(CASES))
def test_state_dict_is_the_unfused_models(case, tmp_path_factory):
    """bf16: the served model's state dict has the unfused model's keys,
    shapes and dtypes (``set_compute_dtype``'s), and none of the folded
    tensors."""
    from dfine_tpu_torch import TorchModel
    from dfine_tpu_torch.models.dfine import set_compute_dtype

    _, path, _ = _setup(case, tmp_path_factory)
    served = _backend(TorchModel, case, path, half=True).model.state_dict()
    size, mask = CASES[case]
    want = set_compute_dtype(draw(size, mask, 0), torch.bfloat16).state_dict()
    assert list(served) == list(want)
    assert {k: (v.shape, v.dtype) for k, v in served.items()} == \
        {k: (v.shape, v.dtype) for k, v in want.items()}
    assert not any("folded" in k for k in served)


@pytest.mark.parametrize("case", list(CASES))
def test_strict_load_after_build_refolds(case, tmp_path_factory):
    """A strict ``load_state_dict`` of other weights into the built backend's
    model: the same outputs as a fresh unfused model holding them (and not
    those of the weights it was built with); the folded tensors keep their
    storage, as a captured graph reads them."""
    from dfine_tpu_torch import TorchModel
    from dfine_tpu_torch.infer.fuse import FoldedConv2d
    from dfine_tpu_torch.models.dfine import build_model

    unfused_a, path, b = _setup(case, tmp_path_factory)
    served = _backend(TorchModel, case, path)
    ptrs = {n: m.folded_weight.data_ptr() for n, m in served.model.named_modules()
            if isinstance(m, FoldedConv2d)}
    served.model.load_state_dict(b, strict=True)
    assert ptrs == {n: m.folded_weight.data_ptr() for n, m in served.model.named_modules()
                    if isinstance(m, FoldedConv2d)}
    size, mask = CASES[case]
    fresh = build_model(size, NUM_CLASSES, mask, device="cpu")
    fresh.load_state_dict(b, strict=True)
    x = _image(5)
    with torch.no_grad():
        ours, ref, old = served.model(x), fresh(x), unfused_a(x)
    _compare(ref, ours)
    with pytest.raises(AssertionError):
        _compare(old, ours)


@pytest.mark.parametrize("case", list(CASES))
def test_bf16_fold_is_rounded_once(case, tmp_path_factory):
    """bf16: each folded weight and bias equals the fp32 fold rounded once
    to bf16, at the build and after a load, the fp32 fold taken by ``fold``
    and ``merge_branch`` over the state dict (from the incoming fp32
    values, not the stored bf16 weights: folding those differs in a share
    of the elements)."""
    from dfine_tpu_torch import TorchModel
    from dfine_tpu_torch.infer.fuse import (FoldedConv2d, FoldedConvTranspose2d, FoldedVGGBlock,
                                            fold, merge_branch)

    unfused, path, b = _setup(case, tmp_path_factory)
    served = _backend(TorchModel, case, path, half=True).model
    pix = "decoder.pixel_decoder."
    pix_bn = {"lateral.0": "bn.0", "lateral.1": "bn.1", "lateral.2": "bn.2", "enc_proj": "enc_bn",
              "upconv": "bn1"}

    def pair(sd, conv, bn, dim=0):
        return fold(sd[conv + ".weight"], sd.get(conv + ".bias"), sd[bn + ".weight"],
                    sd[bn + ".bias"], sd[bn + ".running_mean"], sd[bn + ".running_var"],
                    served.get_submodule(bn).eps, dim)

    def expected(name, sd):
        """The fp32 fold of the folded conv ``name`` from the state dict ``sd``."""
        if name.startswith(pix):
            conv = name[len(pix):]
            return pair(sd, name, pix + pix_bn[conv], dim=1 if conv == "upconv" else 0)
        block = name[: -len(".conv1.conv")]
        if name.endswith(".conv1.conv") and type(served.get_submodule(block)) is FoldedVGGBlock:
            return merge_branch(*pair(sd, f"{block}.conv1.conv", f"{block}.conv1.norm"),
                                *pair(sd, f"{block}.conv2.conv", f"{block}.conv2.norm"))
        owner = name[: -len(".conv")]
        return pair(sd, name, owner + (".bn" if owner + ".bn.weight" in sd else ".norm"))

    folded = {n: m for n, m in served.named_modules()
              if isinstance(m, (FoldedConv2d, FoldedConvTranspose2d))}
    assert len(folded) == FOLDS[case] - 2 * 24  # a VGGBlock's two pairs and branch: one conv
    for n, m in folded.items():
        w, bias = expected(n, unfused.state_dict())
        assert torch.equal(m.folded_weight, w.to(torch.bfloat16)), n
        assert torch.equal(m.folded_bias, bias.to(torch.bfloat16)), n
    served.load_state_dict(b, strict=True)
    stored, twice = served.state_dict(), 0
    for n, m in folded.items():
        w, bias = expected(n, b)
        assert torch.equal(m.folded_weight, w.to(torch.bfloat16)), n
        assert torch.equal(m.folded_bias, bias.to(torch.bfloat16)), n
        if not n.startswith(pix) and not n.endswith("conv1.conv"):  # one pair: fold the bf16
            owner = n[: -len(".conv")]
            bn = owner + (".bn" if owner + ".bn.weight" in stored else ".norm")
            w2 = fold(stored[n + ".weight"], None, *(stored[f"{bn}.{a}"] for a in (
                "weight", "bias", "running_mean", "running_var")), served.get_submodule(bn).eps)[0]
            twice += int((w2.to(torch.bfloat16) != m.folded_weight).sum())
    assert twice > 0


@pytest.mark.parametrize("case", list(CASES))
def test_serve_folds_counts_each_fold(case, tmp_path_factory):
    """``serve.folds`` counts the pairs and branches folded: once at the
    build and once at each load; the served model holds no BatchNorm that
    runs, every VGGBlock runs one conv, and every ReLU ConvBN without
    groups, and no other, is a ``FoldedConvBNReLU``."""
    from dfine_tpu_torch import TorchModel
    from dfine_tpu_torch.infer.fuse import FoldedBatchNorm2d, FoldedConvBNReLU, FoldedVGGBlock
    from dfine_tpu_torch.models.layers import BatchNorm2d, ConvBN, VGGBlock
    from dfine_tpu_torch.utils import profiling

    _, path, b = _setup(case, tmp_path_factory)
    profiling.drain()
    with profiling.tracing(True):
        served = _backend(TorchModel, case, path)
        built = profiling.drain()["counters"].get("serve.folds")
        served.model.load_state_dict(b, strict=True)
        loaded = profiling.drain()["counters"].get("serve.folds")
    assert (built, loaded) == (FOLDS[case], FOLDS[case])
    mods = list(served.model.modules())
    assert all(type(m) is FoldedBatchNorm2d for m in mods if isinstance(m, BatchNorm2d))
    assert all(type(m) is FoldedVGGBlock for m in mods if isinstance(m, VGGBlock))
    assert sum(isinstance(m, FoldedVGGBlock) for m in mods) == 24
    fused = [isinstance(m, FoldedConvBNReLU) for m in mods if isinstance(m, ConvBN)]
    assert fused == [m.act == "relu" and m.conv.groups == 1 for m in mods if isinstance(m, ConvBN)]
    assert sum(fused) == RELU_CONVS[case]


@pytest.mark.parametrize("case", list(CASES))
def test_train_path_holds_no_folded_module(case, tmp_path_factory):
    """After a serving backend was built in the process, ``build_model`` and
    a train state (model and EMA) for ``make_train_step`` hold the plain
    classes, no folded tensor and no load hook, and their BatchNorms run."""
    from dfine_tpu_torch import TorchModel
    from dfine_tpu_torch.infer import fuse
    from dfine_tpu_torch.models.dfine import build_model
    from dfine_tpu_torch.train.criterion import CriterionConfig
    from dfine_tpu_torch.train.optim import OptimConfig, build_optimizer
    from dfine_tpu_torch.train.train_step import TrainState, make_train_step

    _, path, _ = _setup(case, tmp_path_factory)
    _backend(TorchModel, case, path)
    size, mask = CASES[case]
    model = build_model(size, NUM_CLASSES, mask, device="cpu")
    state = TrainState.create(model, build_optimizer(model, OptimConfig()))
    step = make_train_step(CriterionConfig())
    assert step.graphs == {}
    folded = (fuse.FoldedConv2d, fuse.FoldedConvTranspose2d, fuse.FoldedBatchNorm2d,
              fuse.FoldedVGGBlock)
    for m in (*state.model.modules(), *state.ema.modules()):
        assert not isinstance(m, folded), type(m)
        assert not hasattr(m, "folded_weight")
        assert not m._load_state_dict_pre_hooks
    bn = state.ema.backbone.stem.stem1.bn
    bn.running_mean.fill_(1.0)
    x = torch.zeros(1, bn.num_features, 2, 2)
    assert not torch.equal(bn(x), x)


@pytest.mark.parametrize("case", list(CASES))
def test_declared_pairs_cover_every_batchnorm(case):
    """The (conv, BatchNorm) pairs the blocks declare (``bn_pairs``) name a
    conv of the block and a BatchNorm of the block of its width, and cover
    every BatchNorm of the model once."""
    from dfine_tpu_torch.models.dfine import build_model
    from dfine_tpu_torch.models.layers import BatchNorm2d

    size, mask = CASES[case]
    model = build_model(size, NUM_CLASSES, mask, device="cpu")
    declared = []
    for m in model.modules():
        for conv, bn in (m.bn_pairs() if hasattr(m, "bn_pairs") else ()):
            c, b = m.get_submodule(conv), m.get_submodule(bn)
            assert isinstance(c, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)), (conv, type(c))
            assert isinstance(b, BatchNorm2d), (bn, type(b))
            assert b.num_features == c.out_channels, (conv, bn)
            declared.append(id(b))
    every = [id(m) for m in model.modules() if isinstance(m, BatchNorm2d)]
    assert sorted(declared) == sorted(every)
