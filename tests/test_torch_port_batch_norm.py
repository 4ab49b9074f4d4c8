"""Train-mode BatchNorm2d (``dfine_tpu_torch/ops/kernels/batch_norm.py``) on
the CPU: the plain version is the chain the kernels replaced, bit for bit
(forward, running statistics, gradients); the kernels' closed-form backward
written in PyTorch equals autograd; ``BatchNorm2d`` takes the plain version
on the CPU, ``_sync_forward`` under SyncBN and the eval path in eval mode,
and each block hands it the activation that follows; every BatchNorm of a
train forward gets an NCHW-contiguous input, the one layout the kernels'
wrapper takes, and the wrapper refuses the others; the reductions' grid
covers the train step's shapes. The kernels themselves run in
``test_torch_port_cuda.py``."""

import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

from dfine_tpu_torch.models import layers
from dfine_tpu_torch.models.dfine import build_model
from dfine_tpu_torch.ops.kernels import batch_norm as bn
from dfine_tpu_torch.utils import profiling

ACTS = (None, "relu", "silu")
_ACT_FN = {None: lambda y: y, "relu": F.relu, "silu": F.silu}
# the shapes of the train step's BatchNorms at 640 px, batch 8: the stem,
# stride 8 and the 20 x 20 tokens of x's widest maps; and an odd map
STEP_SHAPES = ((8, 32, 320, 320), (8, 256, 80, 80), (8, 1024, 20, 20), (8, 2048, 20, 20),
               (2, 16, 7, 9))


def _chain(mod, x, act):
    """The train-mode forward the kernels replaced, as ``BatchNorm2d`` and
    the block after it ran it: f32 cuDNN-style BatchNorm, var_mean for the
    running statistics, the cast back, then the activation."""
    x32 = x.float()
    y = F.batch_norm(x32, None, None, mod.weight, mod.bias, True, 0.0, mod.eps)
    with torch.no_grad():
        var, mean = torch.var_mean(x32, dim=(0, 2, 3), correction=0)
        mod.running_mean.mul_(1.0 - mod.momentum).add_(mean, alpha=mod.momentum)
        mod.running_var.mul_(1.0 - mod.momentum).add_(var, alpha=mod.momentum)
        mod.num_batches_tracked.add_(1)
    return _ACT_FN[act](y.to(x.dtype))


def _inputs(shape, dtype, channels_last, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(shape, generator=g) * 2 + 0.5).to(dtype)
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    dy = torch.randn(shape, generator=g).to(dtype)
    return x, dy


def _module(c, seed=1):
    g = torch.Generator().manual_seed(seed)
    mod = layers.BatchNorm2d(c).train()
    with torch.no_grad():
        mod.weight.copy_(torch.randn(c, generator=g) * 0.5 + 1)
        mod.bias.copy_(torch.randn(c, generator=g) * 0.3)
        mod.running_mean.copy_(torch.randn(c, generator=g))
        mod.running_var.copy_(torch.rand(c, generator=g) + 0.5)
    return mod


@pytest.mark.parametrize("channels_last", [False, True], ids=["nchw", "channels_last"])
@pytest.mark.parametrize("act", ACTS, ids=str)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
def test_plain_version_is_the_replaced_chain(dtype, act, channels_last):
    """On the CPU ``BatchNorm2d(x, act)`` in train mode is the replaced
    chain bit for bit: the output, the running statistics (biased
    variance), ``num_batches_tracked`` and every gradient."""
    x, dy = _inputs((3, 6, 5, 7), dtype, channels_last)
    runs = []
    for use_module in (True, False):
        mod = _module(6)
        xi = x.clone().requires_grad_(True)
        y = mod(xi, act) if use_module else _chain(mod, xi, act)
        y.backward(dy)
        runs.append([y, xi.grad, mod.weight.grad, mod.bias.grad, mod.running_mean,
                     mod.running_var, mod.num_batches_tracked])
    assert runs[0][0].dtype == dtype and runs[0][0].stride() == runs[1][0].stride()
    for ours, theirs in zip(*runs):
        assert torch.equal(ours, theirs)


@pytest.mark.parametrize("shape", [(2, 3, 4, 5), (1, 2, 7, 9)], ids=str)
@pytest.mark.parametrize("act", ACTS, ids=str)
def test_closed_form_backward_matches_autograd_in_f64(act, shape):
    """``batch_norm_train_grads``, the kernels' backward written out, at
    f64 against autograd of act(batch_norm(x)) at f64."""
    g = torch.Generator().manual_seed(2)
    x = torch.randn(shape, generator=g, dtype=torch.float64) * 3 + 1
    dy = torch.randn(shape, generator=g, dtype=torch.float64)
    w = torch.randn(shape[1], generator=g, dtype=torch.float64).requires_grad_(True)
    b = torch.randn(shape[1], generator=g, dtype=torch.float64).requires_grad_(True)
    xi = x.clone().requires_grad_(True)
    _ACT_FN[act](F.batch_norm(xi, None, None, w, b, True, 0.0, 1e-5)).backward(dy)
    var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
    dx, gw, gb = bn.batch_norm_train_grads(x, dy, w.detach(), b.detach(), mean,
                                           1 / torch.sqrt(var + 1e-5), act)
    for ours, theirs in ((dx, xi.grad), (gw, w.grad), (gb, b.grad)):
        torch.testing.assert_close(ours, theirs, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("act", ACTS, ids=str)
def test_closed_form_backward_rounds_where_the_chain_rounds(act):
    """In bf16 the written-out backward (z and dz rounded to bf16) sits
    within a bf16 rounding of the plain chain's autograd; the parameters'
    gradients (f32 sums) within f32 rounding."""
    x, dy = _inputs((4, 5, 6, 6), torch.bfloat16, False, seed=3)
    mod = _module(5)
    xi = x.clone().requires_grad_(True)
    mod(xi, act).backward(dy)
    var, mean = torch.var_mean(x.float(), dim=(0, 2, 3), correction=0)
    dx, gw, gb = bn.batch_norm_train_grads(x, dy, mod.weight.detach(), mod.bias.detach(), mean,
                                           1 / torch.sqrt(var + mod.eps), act)
    assert dx.dtype == torch.bfloat16
    ref = xi.grad.float()
    assert ((dx.float() - ref).abs() <= 2 ** -7 * ref.abs() + 2 ** -16 * ref.abs().max()).all()
    torch.testing.assert_close(gw, mod.weight.grad, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(gb, mod.bias.grad, rtol=1e-5, atol=1e-5)


def test_cpu_takes_the_plain_version():
    """A train-mode forward on the CPU counts ``train.bn_plain`` (and no
    ``train.bn_kernel``) while tracing, and launches nothing."""
    mod = _module(4)
    x, _ = _inputs((2, 4, 3, 3), torch.float32, False)
    launches = bn.batch_norm_train.launches
    profiling.drain()
    with profiling.tracing(True):
        mod(x, "relu")
    counters = profiling.drain()["counters"]
    assert counters.get("train.bn_plain") == 1 and "train.bn_kernel" not in counters
    assert bn.batch_norm_train.launches == launches


def test_sync_bn_axis_takes_the_sync_forward(monkeypatch):
    """With a SyncBN axis set a train-mode forward takes ``_sync_forward``
    (then the activation) and never ``batch_norm_train``."""
    seen = []
    monkeypatch.setattr(layers, "batch_norm_train", lambda *a, **k: seen.append("kernel"))
    sync = layers.BatchNorm2d._sync_forward
    monkeypatch.setattr(layers.BatchNorm2d, "_sync_forward",
                        lambda self, x32: seen.append("sync") or sync(self, x32))
    mod = _module(4)
    x, _ = _inputs((2, 4, 3, 3), torch.bfloat16, False)
    layers.set_bn_axis("dp")
    try:
        y = mod(x, "silu")
    finally:
        layers.set_bn_axis(None)
    assert seen == ["sync"] and y.dtype == torch.bfloat16
    ref = _module(4)
    assert torch.equal(y, F.silu(sync(ref, x.float()).to(torch.bfloat16)))


def test_eval_takes_the_eval_path(monkeypatch):
    """An eval-mode forward normalises with the running statistics, then
    applies the activation, and never calls ``batch_norm_train``."""
    monkeypatch.setattr(layers, "batch_norm_train", lambda *a, **k: pytest.fail("kernel"))
    mod = _module(4).eval()
    x, _ = _inputs((2, 4, 3, 3), torch.bfloat16, False)
    want = F.relu(F.batch_norm(x.float(), mod.running_mean, mod.running_var, mod.weight,
                               mod.bias, False, 0.0, mod.eps).to(torch.bfloat16))
    assert torch.equal(mod(x, "relu"), want)


def test_an_activation_the_kernels_lack_follows_them(monkeypatch):
    """An activation outside ``ACTS`` (GELU) runs after ``batch_norm_train``
    with no activation of its own."""
    calls = []
    kernel = layers.batch_norm_train
    monkeypatch.setattr(layers, "batch_norm_train",
                        lambda *a: calls.append(a[-1]) or kernel(*a))
    x, _ = _inputs((2, 4, 3, 3), torch.float32, False)
    y = _module(4)(x, "gelu")
    assert calls == [None]
    assert torch.equal(y, F.gelu(_chain(_module(4), x, None), approximate="tanh"))


def test_batch_norm_train_refuses_an_unknown_activation():
    mod = _module(4)
    x, _ = _inputs((2, 4, 3, 3), torch.float32, False)
    with pytest.raises(ValueError, match="act must be one of"):
        bn.batch_norm_train(x, mod.weight, mod.bias, mod.running_mean, mod.running_var,
                            mod.num_batches_tracked, mod.momentum, mod.eps, "gelu")


def _batch_norm_inputs(model, convs=None):
    """(the activation it hands ``batch_norm_train``, whether its input is
    NCHW-contiguous) of each BatchNorm of ``model`` in one train-mode
    forward of NCHW-contiguous images, by module name; ``convs``, a dict,
    takes whether each conv's input is NCHW-contiguous."""
    names = {m: n for n, m in model.named_modules()}
    seen = {}

    def hook(mod, args):
        seen[names[mod]] = (args[1] if len(args) > 1 else None, args[0].is_contiguous())

    def conv_hook(mod, args):
        convs[names[mod]] = args[0].is_contiguous()

    handles = [m.register_forward_pre_hook(hook) for m in model.modules()
               if isinstance(m, layers.BatchNorm2d)]
    if convs is not None:
        handles += [m.register_forward_pre_hook(conv_hook) for m in model.modules()
                    if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d))]
    try:
        with torch.autocast("cpu", dtype=torch.bfloat16):
            model(torch.rand(1, 3, 160, 160))
    finally:
        for h in handles:
            h.remove()
    return seen


def test_each_block_hands_its_activation_to_the_batch_norm():
    """In the n det+seg model every BatchNorm runs once a forward and gets
    the activation its block applies after it: ReLU in the backbone's
    ``ConvBN`` with an act and in the mask head's last BatchNorm, SiLU in
    the encoder's ``ConvBNA`` with an act, none in ``ConvNorm``, the
    ``VGGBlock`` branches (summed before their act) and the mask head's
    lateral BatchNorms."""
    torch.manual_seed(0)
    model = build_model("n", 5, True, device="cpu").train()
    seen = {k: act for k, (act, _) in _batch_norm_inputs(model).items()}
    want = {}
    for name, m in model.named_modules():
        prefix = f"{name}." if name else ""
        if isinstance(m, layers.ConvBN):
            want[prefix + "bn"] = m.act
        elif isinstance(m, layers.ConvBNA):
            want[prefix + "norm"] = m.act
        elif isinstance(m, layers.ConvNorm):
            want[prefix + "norm"] = None
    decoder = model.decoder.pixel_decoder
    for i in range(len(decoder.bn)):
        want[f"decoder.pixel_decoder.bn.{i}"] = None
    want["decoder.pixel_decoder.enc_bn"] = None
    want["decoder.pixel_decoder.bn1"] = "relu"
    assert seen == want
    assert sum(isinstance(m, layers.BatchNorm2d) for m in model.modules()) == len(seen)
    assert {"relu", "silu", None} == set(seen.values())
    branches = [f"{n}.conv{i}.norm" for n, m in model.named_modules()
                if isinstance(m, layers.VGGBlock) for i in (1, 2)]
    assert branches and all(seen[b] is None for b in branches)


@pytest.mark.parametrize("size,mask_head", [("n", True), ("l", False)], ids=str)
def test_every_batch_norm_of_a_train_forward_gets_an_nchw_contiguous_input(size, mask_head):
    """From NCHW-contiguous images (what the loader's ``to_device`` and the
    benchmark's batches give) every conv's and every BatchNorm's input is
    NCHW-contiguous, so on the card each BatchNorm takes the kernels, whose
    wrapper refuses other layouts: n det+seg (the mask head's BatchNorms)
    and l detect. The convs are held too: on the card a conv gives a
    channels-last input's layout to its output (the CPU's does not)."""
    torch.manual_seed(0)
    model = build_model(size, 5, mask_head, device="cpu").train()
    convs = {}
    seen = _batch_norm_inputs(model, convs)
    assert len(seen) == sum(isinstance(m, layers.BatchNorm2d) for m in model.modules())
    assert [k for k, (_, nchw) in seen.items() if not nchw] == []
    assert convs and [k for k, nchw in convs.items() if not nchw] == []


@pytest.mark.parametrize("case", ["fp16", "channels_last", "transposed", "strided", "empty",
                                  "weight_size", "weight_dtype", "counter_dtype"])
def test_the_wrapper_refuses_what_the_kernels_do_not_take(case):
    """``_check``, run before any launch on the card: activations other than
    bf16 and f32, a layout other than NCHW-contiguous (channels-last,
    transposed or strided), an empty tensor, and parameters or a counter
    of the wrong size or dtype raise."""
    mod = _module(16)
    x, _ = _inputs((2, 16, 8, 8), torch.bfloat16, False)
    args = [x, mod.weight, mod.bias, mod.running_mean, mod.running_var, mod.num_batches_tracked]
    bn._check(*args)
    error, match = ValueError, "NCHW-contiguous"
    if case == "fp16":
        args[0], error, match = x.half(), TypeError, "bf16 or f32"
    elif case == "channels_last":
        args[0] = x.contiguous(memory_format=torch.channels_last)
    elif case == "transposed":
        args[0] = x.transpose(2, 3)
    elif case == "strided":
        args[0] = x[:, :, :, ::2]
    elif case == "empty":
        args[0], match = x[:0], "non-empty"
    elif case == "weight_size":
        args[1], match = mod.weight[:8], "weight"
    elif case == "weight_dtype":
        args[1], match = mod.weight.double(), "weight"
    else:
        args[5], match = mod.num_batches_tracked.int(), "num_batches_tracked"
    with pytest.raises(error, match=match):
        bn._check(*args)


@pytest.mark.parametrize("shape", STEP_SHAPES, ids=str)
def test_the_reductions_grid_covers_each_shape(shape):
    """``slices`` at 132 SMs: the slices cover each channel's vectors, a
    thread of a channel's last block merges at most ``FINISH`` partials,
    and the grid has at least the card's SMs in blocks where the vectors
    allow two passes of a block over each slice."""
    n, c, h, w = shape
    assert c < bn.TICKETS
    for vec in (1, 8) if h * w % 8 == 0 else (1,):
        parts = bn.slices(n, c, h * w, vec, 132)
        vectors = n * h * w // vec
        assert 1 <= parts < 65536
        assert -(-parts // bn.THREADS) <= bn.FINISH
        if vectors >= 2 * bn.THREADS * 132:
            assert c * parts >= 132
        assert parts == 1 or -(-vectors // parts) >= bn.THREADS
