"""Train-mode BatchNorm2d and the activation after it
(``csrc/batch_norm_train.cu``), beside its plain PyTorch version.

``batch_norm_train`` is what ``models/layers.py::BatchNorm2d`` runs in
train mode without SyncBN: on the card an autograd function of four
launches a BatchNorm and step (the statistics, then the normalisation with
the activation; the backward's two sums, then dx), reading and writing bf16
once a pass with the arithmetic in f32, and the running statistics updated
by the statistics' launch; on the CPU the plain version, the chain the
kernels replace: a cast to f32, ``F.batch_norm``, ``var_mean`` for the
running statistics (flax's update: the biased variance), a cast back, then
the activation. The kernels round where that chain rounds (z, y and dz in
the activations' dtype), so their outputs sit within a rounding of it.
The JAX package has no Pallas kernel here: flax's BatchNorm is left to XLA.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from ...utils.profiling import count
from . import _build

ACTS = {None: 0, "relu": 1, "silu": 2}  # the activations the kernel applies (csrc: kIdentity..)
THREADS = 256  # a block's threads (csrc: kThreads)
BLOCKS_PER_SM = 8  # blocks of THREADS resident on an SM: the reductions' target grid
TICKETS = 65536  # the channels a launch may have (one ticket a channel)
FINISH = 16  # partials a thread of a channel's last block merges, at most

_PLAIN_ACTS = {None: lambda y: y, "relu": F.relu, "silu": F.silu}
_tickets = {}  # device index -> int32 [TICKETS], zero between launches, kept for the process
_sms = {}  # device index -> its SM count


def update_running_stats(running_mean: torch.Tensor, running_var: torch.Tensor,
                         num_batches_tracked: torch.Tensor, mean: torch.Tensor,
                         var: torch.Tensor, momentum: float) -> None:
    """flax's update of the running statistics (torch's ``momentum``: the
    batch's share), in place."""
    running_mean.mul_(1.0 - momentum).add_(mean, alpha=momentum)
    running_var.mul_(1.0 - momentum).add_(var, alpha=momentum)
    num_batches_tracked.add_(1)


def batch_norm_train_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                           running_mean: torch.Tensor, running_var: torch.Tensor,
                           num_batches_tracked: torch.Tensor, momentum: float, eps: float,
                           act: Optional[str] = None) -> torch.Tensor:
    """act(BatchNorm(x)) with the batch's statistics, computed in f32 and
    returned in x's dtype, and the running statistics updated with the
    biased variance."""
    x32 = x.float()
    y = F.batch_norm(x32, None, None, weight, bias, True, 0.0, eps)
    with torch.no_grad():
        var, mean = torch.var_mean(x32, dim=(0, 2, 3), correction=0)
        update_running_stats(running_mean, running_var, num_batches_tracked, mean, var, momentum)
    return _PLAIN_ACTS[act](y.to(x.dtype))


def batch_norm_train_grads(x: torch.Tensor, dy: torch.Tensor, weight: torch.Tensor,
                           bias: torch.Tensor, mean: torch.Tensor, invstd: torch.Tensor,
                           act: Optional[str] = None):
    """The kernels' closed-form backward in plain PyTorch: (dx, grad_weight,
    grad_bias) from x, dy and the forward's mean and invstd, with z and dz
    rounded to x's dtype as the kernels round them; computed in f64 for f64
    inputs, else f32."""
    f = torch.float64 if x.dtype == torch.float64 else torch.float32
    c = (1, -1, 1, 1)
    xhat = (x.to(f) - mean.to(f).view(c)) * invstd.to(f).view(c)
    z = (xhat * weight.to(f).view(c) + bias.to(f).view(c)).to(x.dtype).to(f)
    dy = dy.to(f)
    if act == "relu":
        dz = torch.where(z <= 0, torch.zeros_like(dy), dy)
    elif act == "silu":
        s = torch.sigmoid(z)
        dz = dy * s * (1 + z * (1 - s))
    else:
        dz = dy
    dz = dz.to(x.dtype).to(f)
    grad_bias, grad_weight = dz.sum((0, 2, 3)), (dz * xhat).sum((0, 2, 3))
    n = x.numel() // x.shape[1]
    dx = (weight.to(f) * invstd.to(f)).view(c) * (dz - (grad_bias / n).view(c)
                                                  - xhat * (grad_weight / n).view(c))
    return dx.to(x.dtype), grad_weight, grad_bias


def slices(n: int, c: int, hw: int, vec: int, sms: int) -> int:
    """The reductions' blocks a channel for x [n, c, hw] (``vec`` elements a
    load): enough for BLOCKS_PER_SM blocks an SM over the channels, no fewer
    than two passes of the block's threads over a slice, and at most FINISH
    partials a thread of the channel's last block."""
    vectors = n * hw // vec
    return max(1, min(-(-BLOCKS_PER_SM * sms // c), -(-vectors // (2 * THREADS)),
                      FINISH * THREADS))


def _lib():
    lib = _build.load("batch_norm_train")
    if lib.batch_norm_train_forward.argtypes is None:
        lib.batch_norm_train_forward.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 8
                                                 + [ctypes.c_float] * 3 + [ctypes.c_void_p])
        lib.batch_norm_train_forward.restype = ctypes.c_int
        lib.batch_norm_train_backward.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 8
                                                  + [ctypes.c_void_p])
        lib.batch_norm_train_backward.restype = ctypes.c_int
    return lib


def _device(dev: torch.device):
    """(tickets, SM count) of ``dev``; the tickets are made at the first call
    on a device, which must not be inside a CUDA graph capture."""
    i = torch.cuda.current_device() if dev.index is None else dev.index
    if i not in _tickets:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("batch_norm_train: the first call on a device is inside a CUDA "
                               "graph capture; call it once before capturing")
        _tickets[i] = torch.zeros(TICKETS, dtype=torch.int32, device=dev)
        _sms[i] = torch.cuda.get_device_properties(i).multi_processor_count
    return _tickets[i], _sms[i]


def _vec(x: torch.Tensor, *tensors: torch.Tensor) -> int:
    """Elements a load: 16 bytes where a row of H*W comes in whole vectors
    and every tensor is 16-byte aligned, else 1."""
    vec = 16 // x.element_size()
    hw = x.shape[2] * x.shape[3]
    return vec if hw % vec == 0 and all(t.data_ptr() % 16 == 0 for t in tensors) else 1


def _check(x, weight, bias, running_mean, running_var, num_batches_tracked):
    """Raises on what the kernels do not take."""
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"batch_norm_train takes bf16 or f32 activations, got {x.dtype}")
    if x.dim() != 4 or not x.numel():
        raise ValueError(f"batch_norm_train takes a non-empty [N, C, H, W] tensor, got "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"batch_norm_train takes NCHW-contiguous tensors, got strides "
                         f"{x.stride()} for shape {tuple(x.shape)}")
    if x.numel() >= 2 ** 31 or x.shape[1] >= TICKETS:
        raise ValueError(f"batch_norm_train takes under 2**31 elements and {TICKETS} channels, "
                         f"got {tuple(x.shape)}")
    c = x.shape[1]
    for name, t in (("weight", weight), ("bias", bias), ("running_mean", running_mean),
                    ("running_var", running_var)):
        if (t is None or t.dtype != torch.float32 or tuple(t.shape) != (c,)
                or not t.is_contiguous() or t.device != x.device):
            raise ValueError(f"batch_norm_train: {name} must be a contiguous f32 [{c}] tensor "
                             f"on {x.device}")
    if num_batches_tracked.dtype != torch.int64 or num_batches_tracked.device != x.device:
        raise ValueError(f"batch_norm_train: num_batches_tracked must be int64 on {x.device}")


class _BatchNormTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, num_batches_tracked, momentum,
                eps, act):
        dev = x.device
        n, c, h, w = x.shape
        tickets, sms = _device(dev)
        y = torch.empty_like(x)
        mean = torch.empty(c, dtype=torch.float32, device=dev)
        invstd = torch.empty(c, dtype=torch.float32, device=dev)
        vec = _vec(x, x, y)
        parts = slices(n, c, h * w, vec, sms)
        part = torch.empty(c * parts * 3, dtype=torch.float32, device=dev)
        blocks = min(-(-x.numel() // (vec * THREADS)), 4 * BLOCKS_PER_SM * sms)
        with torch.cuda.device(dev):
            rc = _lib().batch_norm_train_forward(
                x.data_ptr(), y.data_ptr(), weight.data_ptr(), bias.data_ptr(),
                running_mean.data_ptr(), running_var.data_ptr(), num_batches_tracked.data_ptr(),
                mean.data_ptr(), invstd.data_ptr(), part.data_ptr(), tickets.data_ptr(), n, c,
                h * w, int(x.dtype == torch.bfloat16), vec, ACTS[act], parts, blocks, eps,
                momentum, 1.0 - momentum, torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"batch_norm_train forward launch failed: CUDA error {rc}")
        batch_norm_train.launches += 2
        ctx.save_for_backward(x, weight, bias, mean, invstd)
        ctx.act = act
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, bias, mean, invstd = ctx.saved_tensors
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        dev = x.device
        n, c, h, w = x.shape
        dy = dy.contiguous()
        tickets, sms = _device(dev)
        dx = torch.empty_like(x) if need_x else None
        grad_weight = torch.empty(c, dtype=torch.float32, device=dev)
        grad_bias = torch.empty(c, dtype=torch.float32, device=dev)
        vec = _vec(x, *(t for t in (x, dy, dx) if t is not None))
        parts = slices(n, c, h * w, vec, sms)
        part = torch.empty(c * parts * 2, dtype=torch.float32, device=dev)
        blocks = min(-(-x.numel() // (vec * THREADS)), 4 * BLOCKS_PER_SM * sms)
        with torch.cuda.device(dev):
            rc = _lib().batch_norm_train_backward(
                x.data_ptr(), dy.data_ptr(), None if dx is None else dx.data_ptr(),
                weight.data_ptr(), bias.data_ptr(), mean.data_ptr(), invstd.data_ptr(),
                grad_weight.data_ptr(), grad_bias.data_ptr(), part.data_ptr(),
                tickets.data_ptr(), n, c, h * w, int(x.dtype == torch.bfloat16), vec,
                ACTS[ctx.act], parts, blocks, torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"batch_norm_train backward launch failed: CUDA error {rc}")
        batch_norm_train.launches += 1 + need_x
        return (dx, grad_weight if need_w else None, grad_bias if need_b else None,
                None, None, None, None, None, None)


def batch_norm_train(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                     running_mean: torch.Tensor, running_var: torch.Tensor,
                     num_batches_tracked: torch.Tensor, momentum: float, eps: float,
                     act: Optional[str] = None) -> torch.Tensor:
    """act(BatchNorm(x)) in train mode, act one of ``ACTS`` (None: none):
    x [N, C, H, W] bf16 or f32, NCHW-contiguous on the card (the train
    step's conv outputs are); weight, bias and the running statistics f32
    [C], num_batches_tracked int64, all on x's device; y has x's dtype.
    Updates the running statistics (flax's, biased variance) and
    num_batches_tracked in place. CPU tensors (and meta tensors, which
    carry shapes only) take the plain version (counted ``train.bn_plain``
    while tracing); CUDA tensors launch the kernels (``train.bn_kernel``)
    or raise. ``batch_norm_train.launches`` counts the launches: 2 a
    forward, 2 a backward (1 where x needs no gradient)."""
    if act not in ACTS:
        raise ValueError(f"batch_norm_train: act must be one of {sorted(ACTS, key=str)}, "
                         f"got {act!r}")
    if x.device.type in ("cpu", "meta"):
        count("train.bn_plain")
        return batch_norm_train_plain(x, weight, bias, running_mean, running_var,
                                      num_batches_tracked, momentum, eps, act)
    if x.device.type != "cuda":
        raise ValueError(f"batch_norm_train: unsupported device {x.device}")
    _check(x, weight, bias, running_mean, running_var, num_batches_tracked)
    count("train.bn_kernel")
    return _BatchNormTrain.apply(x, weight, bias, running_mean, running_var,
                                 num_batches_tracked, momentum, eps, act)


batch_norm_train.launches = 0
