"""The train step (port of ``dfine_tpu/train/train_step.py``).

``make_train_step`` returns ``step(state, batch, generator=None,
dn_noise=None) -> (state, metrics)``: forward in train mode with the CDN
queries, the criterion (matching on the device), backward, clip + AdamW, and
the EMA update. Unlike the JAX step it updates in place: the model's
parameters and BatchNorm statistics, the optimizer's moments and the EMA
copy live in ``TrainState`` and change under it.

Mixed precision is what flax's ``dtype=bf16`` does: fp32 parameters, bf16
compute under ``torch.autocast``, the norms and softmaxes in fp32 (the
model's norm modules and the criterion cast up), and the backward and the
optimizer outside autocast. The JAX step's options: ``update_mask``
(``optim.freeze_mask``; a frozen parameter takes ``requires_grad_(False)``,
so it has no gradient, is outside the clip's norm and ``grad_norm``, and
takes no update and no weight decay, while its BatchNorm still updates its
statistics), ``ema_base``, and gradient accumulation, which the step reads
from its optimizer (``OptimConfig.b_accum_steps``: it steps on the mean of
k micro-steps, and the EMA follows only the optimizer steps). With the flat
optimizer (``build_optimizer(flat=True)``) the EMA is ``ema_update_flat``,
one ``lerp_`` over the flat buffers.

Data parallelism (``axis_name="dp"``, JAX's step under ``shard_map``): each
rank runs the step on its rows of the global batch in a process group
(``parallel/dp.py``). The criterion's box normalizers are means over the
ranks; the gradients are averaged over the ranks before the accumulation,
the clip and the update (a parameter without a gradient on one rank enters
as zeros, one without a gradient on any rank keeps none; the flat
optimizer's gradient buffer is averaged in place by one all-reduce, the
gradients autograd did not touch zeros, as JAX's ``pmean`` of the gradient
tree gives); the BatchNorm running statistics are averaged after the
forward, so the EMA follows the averaged ones (``num_batches_tracked`` is
not averaged); the metrics are averaged. The CDN noise is each rank's own
(``parallel.rank_generator``).

On the card the single-process step runs as a CUDA graph (``StepGraph``):
one graph holds a whole step, forward to EMA, and each later call copies
the batch and the CDN noise into the graph's static inputs, writes the
learning rates and the EMA momentum into their device tensors, and replays
it, so the host launches one graph instead of some 8k kernels. The step
takes the graph where it can observe that a graph replays the same step:
the batch on a CUDA device, no ``axis_name`` and no SyncBN axis, and the
plain ``Optimizer`` without accumulation. A graph is captured per batch
signature (shapes, dtypes, strides and target keys, the CDN noise's, and the
deformable backward's scatter), at most ``MAX_GRAPHS`` of them (the
loader's multiscale sizes), for one state: a new ``TrainState`` (or model, optimizer, EMA) or the optimizer's
``load_state_dict`` drops them. Its first call warms up on a side stream,
puts every tensor of the state back as it was, then captures; the warm-up
leaves no trace. Every other case runs the eager body, which ``step.eager``
also runs. With a generator the CDN noise is drawn before the graph, from
the generator and with the arguments the model's forward would use.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch
import torch.nn as nn

from ..data.loader import MULTISCALE_OFFSETS
from ..models.denoising import CdnNoise
from ..models.layers import bn_axis
from ..ops.deform_attn import deform_bwd_impl
from ..ops.kernels import launch_counts
from ..parallel.dp import all_reduce_flat_, all_reduce_grads_, all_reduce_mean_
from ..utils.profiling import count, span
from .criterion import CriterionConfig, criterion_forward
from .flat_optim import FlatOptimizer, ema_update_flat
from .optim import EMA_BASE, Optimizer, ema_update, write_ema_momentum

GRAPH_WARMUP = 2  # eager steps on a side stream before a capture
# batch signatures a step keeps captured, a further one running eagerly: a
# trainer's batches come in the loader's multiscale sizes (drop_last keeps
# every batch full, and the base size is one of them)
MAX_GRAPHS = len(MULTISCALE_OFFSETS)

METRIC_TERMS = ("loss_vfl", "loss_bbox", "loss_giou", "loss_fgl", "loss_ddf",
                "loss_mask_bce", "loss_mask_dice")


@dataclass
class TrainState:
    step: int
    model: nn.Module
    optimizer: Union[Optimizer, FlatOptimizer]
    ema: nn.Module  # a copy of the model: EMA of parameters and buffers

    @classmethod
    def create(cls, model: nn.Module, optimizer: Union[Optimizer, FlatOptimizer]):
        ema = copy.deepcopy(model).eval().requires_grad_(False)
        return cls(step=0, model=model.train(), optimizer=optimizer, ema=ema)


def make_train_step(crit_cfg: CriterionConfig, compute_dtype: torch.dtype = torch.bfloat16,
                    axis_name: Optional[str] = None, ema_base: float = EMA_BASE,
                    update_mask: Optional[Dict[str, bool]] = None):
    """The step function. ``compute_dtype`` bf16 runs the forward under
    autocast; float32 runs it in full precision. ``update_mask``: {parameter
    name: trainable}, as ``optim.freeze_mask`` gives it. The number of
    micro-steps an optimizer step takes is the optimizer's own. ``axis_name``
    ("dp"): the data-parallel step of one rank (see the module doc). The
    function's ``eager`` runs the step without a graph and ``graphs`` holds
    its captured ones (see the module doc)."""
    frozen = [name for name, keep in (update_mask or {}).items() if not keep]
    graphs: Dict[Tuple, StepGraph] = {}
    owner: Optional[Tuple] = None  # the state whose tensors the graphs hold
    pool = None  # the graphs' memory pool

    def step(state: TrainState, batch: Dict[str, Any],
             generator: Optional[torch.Generator] = None,
             dn_noise: Optional[CdnNoise] = None):
        """``batch``: images [B, 3, H, W] and targets {labels [B, G], boxes
        [B, G, 4] cxcywh, valid [B, G] and, for the ``masks`` loss, masks
        [B, G, Hm, Wm] and mask_valid [B, G]} on the model's device. The CDN
        noise is ``dn_noise`` or drawn from ``generator``."""
        nonlocal pool
        if not graphable(state, batch, dn_noise):
            return eager(state, batch, generator, dn_noise)
        with span("train.step", root=state.step):
            with span("train.inputs"):
                noise = dn_noise
                if noise is None:
                    noise = state.model.decoder.draw_noise(batch["targets"]["labels"], generator)
                key = (_signature(batch["images"]),
                       tuple((k, _signature(v)) for k, v in sorted(batch["targets"].items())),
                       None if noise is None else tuple(_signature(t) for t in noise),
                       deform_bwd_impl())
                g = graphs_of(state).get(key)
                if g is not None:
                    g.feed(state, batch, noise)
            if g is None and len(graphs) >= MAX_GRAPHS:
                count("train.eager_steps")
                return _step(state, batch, None, noise, rates(state.optimizer))
            if g is None:  # fed this call's inputs as it captures
                pool = pool or torch.cuda.graph_pool_handle()
                g = graphs[key] = StepGraph(_step, state, batch, noise, pool, ema_base)
                count("train.graph_captures")
            with span("train.replay"):
                metrics = g.replay()
            count("train.graph_replays")
            state.step += 1
            state.optimizer.count += 1
            return state, metrics

    def eager(state: TrainState, batch: Dict[str, Any],
              generator: Optional[torch.Generator] = None,
              dn_noise: Optional[CdnNoise] = None):
        """The step without a graph (same arguments and results)."""
        count("train.eager_steps")
        with span("train.step", root=state.step):
            return _step(state, batch, generator, dn_noise, rates(state.optimizer))

    def rates(opt) -> Optional[torch.Tensor]:
        """Write the learning rates of ``opt``'s coming update and return
        the EMA momentum tensor written for it, as ``StepGraph.feed`` does
        before a replay (None for the flat optimizer, which reads its
        schedule itself)."""
        if not isinstance(opt, Optimizer):
            return None
        momentum = torch.empty(2, dtype=torch.float32, device=opt.device)
        write_rates(opt, momentum, ema_base)
        return momentum

    def graphable(state, batch, dn_noise) -> bool:
        """Whether a CUDA graph replays this call's step: the batch (and the
        noise) on one CUDA device, no collectives, and the plain optimizer
        stepping on every call."""
        images, targets = batch["images"], batch["targets"]
        opt = state.optimizer
        if (axis_name is not None or bn_axis(True) is not None or type(opt) is not Optimizer
                or opt.accum_steps != 1 or images.device.type != "cuda"):
            return False
        return all(isinstance(t, torch.Tensor) and t.device == images.device
                   for t in (*targets.values(), *(dn_noise or ())))

    def graphs_of(state) -> Dict[Tuple, "StepGraph"]:
        """The captured graphs, dropped first where they hold another
        state's tensors, or where the optimizer has loaded new ones."""
        nonlocal owner
        now = (state, state.model, state.optimizer, state.ema)
        if (owner is None or any(a is not b for a, b in zip(owner[0], now))
                or owner[1] != state.optimizer.version):
            graphs.clear()
            owner = (now, state.optimizer.version)
        return graphs

    def _step(state, batch, generator, dn_noise, momentum):
        """The step's body. It reads the learning rates and the EMA momentum
        [m, 1 - m] (``momentum``) from the device tensors ``write_rates``
        wrote before it (the flat optimizer reads its schedule itself)."""
        model, opt = state.model, state.optimizer
        flat = isinstance(opt, FlatOptimizer)
        for name in frozen:
            model.get_parameter(name).requires_grad_(False)
        model.train()
        opt.zero_grad()
        dev = batch["images"].device
        with span("train.forward"), torch.autocast(dev.type, dtype=compute_dtype,
                                                   enabled=compute_dtype != torch.float32):
            out = model(batch["images"], batch["targets"], dn_noise, generator)
        with span("train.criterion"):
            losses = criterion_forward(out, batch["targets"], crit_cfg, axis_name=axis_name)
        with span("train.backward"):
            losses["total"].backward()
            if axis_name is not None:
                if flat:
                    all_reduce_flat_(opt.grad_flat)
                else:
                    all_reduce_grads_(opt.params)
                all_reduce_mean_(bn_statistics(model))
        with span("train.optim"):
            grad_norm = opt.step()
        state.step += 1
        if opt.mini_step == 0:  # an optimizer step: its count drives the warm-up
            with span("train.ema"):
                if flat:
                    ema_update_flat(state.ema, model, opt.count, ema_base)
                else:
                    ema_update(state.ema, model, momentum)
        metrics = {"loss": losses["total"].detach(), "grad_norm": grad_norm.detach()}
        metrics.update({k: v.detach() for k, v in losses.items()
                        if "_" not in k or k in METRIC_TERMS})
        if axis_name is not None:
            names = sorted(metrics)
            stacked = torch.stack([metrics[k].float() for k in names])
            all_reduce_mean_([stacked])
            metrics = dict(zip(names, stacked.unbind()))
        return state, metrics

    step.axis_name = axis_name
    step.eager = eager
    step.graphs = graphs
    return step


def write_rates(opt: Optimizer, momentum: torch.Tensor, ema_base: float) -> None:
    """Write the learning rates of ``opt``'s coming update (at its count) and
    the EMA momentum [m, 1 - m] after it (at the count the update leaves)."""
    opt.write_lr()
    write_ema_momentum(momentum, opt.count + 1, ema_base)


def _signature(t: torch.Tensor) -> Tuple:
    return tuple(t.shape), t.dtype, t.stride(), t.device


class StepGraph:
    """One train step captured as a CUDA graph for one batch signature and
    one state. ``body(state, batch, generator, noise, momentum)`` is the
    step's body, ``ema_base`` its EMA's base. The static inputs (the batch,
    the CDN noise, the EMA momentum [m, 1 - m]) and outputs (the parameters'
    gradients, the metrics stacked in one tensor) keep their addresses;
    every temporary lives in ``pool``, shared with the step's other graphs
    (they never run at once). ``launches``: the kernel wrappers' launches
    the graph holds (a replay launches none from Python)."""

    def __init__(self, body: Callable, state: TrainState, batch: Dict[str, Any],
                 noise: Optional[CdnNoise], pool, ema_base: float):
        dev = batch["images"].device
        opt = state.optimizer
        self.ema_base = ema_base
        self.batch = {"images": torch.empty_like(batch["images"]),
                      "targets": {k: torch.empty_like(v) for k, v in batch["targets"].items()}}
        self.noise = None if noise is None else CdnNoise(*(torch.empty_like(t) for t in noise))
        self.momentum = torch.empty(2, dtype=torch.float32, device=dev)
        self.feed(state, batch, noise)
        counters = state.step, opt.count
        tensors = [t for m in (state.model, state.ema) for t in (*m.parameters(), *m.buffers())]
        with torch.no_grad():
            saved = [t.clone() for t in tensors]
            moments = {p: {k: v.clone() for k, v in s.items()}
                       for p, s in opt.adamw.state.items()}
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):  # kernels built, caches filled, AdamW's state made
            for _ in range(GRAPH_WARMUP):
                body(state, self.batch, None, self.noise, self.momentum)
        torch.cuda.current_stream(dev).wait_stream(side)
        with torch.no_grad():  # the warm-up leaves no trace
            for t, c in zip(tensors, saved):
                t.copy_(c)
            for p, s in opt.adamw.state.items():
                for k, v in s.items():  # a moment the warm-up made starts at 0
                    if p in moments:
                        v.copy_(moments[p][k])
                    else:
                        v.zero_()
        del saved, moments
        state.step, opt.count = counters
        opt.zero_grad()  # the backward makes the gradients in the graph's pool
        before = launch_counts()
        self.graph = torch.cuda.CUDAGraph()
        # thread_local: the loader's threads may pin host memory meanwhile
        with torch.cuda.graph(self.graph, pool=pool, capture_error_mode="thread_local"):
            _, metrics = body(state, self.batch, None, self.noise, self.momentum)
            self.names = sorted(metrics)
            self.metrics = torch.stack([metrics[k].float() for k in self.names])
        self.launches = {k: v - before[k] for k, v in launch_counts().items()}
        state.step, opt.count = counters  # the capture ran nothing: the first replay is the step
        self.grads = [(p, p.grad) for p in opt.params if p.grad is not None]
        self.replays = 0

    def feed(self, state: TrainState, batch: Dict[str, Any], noise: Optional[CdnNoise]) -> None:
        """Copy this call's batch and CDN noise into the static inputs, and
        write the learning rates and the EMA momentum of the coming update
        (at the optimizer's count; the EMA reads the count after it)."""
        self.batch["images"].copy_(batch["images"])
        for k, v in batch["targets"].items():
            self.batch["targets"][k].copy_(v)
        for s, t in zip(self.noise or (), noise or ()):
            s.copy_(t)
        write_rates(state.optimizer, self.momentum, self.ema_base)

    def replay(self) -> Dict[str, torch.Tensor]:
        """Run the step; returns copies of its metrics (the next replay
        overwrites the static ones)."""
        self.graph.replay()
        self.replays += 1
        if self.grads and self.grads[0][0].grad is not self.grads[0][1]:
            for p, g in self.grads:  # an eager step in between made its own
                p.grad = g
        return dict(zip(self.names, self.metrics.clone().unbind()))


def bn_statistics(model: nn.Module):
    """The running means and variances of every BatchNorm of ``model``."""
    return [t for m in model.modules() if isinstance(m, nn.modules.batchnorm._BatchNorm)
            for t in (m.running_mean, m.running_var)]


def make_eval_step():
    """Inference with the EMA model, as the JAX package evaluates."""
    @torch.no_grad()
    def step(state: TrainState, images: torch.Tensor):
        return state.ema.eval()(images)

    return step
