"""Fixed-shape serving backend (port of ``dfine_tpu/infer/aot_model.py``):
one program per (max_batch_size, h, w) bucket, made at load, with the batch
padded by repeating its last image.

On the card each bucket's program is a CUDA graph of the serving program
(model, top-k decode, the top-100 masks in bf16) between a static input and
static outputs; replaying it costs one launch instead of the eager model's
~1350 device activities a frame. All buckets' graphs share one memory pool
(a bucket's temporaries are dead between replays, which never overlap), so
seven rect buckets do not hold seven copies of the activations. Each bucket
is warmed up on a side stream before its capture: the kernels build at
first use through nvcc and the model fills its per-shape constants then,
neither of which may happen inside a capture. The frame's H2D and its
resize into the bucket stay outside the graph, because frames differ in
size. On the CPU, which only tests use, the same fixed-shape program runs
eagerly.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from ..ops.kernels import ms_deform_attn_fwd
from ..utils.profiling import span
from .torch_model import TorchModel, decode


def pool_bytes(pool) -> int:
    """The bytes the caching allocator holds in the graph memory pool
    ``pool`` (its segments in ``torch.cuda.memory_snapshot``)."""
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg["segment_pool_id"]) == tuple(pool))


class GraphProgram:
    """The serving program at one input shape, captured as a CUDA graph
    into ``pool``; ``deform_launches`` is the number of sampling-kernel
    launches the graph holds."""

    def __init__(self, fn: Callable[[torch.Tensor], Dict[str, torch.Tensor]],
                 shape: Tuple[int, ...], device: torch.device, pool):
        # channels-last, as preprocessing lays the frame out: the graph runs
        # the kernels the eager model runs on the same input
        self.static_in = torch.zeros(shape, device=device).contiguous(
            memory_format=torch.channels_last)
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side), torch.inference_mode():
            for _ in range(2):
                fn(self.static_in)
        torch.cuda.current_stream(device).wait_stream(side)
        torch.cuda.synchronize(device)
        before = ms_deform_attn_fwd.launches
        self.graph = torch.cuda.CUDAGraph()
        with torch.inference_mode(), torch.cuda.graph(self.graph, pool=pool):
            self.static_out = fn(self.static_in)
        self.deform_launches = ms_deform_attn_fwd.launches - before

    def __call__(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        self.static_in.copy_(images)
        with span("serve.launch"):
            self.graph.replay()
        return {k: v.clone() for k, v in self.static_out.items()}


class AOTModel(TorchModel):
    def __init__(self, *args, max_batch_size: int = 1, **kwargs):
        self.max_batch_size = max_batch_size
        super().__init__(*args, **kwargs)

    def _build(self, model_path: Optional[str]) -> None:
        super()._build(model_path)
        self._programs: Dict[Tuple[int, ...], Callable] = {}
        self.pool = torch.cuda.graph_pool_handle() if self.device.type == "cuda" else None
        self._program((self.max_batch_size, 3, *self.input_size))

    def _program(self, shape: Tuple[int, ...]) -> Callable:
        if shape not in self._programs:
            # the card: a captured graph; the CPU: the same program, eager
            fn = lambda x: decode(self.model, x, self.num_top_queries)  # noqa: E731
            self._programs[shape] = (GraphProgram(fn, shape, self.device, self.pool)
                                     if self.device.type == "cuda" else fn)
        return self._programs[shape]

    def warmup(self, hw_buckets) -> None:
        """Make the program of each (h, w) bucket at ``max_batch_size``."""
        for h, w in hw_buckets:
            self._program((self.max_batch_size, 3, h, w))

    def _predict(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        b = images.shape[0]
        if b > self.max_batch_size:
            raise ValueError(f"batch {b} > max_batch_size {self.max_batch_size}")
        if b < self.max_batch_size:  # fixed program shape: repeat the last image
            pad = images[-1:].expand(self.max_batch_size - b, -1, -1, -1)
            images = torch.cat([images, pad], 0)
        out = self._program(tuple(images.shape))(images)
        return {k: v[:b] for k, v in out.items()}
