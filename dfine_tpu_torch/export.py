"""Export (port of ``dfine_tpu/export.py``). Formats:

- ``exported``: a ``torch.export`` program of the model and ``topk_decode``
  (the weights in it), saved with ``torch.export.save`` as ``.pt2`` and
  served by ``ExportedModel``; ``dynamic_batch`` gives it a symbolic batch
  dimension. The deformable-attention core is the custom op
  ``dfine_tpu_torch::ms_deform_attn_fwd``: import ``dfine_tpu_torch`` before
  ``torch.export.load`` so that it is registered.
- ``npz``: the weights as JAX variables (``save_params_npz``'s layout),
  in fp32 and unfolded, as ``TorchModel`` takes them.
- ``aot``: a manifest of the fixed-shape program ``AOTModel`` makes at load
  (on the card, its captured CUDA graph: input shape, the bytes its memory
  pool took and the sampling-kernel launches it holds).

Each is of the model that ``TorchModel`` serves (``infer/torch_model.py::
serving_model``: the BatchNorms folded into the convs, ``infer/fuse.py``).
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn as nn

from .device import resolve_device
from .infer.aot_model import GraphProgram, pool_bytes
from .infer.torch_model import decode, serving_model
from .models.dfine import DFINE
from .utils.checkpoint import port_variables


class ServingProgram(nn.Module):
    """images [B, 3, H, W] in [0, 1] -> ``decode``'s dict, every top-k
    query's mask kept."""

    def __init__(self, model: DFINE, num_top: int = 300):
        super().__init__()
        self.model, self.num_top = model, num_top

    def forward(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        return decode(self.model, images, self.num_top, top_masks=None)


def make_exported(model: DFINE, input_size: Tuple[int, int], num_top: int = 300,
                  batch: int = 1, dynamic_batch: bool = False):
    """``torch.export`` of the serving program at ``input_size`` on the
    model's device. One eager call at that shape comes first: it fills the
    model's per-shape constants (anchors, positional embedding), which the
    program then holds as constants. ``dynamic_batch`` exports a symbolic
    batch (from an example of 2: export specializes a dimension of 1)."""
    dev = next(model.parameters()).device
    program = ServingProgram(model, num_top).eval()
    x = torch.zeros((2 if dynamic_batch else batch, 3, *input_size), device=dev)
    dynamic = {"images": {0: torch.export.Dim("batch", min=1, max=64)}} if dynamic_batch else None
    with torch.no_grad():
        program(x)
        return torch.export.export(program, (x,), dynamic_shapes=dynamic)


def export_model(model_name: str, model_path: Optional[str], num_classes: int,
                 out_dir: Union[str, Path], input_size: Tuple[int, int] = (640, 640),
                 half: bool = True, max_batch_size: int = 1, enable_mask_head: bool = False,
                 formats=("aot", "exported", "npz"), dynamic_batch: bool = False,
                 device: Optional[Union[str, torch.device]] = None,
                 cfg_overrides: Sequence[Tuple[str, Any]] = ()) -> Dict[str, Path]:
    """Write the artifacts of ``formats`` under ``out_dir``; weights from
    ``model_path`` (None, .npz or .pth, as ``TorchModel`` takes them), of
    the model ``build_model`` makes with ``cfg_overrides``."""
    dev = resolve_device(device)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    artifacts: Dict[str, Path] = {}

    def write_npz(model: DFINE) -> DFINE:
        """The npz of the loaded fp32 weights (the fold keeps the state dict)."""
        if "npz" in formats:
            artifacts["npz"] = out_dir / f"dfine_{model_name}.npz"
            np.savez(artifacts["npz"], **port_variables(model))
        return model

    model = serving_model(model_name, num_classes, enable_mask_head, model_path,
                          torch.bfloat16 if half else torch.float32, dev, cfg_overrides,
                          write_npz)
    if "exported" in formats:
        p = out_dir / f"dfine_{model_name}.pt2"
        torch.export.save(make_exported(model, input_size, batch=max_batch_size,
                                        dynamic_batch=dynamic_batch), p)
        artifacts["exported"] = p
    if "aot" in formats:
        shape = (max_batch_size, 3, *input_size)
        lines = [f"input: {shape} float32", f"device: {dev}"]
        if dev.type == "cuda":
            pool = torch.cuda.graph_pool_handle()
            prog = GraphProgram(lambda x: decode(model, x, 300), shape, dev, pool)
            lines += [f"cuda_graph_pool_bytes: {pool_bytes(pool)}",
                      f"deform_launches: {prog.deform_launches}"]
        else:
            lines.append("cuda_graph: none (the CPU runs the fixed-shape program eagerly)")
        p = out_dir / f"dfine_{model_name}.aot.txt"
        p.write_text("\n".join(lines) + "\n")
        artifacts["aot"] = p
    return artifacts
