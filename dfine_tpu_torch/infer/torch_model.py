"""Eager PyTorch serving backend (port of ``dfine_tpu/infer/jax_model.py``):
model forward plus the NMS-free top-k decode on the card."""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from ..models.dfine import build_model, set_compute_dtype
from ..postprocess import topk_decode
from ..utils.checkpoint import load_jax_variables, unflatten
from .base import BaseServing

TOP_MASKS = 100  # masks kept for the strongest queries, in bf16 (jax_model.py:28-29)


class TorchModel(BaseServing):
    """``model_path``: None (``build_model``'s random weights) or an ``.npz``
    of JAX variables as ``dfine_tpu.utils.checkpoint.save_params_npz`` writes
    them, loaded through the weight bridge."""

    def _build(self, model_path: Optional[str]) -> None:
        dtype = torch.bfloat16 if self.half else torch.float32
        model = build_model(self.model_name, self.n_outputs, self.enable_mask_head,
                            dtype=torch.float32, device="cpu")
        if model_path is not None:
            p = Path(model_path)
            if p.suffix != ".npz":
                raise ValueError(f"unsupported weights file {p} (expected .npz)")
            with np.load(p) as z:
                load_jax_variables(model, unflatten({k: z[k] for k in z.files}))
        self.model = set_compute_dtype(model, dtype).to(self.device).eval()

    def _predict(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        out = self.model(images)
        dec = topk_decode(out["pred_logits"], out["pred_boxes"], self.num_top_queries,
                          masks=out.get("pred_masks"))
        if "masks" in dec:
            dec["masks"] = dec["masks"][:, :TOP_MASKS].to(torch.bfloat16)
        return dec
