"""Eager PyTorch serving backends (port of ``dfine_tpu/infer/jax_model.py``):
model forward plus the NMS-free top-k decode on the card. ``TorchModel``
computes in bf16 or fp32 on the BatchNorm-folded model (``infer/fuse.py``:
the serving fold, or with ``deploy=True`` the deploy rewrite);
``Int8Model`` is ``TorchModel`` on the int8-converted model."""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..models.dfine import DFINE, build_model, set_compute_dtype
from ..ops.kernels import check_kernel_limits
from ..postprocess import topk_decode
from .base import BaseServing, load_weights
from .fuse import convert_to_deploy, fold_for_serving
from .int8 import convert_int8, count_int8

TOP_MASKS = 100  # masks kept for the strongest queries, in bf16 (jax_model.py:28-29)


def decode(model: DFINE, images: torch.Tensor, num_top: int,
           top_masks: Optional[int] = TOP_MASKS) -> Dict[str, torch.Tensor]:
    """The serving program: forward, top-k decode, and the masks of the
    ``top_masks`` strongest queries in bf16. ``top_masks=None`` keeps every
    top-k query's mask in the model's dtype, as the exported program does
    (``dfine_tpu/export.py:49-52``)."""
    out = model(images)
    dec = topk_decode(out["pred_logits"], out["pred_boxes"], num_top,
                      masks=out.get("pred_masks"))
    if "masks" in dec and top_masks is not None:
        dec["masks"] = dec["masks"][:, :top_masks].to(torch.bfloat16)
    return dec


class TorchModel(BaseServing):
    """Serves the model with every eval conv + BatchNorm pair folded into
    one conv (``infer/fuse.py::fold_for_serving``): ``self.model``'s state
    dict is the unfused model's, and ``self.model.load_state_dict`` refolds.
    ``deploy=True`` serves the deploy rewrite instead, as
    ``export_model(deploy=True)`` does (its state dict's keys differ)."""

    def __init__(self, *args, deploy: bool = False, **kwargs):
        self.deploy = deploy
        super().__init__(*args, **kwargs)

    def _convert(self, model: DFINE) -> DFINE:
        """The fp32 model with its weights -> what this backend serves."""
        if self.deploy:
            return convert_to_deploy(model)
        return fold_for_serving(model, torch.bfloat16 if self.half else torch.float32)

    def _build(self, model_path: Optional[str]) -> None:
        dtype = torch.bfloat16 if self.half else torch.float32
        model = build_model(self.model_name, self.n_outputs, self.enable_mask_head,
                            dtype=torch.float32, device="cpu", cfg_overrides=self.cfg_overrides)
        model = self._convert(load_weights(model, model_path))
        self.model = set_compute_dtype(model, dtype).to(self.device).eval()
        if self.device.type == "cuda":
            check_kernel_limits(self.model)

    def _predict(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        return decode(self.model, images, self.num_top_queries)

    def warmup(self, hw_buckets) -> None:
        """One forward per (h, w) bucket: the shape's constants (anchors,
        positional embedding) are made then, not on a first request."""
        with torch.inference_mode():
            for h, w in hw_buckets:
                self._predict(torch.zeros((1, 3, h, w), device=self.device))


class Int8Model(TorchModel):
    """INT8 serving: the weights of every linear layer and in-projection in
    int8, computed per ``infer.int8.set_int8_mode`` (``w8a8`` or
    ``w8a16``); the convolutions in the compute dtype. An int8 artifact
    (``apps.quant``'s ``export_int8.npz``) is served as it is, its reverted
    kernels in fp, as JAX's ``convert_params_int8`` leaves a converted tree."""

    def _convert(self, model: DFINE) -> DFINE:
        model = super()._convert(model)
        return model if count_int8(model)[0] else convert_int8(model)
