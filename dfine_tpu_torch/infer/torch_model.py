"""Eager PyTorch serving backends (port of ``dfine_tpu/infer/jax_model.py``):
model forward plus the NMS-free top-k decode on the card. ``TorchModel``
computes in bf16 or fp32 on the BatchNorm-folded model (``infer/fuse.py``);
``Int8Model`` is ``TorchModel`` on the int8-converted model.
``serving_model`` makes the model that every serving backend serves and
that ``export_model`` writes."""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

from ..models.dfine import DFINE, build_model, set_compute_dtype
from ..ops.kernels import check_kernel_limits
from ..postprocess import topk_decode
from .base import BaseServing, load_weights
from .fuse import fold_for_serving
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


def serving_model(model_name: str, num_classes: int, enable_mask_head: bool,
                  model_path: Optional[str], dtype: torch.dtype, device: torch.device,
                  cfg_overrides: Sequence[Tuple[str, Any]] = (),
                  convert: Callable[[DFINE], DFINE] = lambda m: m) -> DFINE:
    """The served model: built in fp32 on the CPU, its weights loaded
    (``load_weights``), folded for serving with the folded tensors in
    ``dtype`` (``fold_for_serving``), ``convert``-ed while its weights are
    still fp32 (``Int8Model``: the int8 conversion; export: the npz
    written), cast to ``dtype``, moved to ``device`` and set to eval; on
    the card its kernels' limits checked."""
    model = build_model(model_name, num_classes, enable_mask_head, dtype=torch.float32,
                        device="cpu", cfg_overrides=cfg_overrides)
    model = convert(fold_for_serving(load_weights(model, model_path), dtype))
    model = set_compute_dtype(model, dtype).to(device).eval()
    if device.type == "cuda":
        check_kernel_limits(model)
    return model


class TorchModel(BaseServing):
    """Serves ``serving_model``'s model: every eval conv + BatchNorm pair
    folded into one conv (``infer/fuse.py::fold_for_serving``);
    ``self.model``'s state dict is the unfused model's, and
    ``self.model.load_state_dict`` refolds."""

    def _convert(self, model: DFINE) -> DFINE:
        """The folded fp32 model -> what this backend serves."""
        return model

    def _build(self, model_path: Optional[str]) -> None:
        self.model = serving_model(self.model_name, self.n_outputs, self.enable_mask_head,
                                   model_path, torch.bfloat16 if self.half else torch.float32,
                                   self.device, self.cfg_overrides, self._convert)

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
        return model if count_int8(model)[0] else convert_int8(model)
