"""Serving base: the uniform inference contract (port of
``dfine_tpu/infer/base.py``, plain-resize mode).

``__call__(BGR ndarray | list of them) -> [{"labels", "boxes", "scores"
[, "masks"]}]`` with per-class confidence thresholds and a ``_test_pred``
smoke check at construction. Unlike the JAX serving classes, which resize
uint8 frames with cv2 on the host, the port ships the uint8 frame to the
card and resizes floats there (as ``bench.py`` does). Letterbox and rect
modes, NMS and ``mask2poly`` wait for a later slice.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ..device import resolve_device
from ..ops.preprocess import preprocess_plain
from ..postprocess import postprocess_predictions


class BaseServing:
    def __init__(
        self,
        model_name: str,
        model_path: Optional[str],
        n_outputs: int,
        input_width: int = 640,
        input_height: int = 640,
        conf_thresh: Union[float, List[float]] = 0.5,
        half: bool = True,  # bf16 compute
        enable_mask_head: bool = False,
        num_top_queries: int = 300,
        device: Optional[Union[str, torch.device]] = None,
    ):
        self.device = resolve_device(device)
        self.input_size = (input_height, input_width)
        self.model_name = model_name
        self.n_outputs = n_outputs
        self.half = half
        self.enable_mask_head = enable_mask_head
        self.num_top_queries = num_top_queries
        if isinstance(conf_thresh, (list, tuple)):
            self.per_class_conf = {i: float(c) for i, c in enumerate(conf_thresh)}
            self.conf_thresh = float(min(conf_thresh))
        else:
            self.per_class_conf = None
            self.conf_thresh = float(conf_thresh)
        self._build(model_path)
        self._test_pred()

    def _build(self, model_path: Optional[str]) -> None:
        """Build the model and its weights; override per backend."""
        raise NotImplementedError

    def _predict(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        """images [B, 3, h, w] float on the device -> topk_decode's dict."""
        raise NotImplementedError

    def _prepare_inputs(self, images):
        single = isinstance(images, np.ndarray) and images.ndim == 3
        imgs = [images] if single else list(images)
        batch = []
        for im in imgs:
            raw = torch.from_numpy(np.ascontiguousarray(im)).to(self.device)
            rgb = raw.flip(-1)[None]  # BGR -> RGB, [1, H, W, 3] uint8
            batch.append(preprocess_plain(rgb, self.input_size))
        return torch.cat(batch, 0), [im.shape[:2] for im in imgs]

    def __call__(self, images) -> List[Dict[str, np.ndarray]]:
        batch, orig_sizes = self._prepare_inputs(images)
        with torch.inference_mode():
            decoded = self._predict(batch)
            return postprocess_predictions(decoded, self.input_size, orig_sizes,
                                           conf_thresh=self.conf_thresh,
                                           per_class_conf=self.per_class_conf)

    def _test_pred(self) -> None:
        rnd = np.random.default_rng(0).integers(0, 255, size=(1100, 1000, 3), dtype=np.uint8)
        out = self(rnd)
        if not (isinstance(out, list) and "boxes" in out[0]):
            raise RuntimeError("serving smoke check failed: malformed output")
