"""Serving base: the uniform inference contract (port of
``dfine_tpu/infer/base.py``).

``__call__(BGR ndarray | list of them) -> [{"labels", "boxes", "scores"
[, "masks"]}]`` with three preprocess modes (plain resize; ``keep_ratio``:
the centred letterbox; ``rect``: the aspect-preserving resize anchored
top-left on its stride-32 canvas, whose buckets are warmed up at load),
per-class confidence thresholds, optional class-wise NMS, ``mask2poly``,
and a ``_test_pred`` smoke check at construction. Each image's true
(pad_top, pad_left) goes to the postprocess. Unlike the JAX serving
classes, which resize uint8 frames with cv2 on the host, the port ships the
uint8 frame to the card and resizes floats there (as ``bench.py`` does).

Weights: ``None`` (``build_model``'s seeded random weights), an ``.npz`` of
JAX variables (``dfine_tpu.utils.checkpoint.save_params_npz``'s layout; an
int8 one, ``apps.quant``'s ``export_int8.npz``, gives ``Int8Linear``
modules for its quantized kernels: ``infer/int8.py``), a
reference ``.pth`` / ``.pt``, or a ``.ckpt`` trainer checkpoint of the
port's ``Trainer``, served with its EMA weights (its model's weights where
it trained without EMA). A directory, the JAX trainer's orbax state,
raises.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..device import resolve_device
from ..ops.nms import batched_class_nms
from ..ops.preprocess import preprocess_letterbox, preprocess_plain, preprocess_rect, rect_bucket
from ..postprocess import postprocess_predictions
from ..utils.checkpoint import (load_jax_variables, load_torch_checkpoint, read_state,
                                unflatten)
from ..utils.profiling import count, span
from .contours import mask2poly
from .int8 import load_int8_variables

_LOG = logging.getLogger("dfine_tpu_torch")

# canonical source aspect ratios covering common camera/video geometries;
# each maps to ONE stride-32 rect bucket at a given input size
_CANONICAL_RATIOS = (
    (1080, 1920), (1920, 1080),  # 16:9 / 9:16
    (1200, 1600), (1600, 1200),  # 4:3 / 3:4
    (1000, 1500), (1500, 1000),  # 2:3 / 3:2
    (1000, 1000),                # 1:1
)


def default_rect_buckets(input_size) -> list:
    """Deduplicated (h, w) bucket set for rect mode's warm-up at load."""
    return sorted({rect_bucket(h, w, input_size) for h, w in _CANONICAL_RATIOS})


def load_weights(model: torch.nn.Module, model_path: Optional[str]) -> torch.nn.Module:
    """Fill a port model in place from ``model_path`` (see the module doc)."""
    if model_path is None:
        return model
    p = Path(model_path)
    if p.is_dir() or p.suffix == ".ckpt":
        ck = read_state(p)
        use_ema = ck["meta"].get("use_ema", True)
        model.load_state_dict(ck["ema"] if use_ema else ck["model"], strict=True)
        return model
    if p.suffix == ".npz":
        with np.load(p) as z:
            flat = {k: z[k] for k in z.files}
        if any(k.startswith("quant/") for k in flat):  # apps.quant's export_int8.npz
            return load_int8_variables(model, flat)
        return load_jax_variables(model, unflatten(flat))
    if p.suffix in (".pth", ".pt"):
        return load_torch_checkpoint(model, p)
    raise ValueError(f"unsupported weights file {p} (expected .npz, .pth, .pt or .ckpt)")


class BaseServing:
    _calls = 0  # calls served: a frame's spans share its number
    _warned_host_copy = False

    def __init__(
        self,
        model_name: str,
        model_path: Optional[str],
        n_outputs: int,
        input_width: int = 640,
        input_height: int = 640,
        conf_thresh: Union[float, List[float]] = 0.5,
        rect: bool = False,
        half: bool = True,  # bf16 compute
        keep_ratio: bool = False,
        use_nms: bool = False,
        nms_iou_thresh: float = 0.5,
        enable_mask_head: bool = False,
        num_top_queries: int = 300,
        prebuild_rect_buckets: bool = True,
        device: Optional[Union[str, torch.device]] = None,
        cfg_overrides: Sequence[Tuple[str, Any]] = (),
    ):
        self.device = resolve_device(device)
        # patched over the size's configuration, as build_model takes them
        # (e.g. (("decoder.num_levels", 4), ("decoder.num_points", (3, 6, 3, 3))))
        self.cfg_overrides = tuple(cfg_overrides)
        self.input_size = (input_height, input_width)
        self.model_name = model_name
        self.n_outputs = n_outputs
        self.rect = rect
        self.half = half
        self.keep_ratio = keep_ratio
        self.use_nms = use_nms
        self.nms_iou_thresh = nms_iou_thresh
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
        if self.rect and prebuild_rect_buckets:
            # rect serving: every canonical bucket ready at load, so the first
            # request at one runs at steady-state latency
            self.warmup(default_rect_buckets(self.input_size))

    def _build(self, model_path: Optional[str]) -> None:
        """Build the model and its weights; override per backend."""
        raise NotImplementedError

    def _predict(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        """images [B, 3, h, w] float on the device -> topk_decode's dict."""
        raise NotImplementedError

    def warmup(self, hw_buckets) -> None:
        """Make ready one program per (h, w) bucket; a no-op for backends of
        one fixed shape (``ExportedModel``)."""

    def _preprocess(self, image_bgr: np.ndarray):
        """-> ([1, 3, h, w] f32 on the device, proc_hw, orig_hw, pad_tl):
        pad_tl is the (pad_top, pad_left) applied, (0, 0) in rect mode, None
        for plain resize. A frame that is not C-contiguous is copied on the
        host first (counted as ``serve.host_copies``)."""
        if not image_bgr.flags.c_contiguous:
            count("serve.host_copies")
            if not self._warned_host_copy:
                self._warned_host_copy = True
                _LOG.warning("serving: a frame of shape %s is not C-contiguous; each such frame "
                             "is copied on the host before its H2D (hand over contiguous HWC "
                             "frames)", image_bgr.shape)
        raw = torch.from_numpy(np.ascontiguousarray(image_bgr)).to(self.device)
        rgb = raw.flip(-1)[None]  # BGR -> RGB, [1, H, W, 3] uint8
        pad_tl = None
        if self.rect:
            x, pad_tl = preprocess_rect(rgb, self.input_size)
        elif self.keep_ratio:
            x, pad_tl = preprocess_letterbox(rgb, self.input_size)
        else:
            x = preprocess_plain(rgb, self.input_size)
        return x, tuple(x.shape[2:]), tuple(image_bgr.shape[:2]), pad_tl

    def _prepare_inputs(self, images):
        single = isinstance(images, np.ndarray) and images.ndim == 3
        imgs = [images] if single else list(images)
        proc, proc_sizes, orig_sizes, pads = zip(*[self._preprocess(im) for im in imgs])
        return torch.cat(proc, 0), list(proc_sizes), list(orig_sizes), list(pads)

    def _postprocess(self, decoded, proc_sizes, orig_sizes, pads) -> List[Dict[str, np.ndarray]]:
        results = postprocess_predictions(decoded, proc_sizes[0], orig_sizes,
                                          conf_thresh=self.conf_thresh,
                                          keep_ratio=self.keep_ratio or self.rect,
                                          per_class_conf=self.per_class_conf, pads=pads)
        if self.use_nms:
            for r in results:
                if len(r["boxes"]) == 0:
                    continue
                keep = batched_class_nms(torch.from_numpy(r["boxes"]).to(self.device),
                                         torch.from_numpy(r["scores"]).to(self.device),
                                         torch.from_numpy(r["labels"]).to(self.device),
                                         self.nms_iou_thresh).cpu().numpy()
                for k in ("labels", "boxes", "scores", "masks"):
                    if k in r:
                        r[k] = r[k][keep]
        return results

    def __call__(self, images) -> List[Dict[str, np.ndarray]]:
        self._calls += 1
        with span("serve.frame", root=self._calls):
            with span("serve.pre"):
                batch, proc_sizes, orig_sizes, pads = self._prepare_inputs(images)
            with torch.inference_mode():
                with span("serve.program"):
                    decoded = self._predict(batch)
                with span("serve.post"):
                    return self._postprocess(decoded, proc_sizes, orig_sizes, pads)

    def _test_pred(self) -> None:
        rnd = np.random.default_rng(0).integers(0, 255, size=(1100, 1000, 3), dtype=np.uint8)
        out = self(rnd)
        if not (isinstance(out, list) and "boxes" in out[0]):
            raise RuntimeError("serving smoke check failed: malformed output")

    @staticmethod
    def mask2poly(mask: np.ndarray, epsilon_frac: float = 0.005) -> List[np.ndarray]:
        """Binary mask -> simplified outer polygons in absolute pixels, each
        [K, 2] float32 (x, y), K >= 3 (``infer/contours.py``; no cv2)."""
        return mask2poly(mask, epsilon_frac)
