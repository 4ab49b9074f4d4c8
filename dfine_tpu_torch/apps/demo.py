"""Upload an image, see the detections (port of ``demo/demo.py``, ``make
demo``):

    python -m dfine_tpu_torch.apps.demo [config.yaml] [key.path=value ...] [image ...]

Serves ``best.ckpt`` with ``TorchModel`` on the card (``device="cpu"``: the
plain path). With gradio (imported here only) and no image argument: the
upload-and-overlay web interface. Otherwise each image argument (``.jpg``,
``.jpeg``, ``.png``) is drawn to ``<image>.pred.jpg`` (written through PIL).
"""

from __future__ import annotations

import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..config import ConfigNode, cli_config
from ..data.image_io import read_bgr, write_image
from ..device import resolve_device
from ..infer import TorchModel
from ..utils.viz import draw_detections
from .common import experiment_dir, label_names, serving_kwargs

IMAGE_SUFFIXES = (".jpg", ".jpeg", ".png")


def build_model_from_cfg(cfg: ConfigNode, device=None) -> Tuple[TorchModel, Dict[int, str]]:
    model = TorchModel(cfg.model_name, str(experiment_dir(cfg) / "best.ckpt"),
                       **serving_kwargs(cfg, device))
    return model, label_names(cfg)


def predict_and_draw(model, label_to_name: Dict[int, str],
                     image_rgb: np.ndarray) -> Tuple[np.ndarray, str]:
    bgr = np.ascontiguousarray(image_rgb[..., ::-1])
    t0 = time.perf_counter()
    (res,) = model(bgr)
    dt = (time.perf_counter() - t0) * 1000
    out = draw_detections(bgr, res["boxes"], res["labels"], res["scores"],
                          res.get("masks"), label_to_name)
    return out[..., ::-1], f"{len(res['labels'])} detections, {dt:.1f} ms"


def main(argv: Optional[List[str]] = None, device=None) -> List[Path]:
    dev = resolve_device(device)
    args = argv if argv is not None else sys.argv[1:]
    image_args = [a for a in args if a.lower().endswith(IMAGE_SUFFIXES)]
    cfg = cli_config([a for a in args if a not in image_args])
    model, label_to_name = build_model_from_cfg(cfg, dev)

    try:
        import gradio as gr
    except ImportError:
        gr = None

    if gr is not None and not image_args:
        def fn(img):
            return predict_and_draw(model, label_to_name, img)

        gr.Interface(
            fn=fn, inputs=gr.Image(type="numpy"),
            outputs=[gr.Image(type="numpy"), gr.Text()],
            title="D-FINE-seg demo",
        ).launch()
        return []
    if not image_args:
        print("gradio not installed; pass an image path for CLI mode")
        return []
    written = []
    for p in image_args:
        bgr = read_bgr(p)
        if bgr is None:
            raise FileNotFoundError(f"cannot read the image {p}")
        out, txt = predict_and_draw(model, label_to_name, bgr[..., ::-1])
        dst = Path(p).with_suffix(".pred.jpg")
        write_image(dst, np.ascontiguousarray(out[..., ::-1]))
        print(f"{p}: {txt} -> {dst}")
        written.append(dst)
    return written


if __name__ == "__main__":
    main()
