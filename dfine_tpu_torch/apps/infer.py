"""Run the model over a folder of images (port of
``dfine_tpu/apps/infer.py``, ``make infer``):

    python -m dfine_tpu_torch.apps.infer [config.yaml] [key.path=value ...]

For each image of ``train.path_to_test_data`` (a folder or one file) it
writes, under ``train.infer_path``: the drawn predictions
(``images/<name>``), YOLO annotations (``annotations/<stem>.txt``: boxes,
or with ``task: segment`` one polygon line per contour of every instance),
with ``infer.to_crop`` each detection's crop padded by ``infer.paddings``
(a float: a share of the box; an int: pixels), and ``labels.txt``, the
names of the classes seen. ``best.ckpt`` served by ``TorchModel`` on the
card (``device="cpu"``: the plain path).

Videos are not read: the card's Python has no video decoder (no cv2,
imageio or torchvision, and PIL decodes no mp4), so a source that holds
videos raises before the first image, naming them.
"""

from __future__ import annotations

import sys
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from ..config import cli_config
from ..data.image_io import read_bgr, write_image
from ..data.labels import save_yolo_label_file
from ..device import resolve_device
from ..infer import TorchModel
from ..utils.viz import draw_detections
from .common import experiment_dir, label_names, serving_kwargs

IMG_EXT = {".jpg", ".jpeg", ".png", ".bmp", ".webp"}
VID_EXT = {".mp4", ".avi", ".mov", ".mkv"}


def _pad_box(box, pad_w, pad_h, w, h):
    x1, y1, x2, y2 = box
    if isinstance(pad_w, float):
        pw, ph = (x2 - x1) * pad_w, (y2 - y1) * pad_h
    else:
        pw, ph = pad_w, pad_h
    return (
        int(max(0, x1 - pw)),
        int(max(0, y1 - ph)),
        int(min(w, x2 + pw)),
        int(min(h, y2 + ph)),
    )


def run_images(model, paths, out_dir: Path, label_to_name: Dict[int, str], segment: bool,
               to_crop: bool, paddings) -> None:
    (out_dir / "images").mkdir(parents=True, exist_ok=True)
    (out_dir / "annotations").mkdir(exist_ok=True)
    if to_crop:
        (out_dir / "crops").mkdir(exist_ok=True)
    seen = set()
    for p in paths:
        img = read_bgr(p)
        if img is None:
            continue
        (res,) = model(img)
        h, w = img.shape[:2]
        vis = draw_detections(img, res["boxes"], res["labels"], res["scores"],
                              res.get("masks"), label_to_name)
        write_image(out_dir / "images" / p.name, vis)
        if segment and "masks" in res:
            # every contour of a multi-part instance becomes a YOLO-seg line
            polys = []
            keep = []
            for i, m in enumerate(res["masks"]):
                for poly in model.mask2poly(m):
                    polys.append(poly / np.asarray([w, h], np.float32))
                    keep.append(i)
            save_yolo_label_file(out_dir / "annotations" / f"{p.stem}.txt",
                                 res["labels"][keep], polygons=polys)
        else:
            b = np.asarray(res["boxes"], np.float32)
            if len(b):
                boxes_n = np.stack(
                    [(b[:, 0] + b[:, 2]) / 2 / w, (b[:, 1] + b[:, 3]) / 2 / h,
                     (b[:, 2] - b[:, 0]) / w, (b[:, 3] - b[:, 1]) / h], -1)
            else:
                boxes_n = np.zeros((0, 4), np.float32)
            save_yolo_label_file(out_dir / "annotations" / f"{p.stem}.txt",
                                 res["labels"], boxes=boxes_n)
        for cls in res["labels"]:
            seen.add(int(cls))
        if to_crop:
            for i, box in enumerate(res["boxes"]):
                x1, y1, x2, y2 = _pad_box(box, paddings["w"], paddings["h"], w, h)
                crop = img[y1:y2, x1:x2]
                if crop.size:
                    name = label_to_name.get(int(res["labels"][i]), str(int(res["labels"][i])))
                    write_image(out_dir / "crops" / f"{p.stem}_{i}_{name}.jpg", crop)
    inv = out_dir / "labels.txt"
    inv.write_text("\n".join(label_to_name.get(c, str(c)) for c in sorted(seen)) + "\n")


def main(argv: Optional[List[str]] = None, device=None) -> Dict:
    dev = resolve_device(device)
    cfg = cli_config(argv if argv is not None else sys.argv[1:])
    t = cfg.train
    src = Path(t.path_to_test_data)
    files = sorted(src.iterdir()) if src.is_dir() else [src]
    images = [p for p in files if p.suffix.lower() in IMG_EXT]
    videos = [p for p in files if p.suffix.lower() in VID_EXT]
    if videos:
        raise NotImplementedError(
            f"{len(videos)} videos in {src} ({', '.join(p.name for p in videos[:5])}): the port "
            "reads no video (no decoder: cv2, imageio and torchvision are absent and PIL "
            "decodes no mp4); move them out of the folder or decode them into images")
    model = TorchModel(cfg.model_name, str(experiment_dir(cfg) / "best.ckpt"),
                       **serving_kwargs(cfg, dev))
    out_dir = Path(t.infer_path)
    run_images(model, images, out_dir, label_names(cfg), cfg.task == "segment",
               bool(cfg.infer.to_crop), dict(cfg.infer.paddings))
    print(f"infer done: {len(images)} images -> {out_dir}")
    return {"images": len(images), "out_dir": out_dir}


if __name__ == "__main__":
    main()
