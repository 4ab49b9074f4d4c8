"""What the apps share: the experiment directory, the class names and the
serving backends' settings, read from the config as the JAX apps read them."""

from __future__ import annotations

from pathlib import Path
from typing import Dict

from ..config import ConfigNode, get_latest_experiment_dir


def experiment_dir(cfg: ConfigNode) -> Path:
    """``train.path_to_save``, or, where it does not exist, the newest
    ``<exp_name>_*`` directory beside it."""
    exp_dir = Path(cfg.train.path_to_save)
    if not exp_dir.exists():
        exp_dir = get_latest_experiment_dir(exp_dir.parent, cfg.exp_name)
    return exp_dir


def label_names(cfg: ConfigNode) -> Dict[int, str]:
    return {int(k): v for k, v in cfg.train.label_to_name.items()}


def num_outputs(cfg: ConfigNode) -> int:
    return 1 if cfg.train.use_one_class else len(cfg.train.label_to_name)


def serving_kwargs(cfg: ConfigNode, device) -> dict:
    """The keyword arguments every app gives a serving backend."""
    t = cfg.train
    return dict(n_outputs=num_outputs(cfg), input_height=t.img_size[0],
                input_width=t.img_size[1], conf_thresh=t.conf_thresh, keep_ratio=t.keep_ratio,
                enable_mask_head=cfg.task == "segment", device=device)
