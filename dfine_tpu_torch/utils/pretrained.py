"""Pretrained weights, offline only (port of ``dfine_tpu/utils/pretrained.py``).

``train.pretrained_model_path``:

* a local ``.pth`` / ``.pt``: a whole-model state dict goes through
  ``load_torch_checkpoint`` (with the class-row map); a stage-1 backbone
  file (backbone-relative keys ``stem...`` / ``stages...``) is detected
  and loaded into the backbone;
* ``"auto"`` (the PPHGNetV2 stage-1 file of the size's backbone) or a URL:
  the file of that name in the weights cache (``$DFINE_WEIGHTS_DIR``, else
  ``~/.cache/dfine_tpu/weights``) where one was staged there by hand;
  otherwise the weights are unavailable and training starts from random
  init. Nothing is ever downloaded.

In a process group rank 0 resolves first and the others wait for it at a
barrier (pretrained.py:44-65), then resolve quietly.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, Optional

import torch

from .checkpoint import _SKIP_SUFFIXES, _torch_state_dict, load_torch_checkpoint

_STAGE1_NAME = "PPHGNetV2_{arch}_stage1.pth"
SIZE_TO_ARCH = {"n": "B0", "s": "B0", "m": "B2", "l": "B4", "x": "B5"}


def cache_dir() -> Path:
    return Path(os.environ.get("DFINE_WEIGHTS_DIR",
                               os.path.expanduser("~/.cache/dfine_tpu/weights")))


def resolve_pretrained(spec: Optional[str], model_name: str, logger=None) -> Optional[Path]:
    """``train.pretrained_model_path`` -> a local file, or None (see the
    module doc)."""
    if not spec:
        return None
    from ..parallel import dp as par

    if par.is_main_process():
        resolved = _resolve(spec, model_name, logger.info if logger is not None else print)
        par.barrier("pretrained")
        return resolved
    par.barrier("pretrained")
    return _resolve(spec, model_name, lambda msg: None)


def _resolve(spec: str, model_name: str, log) -> Optional[Path]:
    if spec == "auto" or spec.startswith(("http://", "https://")):
        name = (_STAGE1_NAME.format(arch=SIZE_TO_ARCH.get(model_name, "B0")) if spec == "auto"
                else spec.rsplit("/", 1)[-1])
        staged = cache_dir() / name
        if staged.exists():
            log(f"pretrained: using the staged {staged}")
            return staged
        log(f"pretrained: {name} is unavailable (nothing staged at {staged}; this package "
            "never downloads). Continuing from random init.")
        return None
    p = Path(spec)
    return p if p.exists() else None


def is_stage1_backbone_sd(sd: Dict) -> bool:
    """Stage-1 files hold backbone-relative keys (``stem...`` /
    ``stages...``), not whole-model keys (``backbone...`` / ``decoder...``)."""
    return any(k.startswith(("stem", "stages")) for k in sd) and not any(
        k.startswith(("backbone.", "decoder.", "encoder.")) for k in sd
    )


@torch.no_grad()
def load_pretrained(path: Path, model: torch.nn.Module, logger=None) -> torch.nn.Module:
    """Fill ``model`` in place from a whole-model or a stage-1 backbone file
    (detected). A stage-1 file fills the backbone's tensors of the same name
    and shape (its classification head has no counterpart) and raises if it
    fills none."""
    sd = _torch_state_dict(Path(path))
    if not is_stage1_backbone_sd(sd):
        return load_torch_checkpoint(model, sd)
    own = model.backbone.state_dict()
    fit = {k: torch.as_tensor(v) for k, v in sd.items()
           if k in own and tuple(own[k].shape) == tuple(torch.as_tensor(v).shape)
           and not k.endswith(_SKIP_SUFFIXES)}
    if not fit:
        raise ValueError(f"{path}: no tensor of this stage-1 file fits the backbone")
    model.backbone.load_state_dict(fit, strict=False)
    if logger is not None:
        logger.info(f"pretrained: stage-1 backbone file {path}: {len(fit)} of {len(own)} "
                    f"backbone tensors loaded, {len(sd) - len(fit)} of the file's skipped")
    return model
