"""Exported-artifact serving backend (port of
``dfine_tpu/infer/exported_model.py``): loads a ``.pt2`` that
``dfine_tpu_torch.export`` wrote (``torch.export.load``; this package,
imported, registers the custom op it calls) and serves it. Without an
artifact it exports in process, as building an engine on first load. The
program has one input shape (the batch may be symbolic), so ``warmup`` is a
no-op."""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

import torch

from ..export import make_exported
from .torch_model import TorchModel


class ExportedModel(TorchModel):
    def __init__(self, *args, artifact_path: Optional[str] = None, **kwargs):
        self.artifact_path = artifact_path
        super().__init__(*args, **kwargs)

    def _build(self, model_path: Optional[str]) -> None:
        if self.artifact_path and Path(self.artifact_path).exists():
            program = torch.export.load(self.artifact_path)
        else:
            super()._build(model_path)
            program = make_exported(self.model, self.input_size, self.num_top_queries)
            del self.model
        self._call = program.module()

    def _predict(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        return self._call(images)

    def warmup(self, hw_buckets) -> None:
        pass
