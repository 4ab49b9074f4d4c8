"""D-FINE det+seg in PyTorch for an NVIDIA H100.

The port of ``dfine_tpu`` (JAX, the reference it is held against). It
imports torch, numpy, scipy (the connected components of
``infer/contours.py``) and the standard library only. Its entry points run
on the card unless the caller passes ``device="cpu"``; hand-written CUDA
kernels live in ``csrc/`` and are built at first use (``ops/kernels``).
``infer/`` holds the serving backends (eager, int8, CUDA-graph and
exported), ``export.py`` the export formats, ``train/`` the train step and
the trainer, ``apps/`` and ``etl/`` the command-line apps and dataset tools
(``python -m dfine_tpu_torch.apps.<name>``). Importing the package
registers the custom op ``dfine_tpu_torch::ms_deform_attn_fwd`` that
exported programs call.
"""

from .models import build_model  # noqa: F401
from .infer import AOTModel, ExportedModel, Int8Model, TorchModel  # noqa: F401
