"""D-FINE det+seg in PyTorch for an NVIDIA H100.

The port of ``dfine_tpu`` (JAX, the reference it is held against). It
imports torch, numpy, scipy (the train step's Hungarian solver) and the
standard library only. Its entry points run on the card unless the caller
passes ``device="cpu"``; hand-written CUDA kernels live in ``csrc/`` and
are built at first use (``ops/kernels``). ``train/`` holds the detection
train step.
"""

from .models import build_model  # noqa: F401
from .infer import TorchModel  # noqa: F401
