"""Detection and segmentation metrics (port of ``dfine_tpu/eval``)."""

from .validator import Validator  # noqa: F401
