"""The data pipeline without cv2 (port of ``dfine_tpu/data``)."""

from .dataset import DetectionDataset, Sample  # noqa: F401
from .loader import Loader  # noqa: F401
