from .dfine import DFINE, build_model  # noqa: F401
