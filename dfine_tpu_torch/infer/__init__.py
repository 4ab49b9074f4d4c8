from .torch_model import TorchModel  # noqa: F401
