from .aot_model import AOTModel  # noqa: F401
from .exported_model import ExportedModel  # noqa: F401
from .torch_model import Int8Model, TorchModel  # noqa: F401
