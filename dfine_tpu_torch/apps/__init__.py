"""Command-line entry points (``python -m dfine_tpu_torch.apps.<name>``)."""
