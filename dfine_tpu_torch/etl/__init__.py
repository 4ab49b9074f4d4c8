"""Dataset tools (``python -m dfine_tpu_torch.etl.<name>``), host-only."""
