"""The detection train step: criterion, optimizer, EMA (port of ``dfine_tpu/train``)."""
