"""The benchmark of the PyTorch/CUDA port ``dfine_tpu_torch``: one command
runs one cell of ``BENCHMARK.json`` once (see ``README.md``)."""
