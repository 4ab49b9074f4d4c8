"""95th percentile latency of every frame in the window, in ms."""

import numpy as np


def read(rec):
    if rec.get("kind") != "serve_stream" or not rec["latency_s"]:
        return None
    return float(np.percentile(rec["latency_s"], 95)) * 1e3
