"""Median of the harness span 'post' around the serving call's part, closed
by a synchronize, over the traced run's span window, in ms."""

import numpy as np


def read(rec):
    spans = rec.get("span_window", {}).get("spans", {}).get("post")
    return float(np.median(spans)) * 1e3 if spans else None
