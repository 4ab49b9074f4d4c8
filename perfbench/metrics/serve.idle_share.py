"""Share of a frame's time in the timed window in which no device
activity ran, in %: 1 - (device busy time a frame in the profiled window,
the union of its activities over its calls) / (the timed window's wall
over its frames). The profiled window's own wall is not used: the
profiler's host overhead lengthens it."""

KIND = "serve_stream"


def read(rec):
    prof = rec.get("profile")
    if rec.get("kind") != KIND or not prof or prof["busy_s"] <= 0 or not rec["frames"]:
        return None
    return 100.0 * (1.0 - (prof["busy_s"] / prof["calls"]) / (rec["window_s"] / rec["frames"]))
