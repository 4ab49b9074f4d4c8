"""Device time a frame of the profiled window's copies from the card to the
host (the profiler's ``Memcpy DtoH`` activities: the scores, labels and
boxes, and with the mask head the frame's uint8 masks), in ms: their
summed device seconds over the profiled frames. None where the window
holds no such copy."""

KIND = "serve_stream"


def read(rec):
    prof = rec.get("profile")
    if rec.get("kind") != KIND or not prof or not prof.get("calls"):
        return None
    d2h = [s for name, s in prof.get("kernel_s", {}).items() if name.startswith("Memcpy DtoH")]
    if not d2h:
        return None
    return 1e3 * sum(d2h) / prof["calls"]
