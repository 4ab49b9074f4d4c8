"""Device activities (kernels, copies, fills) of the profiled steps over
their number."""


def read(rec):
    prof = rec.get("profile")
    if rec.get("kind") != "train_steps" or not prof or not prof["activities"]:
        return None
    return prof["activities"] / prof["calls"]
