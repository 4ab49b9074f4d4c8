"""Images of every train step issued in the window over the window's wall
seconds (the window ends with a synchronize)."""


def read(rec):
    if rec.get("kind") != "train_steps" or not rec["steps"]:
        return None
    return rec["steps"] * rec["batch"] / rec["window_s"]
