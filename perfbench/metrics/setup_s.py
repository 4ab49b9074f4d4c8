"""Seconds from the process's start to the first timed frame or step."""


def read(rec):
    return rec["setup_s"]
