"""Set-up: process start to the first timed query (host clock)."""


def read(rec):
    return rec["setup_s"]
