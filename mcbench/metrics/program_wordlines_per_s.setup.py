"""Wordlines programmed during set-up, over the host clock around the
writes (each ending in a synchronize)."""


def read(rec):
    prog = rec["program"]
    return prog["wordlines"] / prog["seconds"] if prog["seconds"] > 0 else None
