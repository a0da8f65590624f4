"""1 - (union of every device op's interval / the traced window)."""


def read(rec):
    dev = rec.get("device")
    if not dev:
        return None
    return 100.0 * (1.0 - dev["busy_s"] / dev["window_s"])
