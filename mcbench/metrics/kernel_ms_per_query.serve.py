"""Device time of every operation on the card (kernels, memsets, copies on
the card; host copies left out), per request."""


def read(rec):
    serve, dev = rec.get("serve"), rec.get("device")
    if not serve or not dev:
        return None
    return dev["work_s"] * 1e3 / serve["requests"]
