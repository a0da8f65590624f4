"""The session's sense_waves counter over the window, per request."""


def read(rec):
    serve = rec.get("serve")
    if not serve:
        return None
    return rec["counters"]["sense_waves"] / serve["requests"]
