"""Self time of the session tracer's lower spans, per request."""


def read(rec):
    serve, spans = rec.get("serve"), rec.get("spans", {})
    if not serve or not spans.get("lower_spans"):
        return None
    return spans["lower_us"] / 1e3 / serve["requests"]
