"""The session's sense_batches counter over the window (per-die sense
kernel launches, fused passes not counted), per query."""


def read(rec):
    launches = rec.get("counters", {}).get("sense_batches")
    if launches is None or not rec.get("queries"):
        return None
    return launches / rec["queries"]
