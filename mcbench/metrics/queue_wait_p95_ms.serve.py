"""95th percentile of due time -> dispatch: the first poll after which
every root ticket of the request reports dispatched."""
import numpy as np


def read(rec):
    waits = rec.get("serve", {}).get("queue_waits_ms")
    return float(np.percentile(waits, 95)) if waits else None
