"""Median latency over every request due in the window: from its due time
to the moment the harness sees its last root's result on the host."""
import numpy as np


def read(rec):
    lat = rec.get("serve", {}).get("latencies_ms")
    return float(np.percentile(lat, 50)) if lat else None
