"""95th percentile of the same latencies as query_p50_ms.  A request that
never completes makes the run incorrect, so none is left out unseen.  A
per-layer reading: from run to run it spreads more than any bound can hold
(stalls of the engine's host path set it)."""
import numpy as np


def read(rec):
    lat = rec.get("serve", {}).get("latencies_ms")
    return float(np.percentile(lat, 95)) if lat else None
