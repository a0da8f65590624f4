"""Bitmap-query serving on the PyTorch port: concurrent predicate requests
through the :class:`repro_torch.serve.QueryEngine` with cross-request wave
coalescing.

Eight analytics-style predicates over shared column bitmaps arrive one at a
time; the engine admits each immediately (returning a ticket), forms
SLO-bounded batches, and lowers every batch in one pass so senses shared
across requests dispatch as shared waves — fewer waves than the same
requests would take served one at a time.  Every result is checked against
numpy, and the exported Chrome trace carries a request-lifecycle span per
query.

    PYTHONPATH=src python examples/torch_serve_bitmap.py               # the card
    PYTHONPATH=src python examples/torch_serve_bitmap.py --device cpu  # 1 kB pages
"""
import argparse

import numpy as np
import torch

from repro_torch.api import ComputeSession
from repro_torch.api.hostio import to_numpy
from repro_torch.flash import SSDConfig
from repro_torch.kernels.ref import pack_bits
from repro_torch.serve import QueryEngine, SLOConfig

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default=None,
                help="torch device (default: the card; 'cpu' runs the "
                     "kernels' plain versions at 1 kB pages)")
ap.add_argument("--trace-out", default="trace_serve_example.json",
                help="where to write the Chrome trace JSON")
args = ap.parse_args()
config = SSDConfig(page_kb=1) if args.device == "cpu" else None

rng = np.random.default_rng(7)
sess = ComputeSession(args.device, config=config, trace=True)
n = sess.device.config.page_bits


def packed(bits: np.ndarray) -> np.ndarray:
    """Bits -> uint32 words in the session's packed layout."""
    return to_numpy(pack_bits(torch.from_numpy(bits).reshape(1, -1))[0])


# shared column bitmaps: region / tier / activity flags, striped over dies
cols = {}
names = ["us", "eu", "paid", "trial", "active", "churned"]
for i in range(0, len(names), 2):
    a, b = names[i], names[i + 1]
    cols[a] = (rng.random(n) < 0.5).astype(np.uint8)
    cols[b] = (rng.random(n) < 0.5).astype(np.uint8)
    va, vb = sess.write_pair(a, cols[a], b, cols[b],
                             die=(i // 2) % sess.device.config.dies)
    cols[a + "_v"], cols[b + "_v"] = va, vb


def v(name):
    return cols[name + "_v"]


queries = [
    ("us AND paid", v("us") & v("paid"), False, cols["us"] & cols["paid"]),
    ("eu AND active", v("eu") & v("active"), False,
     cols["eu"] & cols["active"]),
    ("paid XOR trial", v("paid") ^ v("trial"), False,
     cols["paid"] ^ cols["trial"]),
    ("us OR eu", v("us") | v("eu"), False, cols["us"] | cols["eu"]),
    ("count(us AND paid)", v("us") & v("paid"), True,             # shares senses
     cols["us"] & cols["paid"]),
    ("count(active)", v("active") & v("active"), True, cols["active"]),
    ("eu AND churned", v("eu") & v("churned"), False,
     cols["eu"] & cols["churned"]),
    ("count(eu AND active)", v("eu") & v("active"), True,         # shares senses
     cols["eu"] & cols["active"]),
]

# how many waves these queries would cost served one at a time
solo_waves = sum(len(sess.lower(expr).waves) for _, expr, _, _ in queries)

eng = QueryEngine(sess, SLOConfig(max_batch_requests=4, max_delay_us=1e6))
tickets = []
for label, expr, popcount, want in queries:
    tickets.append((label, eng.submit(expr, popcount=popcount), want))
    eng.poll()                        # dispatches once a full batch forms
eng.drain()

for label, ticket, want in tickets:
    res = ticket.result()
    if ticket.popcount:
        assert res == int(want.sum()), label
        shown = f"{res} bits set"
    else:
        np.testing.assert_array_equal(res, packed(want))
        shown = f"{int(np.asarray(res).size)} packed words (batch {ticket.batch})"
    print(f"  rid {ticket.rid}: {label:<22s} -> {shown}  (matches numpy)")

st = eng.stats()
print(f"\n{st['requests_completed']} requests in "
      f"{st['batches_dispatched']} coalesced batches: "
      f"{st['sense_waves']} waves dispatched vs {solo_waves} solo "
      f"(waves_shared={st['waves_shared']}, "
      f"coalesced_sense_groups={st['coalesced_sense_groups']})")
assert st["sense_waves"] < solo_waves, "coalescing should beat solo serving"
path = sess.trace.export(args.trace_out)
print(f"per-request lifecycle spans exported to {path} "
      "(load in chrome://tracing or ui.perfetto.dev)")
