"""In-flash bitmap-index query (paper §6.2) on the PyTorch port, wired into
the data pipeline.

Daily user-activity bitmaps live in flash as aligned pairs; the "active
every day" query is an AND chain over them, materialized as one fused
sense->reduce pass on the card, and its bit-count as one fused
sense->reduce->popcount pass — the paper's workload, reused as the
framework's training-data filter (:class:`repro_torch.data.BitmapFilter`).

    PYTHONPATH=src python examples/torch_bitmap_index.py               # the card
    PYTHONPATH=src python examples/torch_bitmap_index.py --device cpu  # 1 kB pages
"""
import argparse

import numpy as np

from repro_torch.api import ComputeSession
from repro_torch.data import BitmapFilter
from repro_torch.flash import SSDConfig, bitmap_index, speedup_table

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default=None,
                help="torch device (default: the card; 'cpu' runs the "
                     "kernels' plain versions at 1 kB pages)")
args = ap.parse_args()
config = SSDConfig(page_kb=1) if args.device == "cpu" else None

rng = np.random.default_rng(11)
sess = ComputeSession(args.device, config=config, seed=17)
n_users = sess.device.config.page_bits            # one page worth of users
bf = BitmapFilter(n_users, session=sess)
days = 8

daily = [(rng.random(n_users) < 0.9).astype(np.uint8) for _ in range(days)]
for d in range(0, days, 2):
    bf.add_pair(f"day{d}", daily[d], f"day{d+1}", daily[d + 1])

pairs = [(f"day{d}", f"day{d+1}") for d in range(0, days, 2)]
mask = bf.select(pairs)
count = bf.count(pairs)
want = np.logical_and.reduce(daily)
np.testing.assert_array_equal(mask, want.astype(bool))
assert count == int(want.sum())
print(f"active-every-day users (in-flash AND over {days} days): "
      f"{count} / {n_users}  — matches host oracle")

stats = bf.session.stats()
print(f"flash commands issued: {stats['ledger']['commands']}; "
      f"die-parallel time {bf.device.ledger.makespan_us():.0f} us (serial {bf.device.ledger.serial_us():.0f} us); "
      f"senses {stats['in_flash_senses']}, fused combines {stats['fused_reduce_calls']}, "
      f"plan cache {stats['plan_cache']}")

# the paper's full-scale projection (800M users, 1-12 months)
for months in (1, 6, 12):
    s = speedup_table(bitmap_index(months))["speedup_vs"]
    print(f"{months:>2d} months: OSC {s['osc']:6.1f}x  ISC {s['isc']:6.1f}x  "
          f"ParaBit {s['parabit']:5.2f}x  FC {s['flashcosmos']:4.2f}x")
