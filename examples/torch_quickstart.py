"""Quickstart on the PyTorch port: MCFlash through the compute-session API.

Opens a :class:`repro_torch.api.ComputeSession` on a simulated COTS 3D NAND
chip, registers two random operand vectors as aligned shared pages, records
lazy bitwise expressions, and materializes every Table-1 op in-flash
(shifted reads / SBR through the CUDA sense kernel), checking each against
numpy.  Then prints the plan cache behaviour, the RBER-vs-endurance
harness, the Fig-9 system-level timelines, and the traced device timeline
of everything this script just executed.

    PYTHONPATH=src python examples/torch_quickstart.py               # the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu  # 1 kB pages
"""
import argparse

import numpy as np

from repro_torch.api import ComputeSession
from repro_torch.core import rber
from repro_torch.flash import (SSDConfig, TimingModel, isc_time_us,
                               mcflash_time_us, osc_time_us)

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default=None,
                help="torch device (default: the card; 'cpu' runs the "
                     "kernels' plain versions at 1 kB pages)")
args = ap.parse_args()
config = SSDConfig(page_kb=1) if args.device == "cpu" else None

sess = ComputeSession(args.device, config=config, seed=0, trace=True)
chip = sess.chip
print(f"chip: {chip.part_number} ({chip.description}); "
      f"device {sess.stats()['device']}, backend {sess.backend.name}\n")

print("== Table-1 read plans (compiled once per op through the plan cache) ==")
for line in sess.describe_plans():
    print("  " + line)

print("\n== lazy in-flash ops on one wordline pair ==")
rng = np.random.default_rng(0)
n = sess.device.config.page_bits
a_bits = (rng.random(n) < 0.5).astype(np.uint8)
b_bits = (rng.random(n) < 0.5).astype(np.uint8)
a, b = sess.write_pair("a", a_bits, "b", b_bits)

exprs = {
    "and": (a & b, a_bits & b_bits),
    "or": (a | b, a_bits | b_bits),
    "xnor": (a.xnor(b), 1 - (a_bits ^ b_bits)),
    "xor": (a ^ b, a_bits ^ b_bits),
    "nand": (~(a & b), 1 - (a_bits & b_bits)),   # one inverse-read sense
}
for op, (expr, want) in exprs.items():
    got = sess.materialize(expr, unpacked=True).cpu().numpy()
    ok = bool(np.array_equal(got, want))
    us = sess.ledger.die_busy_us[0]
    print(f"  {op.upper():5s}: bit-exact={ok}  (cumulative die time {us:.0f} us)")
    assert ok, f"{op} differs from numpy"

s = sess.stats()
print(f"\nplan cache: {s['plan_cache']}  "
      f"(every repeat op was a cache hit — re-planned at most once per op)")
print(f"in-flash senses: {s['in_flash_senses']}, "
      f"fused controller combines: {s['fused_reduce_calls']}")

print("\n== RBER vs endurance (paper Table 2 / Fig 6) ==")
for n_pe in (0, 1500, 10000):
    r = rber.measure_rber("xnor", chip, pages=8, n_pe=n_pe, seed=1,
                          device=sess.torch_device)
    print(f"  XNOR @ {n_pe:>6d} P/E: RBER = {r.rber_pct:.5f}% "
          f"({r.errors} errors in {r.bits} bits)")

print("\n== Fig 9 system timelines (2 x 8 MB operands) ==")
t = TimingModel()
print(f"  OSC                 {osc_time_us(t):7.0f} us   (paper 2063)")
print(f"  ISC                 {isc_time_us(t):7.0f} us   (paper 1495)")
print(f"  MCFlash (aligned)   {mcflash_time_us(t):7.0f} us   (paper 1087)")
print(f"  MCFlash (realign)   {mcflash_time_us(t, aligned=False):7.0f} us   (paper 1807)")

# every program/sense/DMA above was recorded as a span on its die/channel
# lane; `sess.trace.export("trace.json")` writes the Perfetto-loadable JSON
print("\n== traced device timeline of this session ==")
print(sess.trace.report(sess.ledger))
