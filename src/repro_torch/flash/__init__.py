"""Simulated SSD substrate hosting MCFlash (PyTorch port of
:mod:`repro.flash`).

- ``geometry``: SSD/NAND organisation (16 ch x 8 die x 4 plane, 16 kB pages).
- ``arena``: die-sharded device-resident Vth storage.
- ``device``: functional NAND array (Vth state, plans through a backend,
  P/E tracking, time/energy ledger).
- ``ftl``: allocation, wear leveling, operand alignment.
- ``timing`` / ``energy``: calibrated latency and energy models.
"""
