"""Simulated SSD substrate hosting MCFlash (PyTorch port of
:mod:`repro.flash`).

- ``geometry``: SSD/NAND organisation (16 ch x 8 die x 4 plane, 16 kB pages).
- ``arena``: die-sharded device-resident Vth storage.
- ``device``: functional NAND array (Vth state, plans through a backend,
  P/E tracking, time/energy ledger).
- ``ftl``: allocation, wear leveling, operand alignment.
- ``timing`` / ``energy``: calibrated latency and energy models.
- ``system``: k-operand OSC/ISC/ParaBit/Flash-Cosmos/MCFlash comparison model.
"""
from repro_torch.flash.arena import ShardedVthArena, VthArena
from repro_torch.flash.device import FlashDevice, Ledger
from repro_torch.flash.energy import EnergyModel
from repro_torch.flash.ftl import FTL
from repro_torch.flash.geometry import PAGE_BITS, SSDConfig
from repro_torch.flash.system import (SystemModel, Workload, bitmap_index,
                                      image_encryption, image_segmentation,
                                      speedup_table)
from repro_torch.flash.timing import (TimingModel, isc_time_us,
                                      mcflash_time_us, osc_time_us)

__all__ = [
    "FlashDevice", "Ledger", "FTL", "SSDConfig", "PAGE_BITS",
    "VthArena", "ShardedVthArena",
    "TimingModel", "EnergyModel", "SystemModel", "Workload",
    "osc_time_us", "isc_time_us", "mcflash_time_us",
    "image_segmentation", "image_encryption", "bitmap_index", "speedup_table",
]
