"""Wear-aware reliability layer: fault injection, detection, recovery.

- :mod:`repro_torch.reliability.faults` — a seeded, replayable
  ``FaultModel`` installed on :class:`repro_torch.flash.device.FlashDevice`
  that perturbs Vth rows at program time (P/E-scaled common-mode drift and
  bounded spread, retention shift, optional stuck cells / dead blocks).
- :mod:`repro_torch.reliability.checkwords` — per-vector sampled-parity
  signatures recorded at write time; bitwise ops are positionwise, so the
  stored samples evaluate through the op DAG and predict the result's
  samples exactly.
- :mod:`repro_torch.reliability.recovery` — on mismatch, a bounded
  read-retry ladder re-senses the lowered plan with shifted reference
  stacks, escalates to a reference recalibration sweep and finally migrates
  worn blocks to the wide-margin reduced-MLC encoding; every action is
  booked in the ledger.

``recovery`` is imported lazily (``from repro_torch.reliability.recovery
import ReliabilityManager``) so :mod:`repro_torch.flash.ftl` can import the
checkword helpers without a package cycle.
"""
from repro_torch.reliability.errors import (BlockRetiredError,
                                            ReliabilityError,
                                            RetryExhaustedError,
                                            SenseMismatchError)
from repro_torch.reliability.faults import FaultConfig, FaultModel
from repro_torch.reliability.policy import RetryPolicy

__all__ = [
    "BlockRetiredError",
    "FaultConfig",
    "FaultModel",
    "ReliabilityError",
    "RetryExhaustedError",
    "RetryPolicy",
    "SenseMismatchError",
]
