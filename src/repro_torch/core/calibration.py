"""Dynamic read-offset calibration (paper §5.4, Fig 7).

The optimal offset depends on endurance and aging: commercial chips ship
factory-calibrated references, and §5.4 notes that "the read-offset values
can be dynamically optimized based on cell state, spatial location, and
aging conditions".  This module implements that loop: sweep the op's moving
reference across its window on a sacrificial calibration page, measure RBER
per offset (Fig 7's curve), and return the window **centre** (most drift
headroom).  :func:`shift_plan` is also the reliability ladder's move: it
shifts a plan's whole reference stack by one offset.

Sampling draws from an explicit ``torch.Generator`` seeded with ``seed``
on ``device``; the JAX package draws from ``jax.random``, so the two agree
in distribution, not in bits.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import encoding, mcflash, vth_model
from repro_torch.core.mcflash import ReadPlan
from repro_torch.core.vth_model import ChipModel

__all__ = ["CalibrationResult", "calibrate", "calibrated_plan", "shift_plan"]


@dataclasses.dataclass
class CalibrationResult:
    op: str
    n_pe: float
    offsets_v: list[float]
    rber_pct: list[float]
    best_offset_v: float        # window centre (or argmin RBER if no window)
    zero_window_v: float        # width of the zero-RBER window (0 if closed)

    def __str__(self) -> str:
        return (f"{self.op.upper()} @ {self.n_pe:.0f} P/E: best offset "
                f"{self.best_offset_v:+.2f} V, zero-window "
                f"{self.zero_window_v:.2f} V")


def _moving_ref(plan: ReadPlan) -> int:
    """Index (into plan.refs) of the op-defining reference to calibrate."""
    return {"lsb": 0, "msb": 0, "sbr": 2}[plan.kind]


def shift_plan(plan: ReadPlan, offset_v: float,
               ref_idx: int | None = None) -> ReadPlan:
    """Return ``plan`` with reference(s) shifted by ``offset_v`` volts.

    With ``ref_idx=None`` every reference shifts together (common-mode) —
    the read-retry ladder's move against uniform wear drift, valid for any
    kind including multi-valley parity stacks since a uniform shift
    preserves reference monotonicity.  With an index, only that reference
    moves (the single-valley calibration sweep).
    """
    if ref_idx is None:
        refs = tuple(r + offset_v for r in plan.refs)
    else:
        refs = list(plan.refs)
        refs[ref_idx] = refs[ref_idx] + offset_v
        refs = tuple(refs)
    return ReadPlan(plan.op, plan.kind, refs,
                    plan.sensing_phases, plan.uses_inverse)


def _factory_plan(op: str, chip: ChipModel) -> ReadPlan:
    # calibration compiles outside the plan cache on purpose: it derives new
    # reference voltages, and cached plans must stay factory-exact
    return mcflash.plan_op(op, chip)   # verify: allow(bare-plan-compile)


def calibrate(op: str, chip: ChipModel, *, n_pe: float = 0.0,
              retention_hours: float = 0.0, n_bits: int = 1 << 18,
              span_v: float = 0.6, steps: int = 13, seed: int = 0,
              device: "torch.device | str | None" = None
              ) -> CalibrationResult:
    """Sweep the op's moving reference +/- ``span_v`` around the factory
    plan on a calibration page of ``n_bits`` cells, on ``device`` (the card
    unless the caller asks for the CPU)."""
    dev = torch.device("cuda" if device is None else device)
    plan = _factory_plan(op, chip)
    ref_idx = _moving_ref(plan)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    lsb = (torch.rand(n_bits, generator=gen, device=dev) < 0.5).to(torch.uint8)
    msb = (torch.rand(n_bits, generator=gen, device=dev) < 0.5).to(torch.uint8)
    if op == "not":
        lsb = torch.zeros_like(lsb)
    vth, _ = vth_model.program_page(gen, lsb, msb, chip, n_pe=n_pe,
                                    retention_hours=retention_hours)
    want = (encoding.logical_op("not", msb) if op == "not"
            else encoding.logical_op(op, lsb, msb))

    offsets = np.linspace(-span_v, span_v, steps)
    curve = []
    for off in offsets:
        got = mcflash.execute_plan(shift_plan(plan, float(off), ref_idx), vth)
        curve.append(100.0 * float(
            (got.to(torch.uint8) != want).float().mean()))

    zero = [o for o, r in zip(offsets, curve) if r == 0.0]
    if zero:
        best = float((min(zero) + max(zero)) / 2)
        window = float(max(zero) - min(zero))
    else:
        best = float(offsets[int(np.argmin(curve))])
        window = 0.0
    return CalibrationResult(op, n_pe, [float(o) for o in offsets],
                             curve, best, window)


def calibrated_plan(op: str, chip: ChipModel, *, n_pe: float = 0.0,
                    retention_hours: float = 0.0, **kw) -> ReadPlan:
    """Return the op's plan with the wear-optimal reference substituted."""
    cal = calibrate(op, chip, n_pe=n_pe, retention_hours=retention_hours, **kw)
    plan = _factory_plan(op, chip)
    idx = _moving_ref(plan)
    refs = list(plan.refs)
    refs[idx] = chip.quantize_ref(refs[idx] + cal.best_offset_v,
                                  0 if plan.kind != "lsb" else 1)
    return ReadPlan(plan.op, plan.kind, tuple(refs),
                    plan.sensing_phases, plan.uses_inverse)
