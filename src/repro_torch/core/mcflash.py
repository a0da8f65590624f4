"""MCFlash op engine: Table-1 read-offset planning + execution.

Each bitwise op compiles into a :class:`ReadPlan`: the quantized,
range-clamped read references and the sensing mechanism, as in paper
Table 1:

=====  =========================================  ==============
op     mechanism                                  sensing phases
=====  =========================================  ==============
AND    LSB read, VREF1 -> L0|L1 valley                   1
OR     MSB read, VREF0 -> L1|L2 valley                   2
NOT    MSB read, VREF0 -> L2|L3 valley, VREF2 -> >L3     2
XNOR   SBR: neg = default MSB, pos = LSB-mimic           4
NAND   inverse-read(AND)  | direct: VREF0 -> <L0         1 | 2
NOR    inverse-read(OR)   | direct SBR w/ VREF0 -> <L0   2 | 4
XOR    inverse-read(XNOR) | direct SBR w/ VREF0 -> <L0   4 | 4
=====  =========================================  ==============

Planning is host-side Python float arithmetic, so the plans are
float-equal to the JAX package's.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.core import encoding, sensing
from repro_torch.core.vth_model import ChipModel


@dataclasses.dataclass(frozen=True)
class ReadPlan:
    op: str
    kind: str                      # 'lsb' | 'msb' | 'sbr' | 'parity'
    refs: Tuple[float, ...]        # quantized absolute reference voltages
    sensing_phases: int
    uses_inverse: bool = False     # apply chip inverse-read to the result

    def describe(self) -> str:
        refs = ", ".join(f"{r:+.2f}V" for r in self.refs)
        inv = " +inverse-read" if self.uses_inverse else ""
        return f"{self.op.upper():5s} [{self.kind}{inv}] refs=({refs}) phases={self.sensing_phases}"


def _targets(chip: ChipModel) -> dict[str, float]:
    """Absolute reference-voltage targets derived from the state geometry."""
    v0, v1, v2 = chip.vref_default
    margin = v2 - chip.prog_hi[1]              # valley half-width above L2
    return {
        "P01": v0,                             # L0|L1 valley (default VREF0)
        "P12": v1,                             # L1|L2 valley (default VREF1)
        "P23": v2,                             # L2|L3 valley (default VREF2)
        "P3p": chip.prog_hi[2] + margin,       # above L3
        "P0m": chip.erase_hi - 4.0 * chip.erase_sigma,  # below L0 (unreachable)
    }


def plan_op(op: str, chip: ChipModel, use_inverse_read: bool = True) -> ReadPlan:
    """Compile an op into quantized read references (Table 1)."""
    t = _targets(chip)
    q = chip.quantize_ref

    if op == "and":
        return ReadPlan(op, "lsb", (q(t["P01"], 1),), 1)
    if op == "or":
        return ReadPlan(op, "msb", (q(t["P12"], 0), q(t["P23"], 2)), 2)
    if op == "not":
        return ReadPlan(op, "msb", (q(t["P23"], 0), q(t["P3p"], 2)), 2)
    if op == "xnor":
        return ReadPlan(op, "sbr",
                        (q(t["P01"], 0), q(t["P23"], 2),      # negative sensing
                         q(t["P12"], 0), q(t["P3p"], 2)),     # positive sensing
                        4)
    if op in ("nand", "nor", "xor"):
        if use_inverse_read:
            base = {"nand": "and", "nor": "or", "xor": "xnor"}[op]
            p = plan_op(base, chip)
            return ReadPlan(op, p.kind, p.refs, p.sensing_phases, uses_inverse=True)
        # Direct variants: require VREF0 below L0 -> clamps at the DAC range.
        if op == "nand":
            return ReadPlan(op, "msb", (q(t["P0m"], 0), q(t["P01"], 2)), 2)
        if op == "nor":
            return ReadPlan(op, "sbr",
                            (q(t["P0m"], 0), q(t["P23"], 2),
                             q(t["P12"], 0), q(t["P3p"], 2)), 4)
        return ReadPlan(op, "sbr",
                        (q(t["P0m"], 0), q(t["P12"], 2),
                         q(t["P01"], 0), q(t["P23"], 2)), 4)
    raise ValueError(f"unknown op {op!r}")


def execute_plan(plan: ReadPlan, vth: torch.Tensor) -> torch.Tensor:
    """Run the sensing sequence of a plan on a Vth tensor -> result bits."""
    if plan.kind == "lsb":
        bits = sensing.lsb_read(vth, plan.refs[0])
    elif plan.kind == "msb":
        bits = sensing.msb_read(vth, plan.refs[0], plan.refs[1])
    elif plan.kind == "sbr":
        bits = sensing.soft_bit_read(vth, plan.refs[0:2], plan.refs[2:4])
    elif plan.kind == "parity":
        bits = sensing.parity_read(vth, plan.refs)
    else:
        raise ValueError(plan.kind)
    if plan.uses_inverse:
        bits = sensing.inverse_read(bits)
    return bits


def expected_result(op: str, lsb_bits: torch.Tensor,
                    msb_bits: torch.Tensor) -> torch.Tensor:
    """Logical oracle over the stored operands (A=LSB page, B=MSB page)."""
    if op == "not":
        return encoding.logical_op("not", msb_bits)
    return encoding.logical_op(op, lsb_bits, msb_bits)
