"""Energy model (paper §5.5-5.6, Fig 8c).

Read energy per kB = E_fixed (pre-charge + discharge) + N_phases x E_sense.
Calibrated so XNOR (4 phases) consumes ~51% more than AND (1 phase):
  (E_f + 4 E_s) = 1.51 (E_f + E_s)  =>  E_f = (2.49/0.51) E_s ≈ 4.88 E_s.
Program (copyback realignment) dominates incremental cost at ~12x the AND
read energy per kB.  Flash-Cosmos multi-block MWS adds ~34% per extra
activated block (§5.6).
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.encoding import OP_SENSING_PHASES


@dataclasses.dataclass(frozen=True)
class EnergyModel:
    e_sense_uj_kb: float = 0.17
    e_fixed_uj_kb: float = 0.83       # ≈ 4.88 x e_sense
    e_prog_uj_kb: float = 12.0
    mws_extra_per_block: float = 0.34  # Flash-Cosmos inter-block overhead

    def read_energy_uj_kb(self, op: str, phases: int | None = None) -> float:
        """Per-kB read energy; ``phases`` overrides the MLC Table-1 lookup
        for multi-level-encoding plans that carry their own phase count."""
        if phases is None:
            phases = OP_SENSING_PHASES[op]
        return self.e_fixed_uj_kb + phases * self.e_sense_uj_kb

    def mcflash_op_energy_uj_kb(self, op: str, aligned: bool = True) -> float:
        e = self.read_energy_uj_kb(op)
        if not aligned:
            # two source reads + copyback program + the op read
            e += 2 * self.read_energy_uj_kb("or") + self.e_prog_uj_kb
        return e

    def flash_cosmos_energy_uj_kb(self, op: str, n_operands: int = 2) -> float:
        """MWS single sensing across operands; inter-block activation overhead."""
        base = self.read_energy_uj_kb("and")
        if op in ("or", "nor"):
            # OR/NOR need inter-block MWS: +34% per extra block.
            return base * (1.0 + self.mws_extra_per_block * max(n_operands - 1, 0))
        if op in ("xor", "xnor"):
            # inter-latch XOR: 6-8 sensing/latching steps (§5.6)
            return self.e_fixed_uj_kb + 7 * self.e_sense_uj_kb
        return base

    def parabit_energy_uj_kb(self, op: str) -> float:
        """ParaBit: single-block latch sequencing; XOR needs 6-8 latch steps."""
        if op in ("xor", "xnor"):
            return self.e_fixed_uj_kb + 7 * self.e_sense_uj_kb
        return self.read_energy_uj_kb("and")
