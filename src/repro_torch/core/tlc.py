"""TLC extension (paper §7 / TCFlash [47]): three-operand bitwise ops in
Tri-Level-Cell NAND, and the "reduced-MLC" robust mode.

TLC stores 3 bits/cell over 8 Vth states; three operands co-locate on the
shared LSB/CSB/MSB pages of one wordline.  Gray code:

    state  L0 L1 L2 L3 L4 L5 L6 L7
    LSB     1  1  1  1  0  0  0  0
    CSB     1  1  0  0  0  0  1  1
    MSB     1  0  0  1  1  0  0  1

- 3-operand AND = A&B&C is 1 only at L0: ONE shifted-read phase.
- 3-operand OR  = A|B|C is 0 only at L5: a 2-phase read around L5.
- Reduced-MLC mode programs only {L0, L2, L5, L7}, doubling the margins.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from repro_torch.core import encoding as _mlc_enc
from repro_torch.core.vth_model import standard_normal

# ----------------------------- encoding registry -----------------------------
MLC, TLC, REDUCED_MLC = "mlc", "tlc", "reduced-mlc"
ENCODINGS = (MLC, TLC, REDUCED_MLC)
#: shared pages per wordline (logical operands co-located on one row)
PAGES_PER_WL = {MLC: 2, TLC: 3, REDUCED_MLC: 2}
#: role names addressing the shared pages, in canonical order
ROLES_OF = {MLC: ("lsb", "msb"), TLC: ("lsb", "csb", "msb"),
            REDUCED_MLC: ("lsb", "msb")}

# (LSB, CSB, MSB) per state — valid Gray code.
TLC_LSB = (1, 1, 1, 1, 0, 0, 0, 0)
TLC_CSB = (1, 1, 0, 0, 0, 0, 1, 1)
TLC_MSB = (1, 0, 0, 1, 1, 0, 0, 1)

#: per-role logical bit per Vth-ordered state (plan compilation is host-side)
ROLE_BITS: Dict[str, Dict[str, Tuple[int, ...]]] = {
    TLC: {"lsb": TLC_LSB, "csb": TLC_CSB, "msb": TLC_MSB},
    REDUCED_MLC: {"lsb": _mlc_enc.LSB_OF_STATE, "msb": _mlc_enc.MSB_OF_STATE},
}

# (lsb, csb, msb) -> state, flattened as lsb*4 + csb*2 + msb
_STATE_OF_BITS = [0] * 8
for _s in range(8):
    _STATE_OF_BITS[TLC_LSB[_s] * 4 + TLC_CSB[_s] * 2 + TLC_MSB[_s]] = _s
_STATE_OF_BITS = tuple(_STATE_OF_BITS)


@dataclasses.dataclass(frozen=True)
class TLCChipModel:
    """8-state chip: same total window as MLC, ~half the inter-state gaps."""
    part_number: str = "TLC-176L-CT"
    # programmed states L1..L7 verify windows (L0 = erase, half-normal)
    prog_lo: Tuple[float, ...] = (0.20, 0.95, 1.70, 2.45, 3.20, 3.95, 4.70)
    prog_hi: Tuple[float, ...] = (0.55, 1.30, 2.05, 2.80, 3.55, 4.30, 5.05)
    prog_sigma: float = 0.07
    erase_hi: float = -0.5
    erase_sigma: float = 2.6
    drift_s: float = 0.17
    drift_alpha: float = 0.11

    def valley(self, lo_state: int) -> float:
        """Reference target in the (lo_state | lo_state+1) valley."""
        hi = self.erase_hi if lo_state == 0 else self.prog_hi[lo_state - 1]
        lo_next = self.prog_lo[lo_state]
        return 0.5 * (hi + lo_next)


def encode_tlc(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    idx = a.to(torch.uint8) * 4 + b.to(torch.uint8) * 2 + c.to(torch.uint8)
    return _mlc_enc.lookup(_STATE_OF_BITS, idx)


def program_tlc(gen: torch.Generator, states: torch.Tensor, chip: TLCChipModel,
                n_pe: float = 0.0) -> torch.Tensor:
    """Post-verify Vth of 8-state cells (plus cycling drift when worn)."""
    dev = states.device
    z = standard_normal(gen, states.shape, dev)
    s = states.long()
    mu = torch.tensor((0.0,) + tuple((lo + hi) / 2 for lo, hi
                                     in zip(chip.prog_lo, chip.prog_hi)),
                      dtype=torch.float32, device=dev)[s]
    lo = torch.tensor((0.0,) + chip.prog_lo, dtype=torch.float32, device=dev)[s]
    hi = torch.tensor((0.0,) + chip.prog_hi, dtype=torch.float32, device=dev)[s]
    prog = torch.minimum(torch.maximum(mu + chip.prog_sigma * z, lo), hi)
    erased = chip.erase_hi - z.abs() * chip.erase_sigma
    vth = torch.where(s == 0, erased, prog)
    if n_pe > 0:
        sigma = chip.drift_s * (n_pe / 1500.0) ** chip.drift_alpha
        vth = vth + sigma * standard_normal(gen, vth.shape, dev)
    return vth


def and3_read(vth: torch.Tensor, chip: TLCChipModel) -> torch.Tensor:
    """3-operand AND: single phase, reference in the L0|L1 valley."""
    return (vth < chip.valley(0)).to(torch.uint8)


def or3_read(vth: torch.Tensor, chip: TLCChipModel) -> torch.Tensor:
    """3-operand OR: 2-phase read bracketing L5=(0,0,0)."""
    return ((vth < chip.valley(4)) | (vth > chip.valley(5))).to(torch.uint8)


# ----------------------------- reduced-MLC mode -----------------------------

#: occupied TLC states in reduced-MLC mode, in Vth order; their bits follow
#: the MLC Gray convention: (lsb,msb) L0=(1,1) L2=(1,0) L5=(0,0) L7=(0,1)
REDUCED_STATES = (0, 2, 5, 7)
_RED_OF_BITS = {(1, 1): 0, (1, 0): 1, (0, 0): 2, (0, 1): 3}
_REDUCED_STATE_OF_BITS = tuple(REDUCED_STATES[_RED_OF_BITS[(i // 2, i % 2)]]
                               for i in range(4))


def encode_reduced(lsb: torch.Tensor, msb: torch.Tensor) -> torch.Tensor:
    idx = lsb.to(torch.uint8) * 2 + msb.to(torch.uint8)
    return _mlc_enc.lookup(_REDUCED_STATE_OF_BITS, idx)


def reduced_and_read(vth: torch.Tensor, chip: TLCChipModel) -> torch.Tensor:
    """MLC-style AND on reduced states: ref in the wide L0|L2 valley."""
    ref = 0.5 * (chip.erase_hi + chip.prog_lo[1])
    return (vth < ref).to(torch.uint8)


def reduced_or_read(vth: torch.Tensor, chip: TLCChipModel) -> torch.Tensor:
    """MLC-style OR: 1 only outside L5 (the (0,0) state)."""
    lo = 0.5 * (chip.prog_hi[1] + chip.prog_lo[4])    # L2|L5 wide valley
    hi = 0.5 * (chip.prog_hi[4] + chip.prog_lo[6])    # L5|L7 valley
    return ((vth < lo) | (vth > hi)).to(torch.uint8)


# ----------------------------- read-plan compilation -------------------------
# Any boolean function of the co-located page bits is a per-state band
# pattern over the Vth-ordered states; one reference at every valley where
# the pattern flips turns it into one parity read of len(refs) phases.

_FOLD = {"and": lambda bits: int(all(bits)),
         "or": lambda bits: int(any(bits)),
         "xor": lambda bits: sum(bits) % 2}
_BASE_OF = {"nand": "and", "nor": "or", "xnor": "xor"}


def valleys(chip: TLCChipModel, encoding: str = TLC) -> Tuple[float, ...]:
    """Inter-state reference targets, in Vth order (7 for native TLC, 3
    wide ones between the occupied states for reduced-MLC)."""
    if encoding == TLC:
        return tuple(chip.valley(i) for i in range(7))
    if encoding != REDUCED_MLC:
        raise ValueError(encoding)
    out = []
    for lo, hi in zip(REDUCED_STATES, REDUCED_STATES[1:]):
        lo_top = chip.erase_hi if lo == 0 else chip.prog_hi[lo - 1]
        out.append(0.5 * (lo_top + chip.prog_lo[hi - 1]))
    return tuple(out)


def op_pattern(op: str, roles: Tuple[str, ...], encoding: str) -> Tuple[int, ...]:
    """Per-state result bits of ``op`` ('read', 'not', or a 2-/3-operand
    bitwise op) over the given page roles, in operand order."""
    bits = ROLE_BITS[encoding]
    cols = [bits[r] for r in roles]
    if op == "read":
        (col,) = cols
        return col
    if op == "not":
        (col,) = cols
        return tuple(1 - b for b in col)
    base = _BASE_OF.get(op, op)
    fold = _FOLD[base]
    pattern = tuple(fold([c[s] for c in cols]) for s in range(len(cols[0])))
    if op in _BASE_OF:
        pattern = tuple(1 - b for b in pattern)
    return pattern


def pattern_plan(op_label: str, pattern: Tuple[int, ...], chip: TLCChipModel,
                 encoding: str):
    """Compile a band pattern into a parity :class:`ReadPlan`: references at
    every valley where the pattern flips; the inverse-read flag absorbs
    patterns that start at 0."""
    from repro_torch.core.mcflash import ReadPlan   # mcflash layers above

    vals = valleys(chip, encoding)
    if len(pattern) != len(vals) + 1 or any(b not in (0, 1) for b in pattern):
        raise ValueError(f"bad band pattern {pattern} for {encoding}")
    refs = tuple(v for v, a, b in zip(vals, pattern, pattern[1:]) if a != b)
    if not refs:
        # constant pattern: one reference above the window puts every cell
        # in band 0
        refs = (chip.prog_hi[-1] + 1.0,)
    assert all(a < b for a, b in zip(refs, refs[1:])), refs
    return ReadPlan(op_label, "parity", refs, len(refs),
                    uses_inverse=(pattern[0] == 0))


def plan_encoded(op: str, roles: Tuple[str, ...], chip: TLCChipModel,
                 encoding: str):
    """Read plan for ``op`` over co-located operands stored in ``roles``."""
    label = f"{encoding}:{op}:" + "+".join(roles)
    return pattern_plan(label, op_pattern(op, roles, encoding), chip, encoding)


def encode_states(encoding: str, pages: Tuple[torch.Tensor, ...]) -> torch.Tensor:
    """Map the shared pages of one wordline (role order) to Vth state ids."""
    if encoding == TLC:
        lsb, csb, msb = pages
        return encode_tlc(lsb, csb, msb)
    if encoding != REDUCED_MLC:
        raise ValueError(encoding)
    lsb, msb = pages
    return encode_reduced(lsb, msb)
