"""MLC logical data encoding (paper §2.2, Fig 2).

MLC NAND stores two bits per cell across four threshold-voltage states
L0..L3, Gray coded so adjacent states differ in one bit:

    state   L0   L1   L2   L3
    LSB      1    1    0    0
    MSB      1    0    0    1

The LSB page reads with one reference V_REF1 (between L1 and L2); the MSB
page with V_REF0 (L0|L1) and V_REF2 (L2|L3):
``msb = (vth < V_REF0) | (vth > V_REF2)``.
"""
from __future__ import annotations

import torch

# State indices.
L0, L1, L2, L3 = 0, 1, 2, 3

# Per-state logical bits, Gray coded (index = state).
LSB_OF_STATE = (1, 1, 0, 0)
MSB_OF_STATE = (1, 0, 0, 1)

# (lsb, msb) -> state, flattened as lsb*2 + msb.
# (0,0)->L2  (0,1)->L3  (1,0)->L1  (1,1)->L0
_STATE_OF_BITS = (L2, L3, L1, L0)

# Expected read result per state for every MCFlash op (paper Fig 4 + Table
# 1): op -> (r(L0), r(L1), r(L2), r(L3)).  NOT is defined on L2/L3 only.
OP_TRUTH = {
    "and":  (1, 0, 0, 0),
    "or":   (1, 1, 0, 1),
    "xnor": (1, 0, 1, 0),
    "not":  (0, 0, 1, 0),
    "nand": (0, 1, 1, 1),
    "nor":  (0, 0, 1, 0),
    "xor":  (0, 1, 0, 1),
}

# Sensing phases per op (paper §5.5); inverse-read variants cost the same.
OP_SENSING_PHASES = {
    "and": 1, "or": 2, "not": 2, "xnor": 4,
    "nand": 1, "nor": 2, "xor": 4,
}

TWO_OPERAND_OPS = ("and", "or", "xnor", "nand", "nor", "xor")
ALL_OPS = TWO_OPERAND_OPS + ("not",)


def lookup(table, index: torch.Tensor) -> torch.Tensor:
    """Index a small per-state table with a tensor of state ids (uint8 out)."""
    t = torch.tensor(table, dtype=torch.uint8, device=index.device)
    return t[index.long()]


def encode_mlc(lsb_bits: torch.Tensor, msb_bits: torch.Tensor) -> torch.Tensor:
    """Per-cell (LSB, MSB) bits -> MLC state index (uint8 in [0, 4))."""
    idx = lsb_bits.to(torch.uint8) * 2 + msb_bits.to(torch.uint8)
    return lookup(_STATE_OF_BITS, idx)


def decode_lsb(states: torch.Tensor) -> torch.Tensor:
    """MLC state index -> its LSB page bit (uint8)."""
    return lookup(LSB_OF_STATE, states)


def decode_msb(states: torch.Tensor) -> torch.Tensor:
    """MLC state index -> its MSB page bit (uint8)."""
    return lookup(MSB_OF_STATE, states)


def logical_op(op: str, a: torch.Tensor,
               b: "torch.Tensor | None" = None) -> torch.Tensor:
    """Bit-level oracle for an MCFlash op on uint8/bool bit tensors."""
    a = a.to(torch.uint8)
    if op == "not":
        return 1 - a
    if b is None:
        raise ValueError(f"op {op!r} needs two operands")
    b = b.to(torch.uint8)
    if op == "and":
        return a & b
    if op == "or":
        return a | b
    if op == "xor":
        return a ^ b
    if op == "xnor":
        return 1 - (a ^ b)
    if op == "nand":
        return 1 - (a & b)
    if op == "nor":
        return 1 - (a | b)
    raise ValueError(f"unknown op {op!r}")


def expected_read(op: str, states: torch.Tensor) -> torch.Tensor:
    """Expected MCFlash read result per cell given stored states."""
    return lookup(OP_TRUTH[op], states)
