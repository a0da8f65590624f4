"""Sensing primitives: hard read, shifted read, SBR, inverse read (paper §4.1).

The per-cell reference semantics (uint8 bits out); the packed high-volume
forms are the kernels in :mod:`repro_torch.kernels`.
"""
from __future__ import annotations

import torch


def lsb_read(vth: torch.Tensor, vref1: float) -> torch.Tensor:
    """LSB page read: one sensing phase.  bit = (vth < VREF1)."""
    return (vth < vref1).to(torch.uint8)


def msb_read(vth: torch.Tensor, vref0: float, vref2: float) -> torch.Tensor:
    """MSB page read: two phases.  bit = (vth < VREF0) | (vth > VREF2)."""
    return ((vth < vref0) | (vth > vref2)).to(torch.uint8)


def soft_bit_read(vth: torch.Tensor, neg_refs: tuple[float, float],
                  pos_refs: tuple[float, float]) -> torch.Tensor:
    """SBR: chip-internal XNOR of two MSB-style reads (paper Fig 3b)."""
    neg = msb_read(vth, *neg_refs)
    pos = msb_read(vth, *pos_refs)
    return 1 - (neg ^ pos)


def inverse_read(bits: torch.Tensor) -> torch.Tensor:
    """Inverse read: the chip returns the complemented page buffer."""
    return 1 - bits.to(torch.uint8)


def parity_read(vth: torch.Tensor, refs: tuple[float, ...]) -> torch.Tensor:
    """Multi-reference read (TLC / 8-state encodings, §7): bit = 1 iff an
    even number of references lie below the cell's Vth."""
    if not refs:
        raise ValueError("parity read needs at least one reference")
    odd = vth > refs[0]
    for r in refs[1:]:
        odd = odd ^ (vth > r)
    return 1 - odd.to(torch.uint8)
