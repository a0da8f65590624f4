"""Plain reference for range predicates over bit-sliced integer columns.

Each code is rebuilt as an int64 from its slices' bits (most significant
slice first) and ``lo <= v <= hi`` is counted directly: the answer
:meth:`repro_torch.api.session.ComputeSession.between` is held to.  Plain
``torch``; it imports nothing else of the port.
"""
from __future__ import annotations

from typing import Sequence

import torch


def codes(slices: Sequence[torch.Tensor]) -> torch.Tensor:
    """(n,) int64 codes from b (n,) {0, 1} slices, most significant first."""
    if not 1 <= len(slices) <= 62:
        raise ValueError(f"{len(slices)} slices do not fit an int64 code")
    v = torch.zeros_like(slices[0], dtype=torch.int64)
    for bits in slices:
        v <<= 1
        v |= bits.to(torch.int64)
    return v


def count(v: torch.Tensor, lo: int, hi: int) -> int:
    """Rows with ``lo <= v <= hi``."""
    return int(((v >= int(lo)) & (v <= int(hi))).sum(dtype=torch.int64))
