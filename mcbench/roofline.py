"""Peaks of the card and the sizes the byte counts are made of.

The work is counted from shapes in the harness (each query kind's
``bytes_needed``), not read from the program, so a roofline share reads the
same whatever kernels implement the query: each operand wordline's float32
Vth row read once, plus the result written once.
"""
from __future__ import annotations

#: NVIDIA H100 SXM data sheet: HBM3 bandwidth at the full 700 W limit
HBM_BYTES_PER_S = 3.35e12
#: bytes of one Vth cell (float32) and of one count (int32)
VTH_BYTES = 4
COUNT_BYTES = 4

