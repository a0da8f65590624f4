"""Fused sense -> reduce (-> masked popcount) over N same-plan operands.

CUDA kernels: ``csrc/fused.cu``.  :func:`sense_reduce` replaces the Pallas
kernel ``src/repro/kernels/fused.py:sense_reduce``
(``_sense_reduce_kernel``); :func:`sense_reduce_popcount` replaces
``:sense_reduce_popcount`` (``_sense_reduce_popcount_kernel``).

Both are bound by memory: every operand cell's 4 B of Vth is read once;
``sense_reduce`` writes 1/8 B per output cell, the popcount form reads the
(R, C // 32) mask and writes 4 B per row.  One thread per output word senses
its word in each of the N operands and folds the words in a register, so no
partial goes to device memory, as in the Pallas megakernels.  The popcount
form sums each block's counts and adds them to the row with one atomic:
Hopper's blocks run in no order, so this replaces the Pallas kernel's
accumulator carried along its sequential grid.  The Pallas column tiling
(``_auto_col_tiles``) was a VMEM heuristic and has no counterpart here.

On CPU tensors the wrappers run the plain versions, :data:`reference` and
:data:`reference_popcount`.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.kernels import cuda, ref
from repro_torch.kernels.ref import TILE_COLS, WORD_BITS

#: the plain PyTorch versions of these kernels
reference = ref.sense_reduce
reference_popcount = ref.sense_reduce_popcount


def _check_shape(vth: torch.Tensor) -> tuple[int, int, int]:
    n, r, c = vth.shape
    if n < 1:
        raise ValueError("need at least one operand")
    if c % TILE_COLS:
        raise ValueError(f"cols {c} must be a multiple of {TILE_COLS}")
    return n, r, c


def sense_reduce(vth: torch.Tensor, refs: Sequence[float], *, kind: str,
                 sense_invert: bool, op: str, invert: bool = False,
                 n_refs: int = 0) -> torch.Tensor:
    """(N, R, C) Vth -> (R, C // 32) int32 words of the folded senses."""
    n, r, c = _check_shape(vth)
    if vth.device.type == "cpu":
        return reference(vth, list(refs), kind, sense_invert, op, invert,
                         n_refs=n_refs or None)
    vth = cuda.check_cuda("vth", vth, torch.float32)
    out = torch.empty((r, c // WORD_BITS), dtype=torch.int32, device=vth.device)
    if r:
        kind_code, n_refs, refs_c = cuda.sense_args(refs, kind, n_refs)
        cuda.launch("sense_reduce", "mcf_sense_reduce", vth.data_ptr(),
                    out.data_ptr(), n, r, c, kind_code, n_refs,
                    int(sense_invert), cuda.OP_CODE[op], int(invert), refs_c)
    return out


def sense_reduce_popcount(vth: torch.Tensor, refs: Sequence[float],
                          mask: torch.Tensor, *, kind: str, sense_invert: bool,
                          op: str, invert: bool = False,
                          n_refs: int = 0) -> torch.Tensor:
    """(N, R, C) Vth + (R, C // 32) mask -> (R,) int32 bit counts."""
    n, r, c = _check_shape(vth)
    if tuple(mask.shape) != (r, c // WORD_BITS):
        raise ValueError(f"mask shape {tuple(mask.shape)} != {(r, c // WORD_BITS)}")
    if vth.device.type == "cpu":
        return reference_popcount(vth, list(refs), mask, kind, sense_invert,
                                  op, invert, n_refs=n_refs or None)
    vth = cuda.check_cuda("vth", vth, torch.float32)
    mask = cuda.check_cuda("mask", mask, torch.int32)
    out = torch.zeros((r,), dtype=torch.int32, device=vth.device)
    if r:
        kind_code, n_refs, refs_c = cuda.sense_args(refs, kind, n_refs)
        cuda.launch("sense_reduce_popcount", "mcf_sense_reduce_popcount",
                    vth.data_ptr(), mask.data_ptr(), out.data_ptr(), n, r, c,
                    kind_code, n_refs, int(sense_invert), cuda.OP_CODE[op],
                    int(invert), refs_c)
    return out
