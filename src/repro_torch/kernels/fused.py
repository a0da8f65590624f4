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

Each operand's R rows are read where they live, through its slot table
(:class:`Rows`, one table per operand, at most ``cuda.MAX_TABLES``
operands, the executor's ``MAX_FUSED_OPERANDS``); a dense (N, R, C) stack
is one base with the identity table.

On the CPU the wrappers run the plain versions, :data:`reference` and
:data:`reference_popcount`, on the rows gathered by their tables.
"""
from __future__ import annotations

from typing import Sequence, Union

import torch

from repro_torch.kernels import cuda, ref
from repro_torch.kernels.ref import TILE_COLS, WORD_BITS
from repro_torch.kernels.rows import Rows, identity

#: the plain PyTorch versions of these kernels
reference = ref.sense_reduce
reference_popcount = ref.sense_reduce_popcount

Operands = Union[torch.Tensor, Rows]


def _check_shape(vth: Operands) -> tuple[int, int, int]:
    if isinstance(vth, torch.Tensor):
        n, r, c = vth.shape
    else:
        n, c = len(vth), vth.cols
        r = int(vth.slots[0].shape[0])
        if any(int(t.shape[0]) != r for t in vth.slots):
            raise ValueError("operands' slot tables differ in length")
    if n < 1:
        raise ValueError("need at least one operand")
    if c % TILE_COLS:
        raise ValueError(f"cols {c} must be a multiple of {TILE_COLS}")
    return n, r, c


def _dense(vth: Operands, n: int, r: int, c: int) -> torch.Tensor:
    """The (N, R, C) stack the plain versions sense."""
    return vth if isinstance(vth, torch.Tensor) else vth.gather().reshape(n, r, c)


def _tables(vth: Operands, n: int):
    """Base and slot-table pointers of N operands on the card."""
    if n > cuda.MAX_TABLES:
        raise ValueError(f"{n} operands: one launch takes at most "
                         f"{cuda.MAX_TABLES}; fold wider chains in passes")
    if isinstance(vth, torch.Tensor):
        vth = identity(cuda.check_cuda("vth", vth, torch.float32))
    return cuda.table_args(vth)


def sense_reduce(vth: Operands, refs: Sequence[float], *, kind: str,
                 sense_invert: bool, op: str, invert: bool = False,
                 n_refs: int = 0) -> torch.Tensor:
    """N operands of R Vth rows ((N, R, C) or :class:`Rows`) -> (R, C // 32)
    int32 words of the folded senses."""
    n, r, c = _check_shape(vth)
    if vth.device.type == "cpu":
        return reference(_dense(vth, n, r, c), list(refs), kind, sense_invert,
                         op, invert, n_refs=n_refs or None)
    bases, slots = _tables(vth, n)
    out = torch.empty((r, c // WORD_BITS), dtype=torch.int32, device=vth.device)
    if r:
        kind_code, n_refs, refs_c = cuda.sense_args(refs, kind, n_refs)
        cuda.launch("sense_reduce", "mcf_sense_reduce", bases, slots, n,
                    out.data_ptr(), r, c, kind_code, n_refs,
                    int(sense_invert), cuda.OP_CODE[op], int(invert), refs_c)
    return out


def sense_reduce_popcount(vth: Operands, refs: Sequence[float],
                          mask: torch.Tensor, *, kind: str, sense_invert: bool,
                          op: str, invert: bool = False,
                          n_refs: int = 0) -> torch.Tensor:
    """N operands of R Vth rows + (R, C // 32) mask -> (R,) int32 bit
    counts."""
    n, r, c = _check_shape(vth)
    if tuple(mask.shape) != (r, c // WORD_BITS):
        raise ValueError(f"mask shape {tuple(mask.shape)} != {(r, c // WORD_BITS)}")
    if vth.device.type == "cpu":
        return reference_popcount(_dense(vth, n, r, c), list(refs), mask, kind,
                                  sense_invert, op, invert,
                                  n_refs=n_refs or None)
    bases, slots = _tables(vth, n)
    mask = cuda.check_cuda("mask", mask, torch.int32)
    out = torch.zeros((r,), dtype=torch.int32, device=vth.device)
    if r:
        kind_code, n_refs, refs_c = cuda.sense_args(refs, kind, n_refs)
        cuda.launch("sense_reduce_popcount", "mcf_sense_reduce_popcount",
                    bases, slots, n, mask.data_ptr(), out.data_ptr(), r, c,
                    kind_code, n_refs, int(sense_invert), cuda.OP_CODE[op],
                    int(invert), refs_c)
    return out
