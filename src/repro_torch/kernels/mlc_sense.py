"""Sense + pack: R float32 Vth rows -> (R, C // 32) packed int32 words.

CUDA kernel: ``csrc/mlc_sense.cu``.  It replaces the Pallas kernel
``src/repro/kernels/mlc_sense.py:mlc_sense`` (``_sense_kernel``).  Bound by
memory: each cell's 4 B of Vth is read once and 1/8 B written, so the least
time is ``R * C * (4 + 1/8) B`` over the card's memory rate.  One thread per
output word reads its 32 cells, which sit 128 columns apart, so neighbouring
threads read neighbouring floats and every load coalesces; the read
references travel by value, as the Pallas kernel's scalar prefetch did.

The rows are read where they live, through slot tables (:class:`Rows`: an
arena shard's buffer per table, up to ``cuda.MAX_TABLES`` tables a launch,
more in several launches); a dense (R, C) tensor is one base with the
identity table.  Rows need no padding.

On the CPU the wrapper runs :data:`reference`, the plain version, on the
rows gathered by their tables.
"""
from __future__ import annotations

from itertools import accumulate
from typing import Sequence, Union

import torch

from repro_torch.kernels import cuda, ref
from repro_torch.kernels.ref import TILE_COLS, WORD_BITS
from repro_torch.kernels.rows import Rows, identity

#: the plain PyTorch version of this kernel
reference = ref.mlc_sense


def mlc_sense(vth: Union[torch.Tensor, Rows], refs: Sequence[float], *,
              kind: str, invert: bool = False, n_refs: int = 0) -> torch.Tensor:
    """Sense R Vth rows with one read kind -> (R, C // 32) int32 words:
    a dense (R, C) tensor, or :class:`Rows` read through their tables in
    order.  ``n_refs`` is used by kind='parity' only."""
    c = vth.shape[1] if isinstance(vth, torch.Tensor) else vth.cols
    if c % TILE_COLS:
        raise ValueError(f"cols {c} must be a multiple of {TILE_COLS}")
    if vth.device.type == "cpu":
        dense = vth if isinstance(vth, torch.Tensor) else vth.gather()
        return reference(dense, list(refs), kind, invert=invert,
                         n_refs=n_refs or None)
    if isinstance(vth, torch.Tensor):
        vth = identity(cuda.check_cuda("vth", vth, torch.float32))
    words = c // WORD_BITS
    out = torch.empty((vth.n_rows, words), dtype=torch.int32,
                      device=vth.device)
    if out.shape[0]:
        kind_code, n_refs, refs_c = cuda.sense_args(refs, kind, n_refs)
        dst, cap = out.data_ptr(), cuda.MAX_TABLES
        for s in range(0, len(vth), cap):
            part = vth if len(vth) <= cap else vth[s:s + cap]
            ends = list(accumulate(int(t.shape[0]) for t in part.slots))
            if ends[-1]:
                bases, slots = cuda.table_args(part)
                cuda.launch("mlc_sense", "mcf_mlc_sense", bases, slots,
                            cuda.TableEnds(*ends), len(part), dst, ends[-1],
                            c, kind_code, n_refs, int(invert), refs_c)
            dst += ends[-1] * words * 4        # int32 words
    return out
