"""Sense + pack: (R, C) float32 Vth -> (R, C // 32) packed int32 words.

CUDA kernel: ``csrc/mlc_sense.cu``.  It replaces the Pallas kernel
``src/repro/kernels/mlc_sense.py:mlc_sense`` (``_sense_kernel``).  Bound by
memory: each cell's 4 B of Vth is read once and 1/8 B written, so the least
time is ``R * C * (4 + 1/8) B`` over the card's memory rate.  One thread per
output word reads its 32 cells, which sit 128 columns apart, so neighbouring
threads read neighbouring floats and every load coalesces; the read
references travel by value, as the Pallas kernel's scalar prefetch did.
Rows need no padding.

On a CPU tensor the wrapper runs :data:`reference`, the plain version.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.kernels import cuda, ref
from repro_torch.kernels.ref import TILE_COLS, WORD_BITS

#: the plain PyTorch version of this kernel
reference = ref.mlc_sense


def mlc_sense(vth: torch.Tensor, refs: Sequence[float], *, kind: str,
              invert: bool = False, n_refs: int = 0) -> torch.Tensor:
    """Sense (R, C) Vth with one read kind -> (R, C // 32) int32 words.
    ``n_refs`` is used by kind='parity' only."""
    r, c = vth.shape
    if c % TILE_COLS:
        raise ValueError(f"cols {c} must be a multiple of {TILE_COLS}")
    if vth.device.type == "cpu":
        return reference(vth, list(refs), kind, invert=invert,
                         n_refs=n_refs or None)
    vth = cuda.check_cuda("vth", vth, torch.float32)
    out = torch.empty((r, c // WORD_BITS), dtype=torch.int32, device=vth.device)
    if r:
        kind_code, n_refs, refs_c = cuda.sense_args(refs, kind, n_refs)
        cuda.launch("mlc_sense", "mcf_mlc_sense", vth.data_ptr(),
                    out.data_ptr(), r, c, kind_code, n_refs, int(invert),
                    refs_c)
    return out
