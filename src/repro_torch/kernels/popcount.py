"""Per-row popcount, optionally masked: (R, W) int32 words -> (R,) int32.

CUDA kernel: ``csrc/popcount.cu``.  It replaces the Pallas kernel
``src/repro/kernels/popcount.py:popcount_rows`` (``_popcount_kernel``).
Bound by memory: each word's 4 B (and each mask word's) is read once.  With
a mask the kernel counts ``words & mask``, so a root count needs no
separate AND pass.  Blocks stride 16-byte loads over their row and count
with the hardware ``__popc`` (in place of the SWAR arithmetic); each block
adds its sum to the row with one atomic, where the Pallas kernel carried
lane partials along its sequential grid.  The C entry zeroes the counts on
the same stream before the kernel, so a call is one entry and no
``torch.zeros``.  Any R and W are taken.

On a CPU tensor the wrapper runs :data:`reference`, the plain version.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import cuda, ref

#: the plain PyTorch version of this kernel
reference = ref.popcount_rows


def popcount_rows(words: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(R, W) words -> (R,) int32 row popcounts of ``words`` (``& mask``
    where an (R, W) mask is given)."""
    r, w = words.shape
    if mask is not None and mask.shape != words.shape:
        raise ValueError(f"mask shape {tuple(mask.shape)} != "
                         f"{tuple(words.shape)}")
    if words.is_cpu:
        return reference(words, mask)
    words = cuda.check_cuda("words", words, torch.int32)
    if mask is not None:            # held here until the launch
        mask = cuda.check_cuda("mask", mask, torch.int32)
    if not r * w:
        return torch.zeros((r,), dtype=torch.int32, device=words.device)
    out = torch.empty((r,), dtype=torch.int32, device=words.device)
    cuda.launch("popcount_rows", "mcf_popcount_rows", words.data_ptr(),
                None if mask is None else mask.data_ptr(), out.data_ptr(),
                r, w)
    return out
