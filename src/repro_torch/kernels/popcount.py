"""Per-row popcount: (R, W) int32 words -> (R,) int32.

CUDA kernel: ``csrc/popcount.cu``.  It replaces the Pallas kernel
``src/repro/kernels/popcount.py:popcount_rows`` (``_popcount_kernel``).
Bound by memory: each word's 4 B is read once.  Each thread counts 8 words
of a row with the hardware ``__popc`` (in place of the SWAR arithmetic) and
each block adds its sum to the row with one atomic, where the Pallas kernel
carried lane partials along its sequential grid.  Any R and W are taken.

On a CPU tensor the wrapper runs :data:`reference`, the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import cuda, ref

#: the plain PyTorch version of this kernel
reference = ref.popcount_rows


def popcount_rows(words: torch.Tensor) -> torch.Tensor:
    """(R, W) words -> (R,) int32 row popcounts."""
    r, w = words.shape
    if words.device.type == "cpu":
        return reference(words)
    words = cuda.check_cuda("words", words, torch.int32)
    out = torch.zeros((r,), dtype=torch.int32, device=words.device)
    if r * w:
        cuda.launch("popcount_rows", "mcf_popcount_rows", words.data_ptr(),
                    out.data_ptr(), r, w)
    return out
