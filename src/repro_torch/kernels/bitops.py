"""Packed multi-operand chain: (N, R, W) int32 words -> (R, W).

CUDA kernel: ``csrc/bitops.cu``.  It replaces the Pallas kernel
``src/repro/kernels/bitops.py:bitwise_reduce`` (``_chain_kernel``).  Bound
by memory: each operand word is read once and each output word written
once, ``(N + 1) * R * W * 4 B``.  One thread per output word folds the N
operands in a register.  Any R and W are taken as they are (no padding).

On a CPU tensor the wrapper runs :data:`reference`, the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import cuda, ref

#: the plain PyTorch version of this kernel
reference = ref.bitwise_reduce


def bitwise_reduce(stack: torch.Tensor, *, op: str,
                   invert: bool = False) -> torch.Tensor:
    """Fold (N, R, W) words with and/or/xor, optional final NOT -> (R, W)."""
    n, r, w = stack.shape
    if n < 1:
        raise ValueError("need at least one operand")
    if stack.device.type == "cpu":
        return reference(stack, op, invert)
    stack = cuda.check_cuda("stack", stack, torch.int32)
    out = torch.empty((r, w), dtype=torch.int32, device=stack.device)
    if r * w:
        cuda.launch("bitwise_reduce", "mcf_bitwise_reduce", stack.data_ptr(),
                    out.data_ptr(), n, r, w, cuda.OP_CODE[op], int(invert))
    return out
