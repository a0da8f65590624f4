"""Packed multi-operand chain: N same-shape int32 word tensors -> their
and/or/xor fold, optional final NOT.

CUDA kernel: ``csrc/bitops.cu``.  It replaces the Pallas kernel
``src/repro/kernels/bitops.py:bitwise_reduce`` (``_chain_kernel``).  Bound
by memory: each operand word is read once and each output word written
once, ``(N + 1) * plane * 4 B``.  The operands go to the kernel as
pointers, so a caller folds separate tensors (the executor's partials, a
checkpoint leaf and its delta) without stacking them first; up to
``cuda.MAX_OPERANDS`` fold in one launch, a wider fold runs in passes that
accumulate in the output.  Aligned planes fold with 16-byte loads.

On a CPU tensor the wrapper runs :data:`reference`, the plain version.
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

from repro_torch.kernels import cuda, ref

#: the plain PyTorch version of this kernel
reference = ref.bitwise_reduce

Operands = Union[torch.Tensor, Sequence[torch.Tensor]]


def bitwise_reduce(operands: Operands, *, op: str, invert: bool = False,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fold N operands with and/or/xor, optional final NOT.

    ``operands`` is a sequence of N int32 tensors of one shape, or an
    (N, ...) stack, which is unbound into N views (no copy).  Returns a
    tensor of the operands' shape, or ``out`` (of that shape, contiguous
    int32, overlapping no operand) filled with the result.
    """
    ops = operands.unbind(0) if isinstance(operands, torch.Tensor) else operands
    n = len(ops)
    if n < 1:
        raise ValueError("need at least one operand")
    shape = ops[0].shape
    for t in ops:
        if t.shape != shape:
            raise ValueError(f"operand shapes differ: {tuple(t.shape)} vs "
                             f"{tuple(shape)}")
    if out is not None and out.shape != shape:
        raise ValueError(f"out shape {tuple(out.shape)} != {tuple(shape)}")
    if ops[0].is_cpu:
        return reference(ops, op, invert, out=out)
    code = cuda.OP_CODE[op]
    # the checked tensors (a copy where one was strided) live until launch
    ops = [cuda.check_cuda("operand", t, torch.int32) for t in ops]
    ptrs = [t.data_ptr() for t in ops]
    if out is None:                 # contiguous int32, as ops[0] now is
        out = torch.empty_like(ops[0])
    elif not (out.is_cuda and out.dtype == torch.int32 and out.is_contiguous()):
        raise ValueError("out must be a contiguous int32 CUDA tensor")
    plane = out.numel()
    if plane:
        dst = out.data_ptr()
        cap = cuda.MAX_OPERANDS
        done = min(n, cap)
        cuda.launch("bitwise_reduce", "mcf_bitwise_reduce",
                    cuda.Pointers(*ptrs[:done]), done, dst, plane, code,
                    int(invert and done == n))
        while done < n:             # passes of cap - 1 more, into ``out``
            part = ptrs[done:done + cap - 1]
            done += len(part)
            cuda.launch("bitwise_reduce", "mcf_bitwise_reduce",
                        cuda.Pointers(dst, *part), len(part) + 1, dst, plane,
                        code, int(invert and done == n))
    return out
