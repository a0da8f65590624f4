"""The kernels' entry points as the backends call them.

The JAX package padded rows to the TPU's 8-row tile here; the CUDA kernels
take any row count, so the sense entry points only unpack a
:class:`ReadPlan` into the kernels' arguments.  Their Vth is a dense tensor
or :class:`~repro_torch.kernels.rows.Rows` (rows read in place through slot
tables).  Each call launches the CUDA kernel for CUDA tensors and runs the
plain version for CPU tensors.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import fused as _fused
from repro_torch.kernels import mlc_sense as _mlc
from repro_torch.kernels.bitops import bitwise_reduce
from repro_torch.kernels.fused import Operands
from repro_torch.kernels.popcount import popcount_rows

__all__ = ["MULTI_KINDS", "sense_plan", "sense_multi_plan", "sense_drain_plan",
           "sense_popcount_plan", "sense_reduce_plan",
           "sense_reduce_popcount_plan", "bitwise_reduce", "popcount_rows"]

#: read kinds :func:`sense_multi_plan` takes
MULTI_KINDS = _mlc.MULTI_KINDS


def _plan_parts(plan) -> tuple[tuple, str, bool, int]:
    return tuple(plan.refs), plan.kind, plan.uses_inverse, len(plan.refs)


def sense_plan(vth: Operands, plan) -> torch.Tensor:
    """Run a ReadPlan through the sense kernel: R rows -> (R, C // 32)."""
    refs, kind, sense_invert, n_refs = _plan_parts(plan)
    return _mlc.mlc_sense(vth, refs, kind=kind, invert=sense_invert,
                          n_refs=n_refs)


def sense_multi_plan(vth: Operands, plans) -> torch.Tensor:
    """Run P ReadPlans through the multi-plan sense kernel, each row read
    once: R rows -> (P, R, C // 32), plane ``p`` plan ``p``'s words."""
    return _mlc.mlc_sense_multi(vth, [(p.refs, p.kind, p.uses_inverse)
                                      for p in plans])


def sense_drain_plan(vth: Operands, plan, host: torch.Tensor, chunk_rows: int,
                     copy_stream=None, mask: Optional[torch.Tensor] = None,
                     mask_row: int = 0) -> int:
    """Run a ReadPlan through the sense kernel in chunks of rows, each
    chunk's words drained into ``host`` as it is made -> the chunks."""
    refs, kind, sense_invert, n_refs = _plan_parts(plan)
    return _mlc.sense_drain(vth, refs, kind=kind, invert=sense_invert,
                            n_refs=n_refs, host=host, chunk_rows=chunk_rows,
                            copy_stream=copy_stream, mask=mask,
                            mask_row=mask_row)


def sense_popcount_plan(vth: Operands, plan,
                        n_bits: Optional[int] = None) -> torch.Tensor:
    """Sense R rows under a ReadPlan and count the first ``n_bits`` cells'
    ones in the same pass -> 0-d int32."""
    refs, kind, sense_invert, n_refs = _plan_parts(plan)
    return _mlc.sense_popcount(vth, refs, kind=kind, invert=sense_invert,
                               n_refs=n_refs, n_bits=n_bits)


def sense_reduce_plan(vth: Operands, plan, *, op: str,
                      invert: bool = False) -> torch.Tensor:
    """Fused chain: N same-plan operands of R rows -> (R, C // 32) words."""
    refs, kind, sense_invert, n_refs = _plan_parts(plan)
    return _fused.sense_reduce(vth, refs, kind=kind, sense_invert=sense_invert,
                               op=op, invert=invert, n_refs=n_refs)


def sense_reduce_popcount_plan(vth: Operands, plan, mask: torch.Tensor, *,
                               op: str, invert: bool = False) -> torch.Tensor:
    """Fused chain + masked popcount: N operands of R rows -> (R,) int32."""
    refs, kind, sense_invert, n_refs = _plan_parts(plan)
    return _fused.sense_reduce_popcount(vth, refs, mask, kind=kind,
                                        sense_invert=sense_invert, op=op,
                                        invert=invert, n_refs=n_refs)
