"""The kernels' entry points as the backends call them.

The JAX package padded rows to the TPU's 8-row tile here; the CUDA kernels
take any row count, so the sense entry points only unpack a
:class:`ReadPlan` into the kernels' arguments.  Each call launches the CUDA
kernel for CUDA tensors and runs the plain version for CPU tensors.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import fused as _fused
from repro_torch.kernels import mlc_sense as _mlc
from repro_torch.kernels.bitops import bitwise_reduce
from repro_torch.kernels.popcount import popcount_rows

__all__ = ["sense_plan", "sense_reduce_plan", "sense_reduce_popcount_plan",
           "bitwise_reduce", "popcount_rows"]


def _plan_parts(plan) -> tuple[tuple, str, bool, int]:
    return tuple(plan.refs), plan.kind, plan.uses_inverse, len(plan.refs)


def sense_plan(vth: torch.Tensor, plan) -> torch.Tensor:
    """Run a ReadPlan through the sense kernel: (R, C) -> (R, C // 32)."""
    refs, kind, sense_invert, n_refs = _plan_parts(plan)
    return _mlc.mlc_sense(vth, refs, kind=kind, invert=sense_invert,
                          n_refs=n_refs)


def sense_reduce_plan(vth: torch.Tensor, plan, *, op: str,
                      invert: bool = False) -> torch.Tensor:
    """Fused chain: (N, R, C) same-plan Vth -> (R, C // 32) words."""
    refs, kind, sense_invert, n_refs = _plan_parts(plan)
    return _fused.sense_reduce(vth, refs, kind=kind, sense_invert=sense_invert,
                               op=op, invert=invert, n_refs=n_refs)


def sense_reduce_popcount_plan(vth: torch.Tensor, plan, mask: torch.Tensor, *,
                               op: str, invert: bool = False) -> torch.Tensor:
    """Fused chain + masked popcount: (N, R, C) Vth -> (R,) int32."""
    refs, kind, sense_invert, n_refs = _plan_parts(plan)
    return _fused.sense_reduce_popcount(vth, refs, mask, kind=kind,
                                        sense_invert=sense_invert, op=op,
                                        invert=invert, n_refs=n_refs)
