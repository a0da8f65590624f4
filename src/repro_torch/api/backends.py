"""The execution backend of the compute-session layer.

A :class:`Backend` turns read plans and packed bit-vectors into numbers
through the kernels' wrappers (:mod:`repro_torch.kernels.ops`), which
launch the hand-written CUDA kernel for a CUDA tensor and run its plain
PyTorch version for a CPU tensor.  There is one backend; its ``name``
says which of the two the device it serves runs: ``"cuda"`` on a card,
``"sim"`` on the CPU.

It consumes and produces the lane-major packed layout as int32 words.
"""
from __future__ import annotations

import torch

from repro_torch.core.mcflash import ReadPlan
from repro_torch.kernels import ops as kops


class Backend:
    """The kernels, for the tensors of one torch device."""

    def __init__(self, device: torch.device):
        #: ``"cuda"`` (the CUDA kernels) or ``"sim"`` (the plain versions)
        self.name = "cuda" if torch.device(device).type == "cuda" else "sim"

    def sense(self, vth: torch.Tensor, plan: ReadPlan) -> torch.Tensor:
        """(R, C) Vth + read plan -> (R, C//32) packed int32."""
        return kops.sense_plan(vth, plan)

    def reduce(self, stack: torch.Tensor, op: str, invert: bool = False) -> torch.Tensor:
        """(N, R, W) packed operands -> (R, W) op-reduction (controller combine)."""
        return kops.bitwise_reduce(stack, op=op, invert=invert)

    def popcount(self, words: torch.Tensor) -> torch.Tensor:
        """(R, W) packed words -> (R,) int32 bit counts."""
        return kops.popcount_rows(words)

    def sense_reduce(self, vth: torch.Tensor, plan: ReadPlan, *, op: str,
                     invert: bool = False) -> torch.Tensor:
        """Fused chain: (N, R, C) same-plan Vth -> (R, C//32) packed."""
        return kops.sense_reduce_plan(vth, plan, op=op, invert=invert)

    def sense_reduce_popcount(self, vth: torch.Tensor, plan: ReadPlan,
                              mask: torch.Tensor, *, op: str,
                              invert: bool = False) -> torch.Tensor:
        """Fused chain + masked popcount: (N, R, C) Vth -> (R,) int32."""
        return kops.sense_reduce_popcount_plan(vth, plan, mask, op=op,
                                               invert=invert)
