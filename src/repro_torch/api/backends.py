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

from typing import Optional, Sequence, Union

import torch

from repro_torch.core.mcflash import ReadPlan
from repro_torch.kernels import ops as kops
from repro_torch.kernels.rows import Rows

#: Vth a sense reads: a dense tensor, or rows read in place through slot
#: tables
Vth = Union[torch.Tensor, Rows]


class Backend:
    """The kernels, for the tensors of one torch device."""

    def __init__(self, device: torch.device):
        #: ``"cuda"`` (the CUDA kernels) or ``"sim"`` (the plain versions)
        self.name = "cuda" if torch.device(device).type == "cuda" else "sim"

    def sense(self, vth: Vth, plan: ReadPlan) -> torch.Tensor:
        """R Vth rows ((R, C) or :class:`Rows`, read in table order) + read
        plan -> (R, C//32) packed int32."""
        return kops.sense_plan(vth, plan)

    #: read kinds :meth:`sense_multi` takes (a parity read goes through
    #: :meth:`sense`)
    multi_kinds = kops.MULTI_KINDS

    def sense_multi(self, vth: Vth, plans: Sequence[ReadPlan]) -> torch.Tensor:
        """R Vth rows + P read plans of :attr:`multi_kinds` -> (P, R, C//32)
        packed int32, plane ``p`` what :meth:`sense` gives under plan ``p``,
        each row read once."""
        return kops.sense_multi_plan(vth, plans)

    def sense_drain(self, vth: Vth, plan: ReadPlan, host: torch.Tensor,
                    chunk_rows: int, copy_stream=None,
                    mask: Optional[torch.Tensor] = None,
                    mask_row: int = 0) -> int:
        """R Vth rows + read plan -> :meth:`sense`'s words, drained into the
        flat ``host`` buffer ``chunk_rows`` rows at a time, each chunk's copy
        (on ``copy_stream``, on a card) starting as soon as it is sensed;
        words of rows from ``mask_row`` on are ANDed with ``mask`` first.
        Returns the chunks."""
        return kops.sense_drain_plan(vth, plan, host, chunk_rows, copy_stream,
                                     mask, mask_row)

    def sense_popcount(self, vth: Vth, plan: ReadPlan,
                       n_bits: Optional[int] = None) -> torch.Tensor:
        """R Vth rows + read plan -> 0-d int32: the ones among the first
        ``n_bits`` sensed cells (row after row), sensed and counted in one
        pass with no words written."""
        return kops.sense_popcount_plan(vth, plan, n_bits)

    def reduce(self, operands: Union[torch.Tensor, Sequence[torch.Tensor]],
               op: str, invert: bool = False,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """N same-shape packed operands (a sequence, or an (N, ...) stack)
        -> their op-reduction (controller combine), into ``out`` if given."""
        return kops.bitwise_reduce(operands, op=op, invert=invert, out=out)

    def popcount(self, words: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(R, W) packed words (``& mask``, of the same shape, if given) ->
        (R,) int32 bit counts."""
        return kops.popcount_rows(words, mask)

    def sense_reduce(self, vth: Vth, plan: ReadPlan, *, op: str,
                     invert: bool = False) -> torch.Tensor:
        """Fused chain: N same-plan operands of R rows ((N, R, C), or
        :class:`Rows` with one table per operand) -> (R, C//32) packed."""
        return kops.sense_reduce_plan(vth, plan, op=op, invert=invert)

    def sense_reduce_popcount(self, vth: Vth, plan: ReadPlan,
                              mask: torch.Tensor, *, op: str,
                              invert: bool = False) -> torch.Tensor:
        """Fused chain + masked popcount: N operands of R rows -> (R,)
        int32."""
        return kops.sense_reduce_popcount_plan(vth, plan, mask, op=op,
                                               invert=invert)
