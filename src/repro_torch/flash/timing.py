"""Latency model (paper §5.5, §6).

Per-op page-read latency decomposes into pre-charge + N x sensing + discharge
(Fig 8a).  Calibrated to the paper's measurements: LSB read (1 phase) = 40 µs,
MSB read (2 phases) = 70 µs  =>  t_sense = 30 µs, fixed overhead = 10 µs.
System-level constants are adopted verbatim from §6 so the Fig 9 timelines
reproduce exactly: t_R = 60 µs (generation-averaged), t_DMA = 51 µs
(4 x 16 kB over 1.2 GB/s), t_EXT = 122 µs (1 MB over the 8 GB/s host link),
t_prog = 600 µs (MLC page program), SET_FEATURE < 10 µs.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.encoding import OP_SENSING_PHASES


@dataclasses.dataclass(frozen=True)
class TimingModel:
    t_sense_us: float = 30.0
    t_fixed_us: float = 10.0          # pre-charge + discharge
    t_prog_us: float = 600.0          # MLC page program (copyback write)
    t_setfeature_us: float = 8.0      # read-offset register write
    t_r_avg_us: float = 60.0          # generation-averaged page read (§6)
    t_dma_us: float = 51.0            # 4 planes x 16 kB -> controller
    t_ext_us: float = 122.0           # 1 MB controller -> host

    def read_latency_us(self, op: str, phases: int | None = None) -> float:
        """MCFlash op latency = page read with the op's sensing-phase count.

        ``phases`` overrides the MLC Table-1 lookup — multi-level-encoding
        plans (TLC / reduced-MLC parity reads) carry their own phase count.
        """
        if phases is None:
            phases = OP_SENSING_PHASES[op]
        return self.t_fixed_us + phases * self.t_sense_us

    def op_latency_us(self, op: str, switch_op: bool = True,
                      phases: int | None = None) -> float:
        """Read latency + SET_FEATURE offset reprogramming when switching ops."""
        return (self.read_latency_us(op, phases)
                + (self.t_setfeature_us if switch_op else 0.0))


# ------------------------- Fig 9 system timelines -------------------------

def osc_time_us(t: TimingModel, n_channels: int = 16) -> float:
    """Outside-storage computing on two 8 MB operands (Fig 9b).

    Both operands stream to the host; reads/DMA overlap the serialised host
    transfers of 16 channels x 1 MB per operand => 16 x t_EXT total.
    """
    return t.t_r_avg_us + t.t_dma_us + n_channels * t.t_ext_us


def isc_time_us(t: TimingModel) -> float:
    """In-storage computing (Fig 9c): compute in the controller; internal DMA
    of both operands dominates (9 x t_DMA serialised), result (8 x t_EXT) out."""
    return t.t_r_avg_us + 9 * t.t_dma_us + 8 * t.t_ext_us


def mcflash_time_us(t: TimingModel, aligned: bool = True) -> float:
    """MCFlash (Fig 9d/e): one in-array op; only the result moves."""
    if aligned:
        return t.t_r_avg_us + t.t_dma_us + 8 * t.t_ext_us
    # Runtime realignment: read both operands + copyback-program the shared
    # page (3 x t_R + t_prog), then the aligned flow.
    return 3 * t.t_r_avg_us + t.t_prog_us + t.t_dma_us + 8 * t.t_ext_us
