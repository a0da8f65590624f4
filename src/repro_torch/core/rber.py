"""RBER measurement harness (paper §5.1-5.4) and the per-block wear
bookkeeping the FTL keeps (the reliability layer's input).

:func:`measure_rber` programs random operand pages at a given (chip, N_PE,
retention) point, runs an MCFlash op and counts the cells whose result
differs from the logical oracle, in chunks so 2**30 bits per op fit.  Each
chunk's bits and Vth come from a ``torch.Generator`` keyed on ``(seed,
chunk)`` (the JAX package folds the chunk into a ``jax.random`` key: the two
agree in distribution, not in bits).  The errors are counted through the
kernels' :class:`~repro_torch.api.backends.Backend`: sense the chunk, XOR
it with the packed oracle, popcount the rows.  Packing is a bijection, so
the count equals the per-cell ``(got != want).sum()`` on the same Vth.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import mcflash, vth_model
from repro_torch.core.mcflash import ReadPlan
from repro_torch.core.vth_model import ChipModel
from repro_torch.kernels import ref as kernel_ref
from repro_torch.reliability.faults import keyed_generator

PAGE_BITS = 16 * 1024 * 8  # 16 kB pages (paper §5.2)


@dataclasses.dataclass
class RberResult:
    op: str
    pages: int
    bits: int
    errors: int

    @property
    def rber_pct(self) -> float:
        return 100.0 * self.errors / max(self.bits, 1)

    def __str__(self) -> str:
        return (f"{self.op.upper():5s} pages={self.pages} bits={self.bits} "
                f"errors={self.errors} RBER={self.rber_pct:.6f}%")


def program_chunk(seed: int, chunk: int, *, op: str, chip: ChipModel,
                  n_bits: int, n_pe: float, retention_hours: float,
                  device: "torch.device | str"
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(lsb, msb, vth) of one chunk of ``n_bits`` cells, drawn from the
    chunk's own generator on ``device``."""
    gen = keyed_generator(seed, (chunk,), device)
    bits = torch.randint(0, 2, (2, n_bits), generator=gen, device=device,
                         dtype=torch.uint8)
    lsb, msb = bits[0], bits[1]
    if op == "not":
        lsb = torch.zeros_like(lsb)  # NOT requires all-zero LSB init (paper §4.2)
    vth, _ = vth_model.program_page(gen, lsb, msb, chip, n_pe=n_pe,
                                    retention_hours=retention_hours)
    return lsb, msb, vth


def chunk_errors(plan: ReadPlan, op: str, vth: torch.Tensor,
                 lsb: torch.Tensor, msb: torch.Tensor,
                 backend) -> torch.Tensor:
    """Cells of ``vth`` (a multiple of ``PAGE_BITS``) whose ``plan`` read
    differs from ``op``'s oracle over the stored bits: an int64 scalar on
    ``vth``'s device, counted by ``backend``'s sense, reduce and popcount."""
    got = backend.sense(vth.reshape(-1, PAGE_BITS), plan)
    want = kernel_ref.pack_bits(
        mcflash.expected_result(op, lsb, msb).reshape(-1, PAGE_BITS))
    diff = backend.reduce((got, want), op="xor")
    return backend.popcount(diff).sum(dtype=torch.int64)


def _trial(seed: int, chunk: int, *, op: str, chip: ChipModel, n_bits: int,
           n_pe: float, retention_hours: float, plan: ReadPlan,
           backend, device: torch.device) -> torch.Tensor:
    """Program one chunk of cells, run ``plan``, return the error count."""
    lsb, msb, vth = program_chunk(seed, chunk, op=op, chip=chip,
                                  n_bits=n_bits, n_pe=n_pe,
                                  retention_hours=retention_hours,
                                  device=device)
    return chunk_errors(plan, op, vth, lsb, msb, backend)


def measure_rber(op: str, chip: ChipModel, *, pages: int = 64,
                 n_pe: float = 0.0, retention_hours: float = 0.0,
                 use_inverse_read: bool = True, seed: int = 0,
                 pages_per_chunk: int = 16,
                 device: "torch.device | str | None" = None) -> RberResult:
    """Measure RBER of ``op`` over ``pages`` 16 kB pages, on the card unless
    ``device`` says otherwise (``"cpu"`` runs the kernels' plain versions).
    Chunk ``i`` starts at page ``i * pages_per_chunk``; its bits and Vth
    depend only on ``(seed, that page index)``."""
    # deferred: the api layers on top of core
    from repro_torch.api.backends import Backend
    from repro_torch.api.plan_cache import PlanCache
    from repro_torch.api.session import resolve_device

    dev = resolve_device(device)
    plan = PlanCache().get(op, chip, use_inverse_read)
    backend = Backend(dev)
    errors = torch.zeros((), dtype=torch.int64, device=dev)
    done = 0
    while done < pages:
        chunk = min(pages_per_chunk, pages - done)
        errors += _trial(seed, done, op=op, chip=chip,
                         n_bits=chunk * PAGE_BITS, n_pe=n_pe,
                         retention_hours=retention_hours, plan=plan,
                         backend=backend, device=dev)
        done += chunk
    return RberResult(op=op, pages=pages, bits=pages * PAGE_BITS,
                      errors=int(errors))


# -- per-block wear bookkeeping (reliability layer) ---------------------------

@dataclasses.dataclass
class BlockHealth:
    """Observed health of one physical (plane, block)."""

    pe: int = 0                 # per-block extra P/E (on top of any baseline)
    incidents: int = 0          # recovery incidents touching this block
    rber_pct: float = 0.0       # EWMA of residual RBER at max normal retry
    retired: bool = False


class WearTracker:
    """FTL-side per-block P/E + observed-RBER tracking (EWMA per block)."""

    def __init__(self, alpha: float = 0.5):
        self.alpha = float(alpha)
        self._blocks: dict[tuple[int, int], BlockHealth] = {}

    def health(self, block: tuple[int, int]) -> BlockHealth:
        h = self._blocks.get(block)
        if h is None:
            h = self._blocks[block] = BlockHealth()
        return h

    def record(self, block: tuple[int, int], rber_pct: float,
               pe: int = 0) -> BlockHealth:
        h = self.health(block)
        if h.incidents == 0:
            h.rber_pct = float(rber_pct)
        else:
            h.rber_pct = (self.alpha * float(rber_pct)
                          + (1.0 - self.alpha) * h.rber_pct)
        h.incidents += 1
        h.pe = max(h.pe, int(pe))
        return h

    def retire(self, block: tuple[int, int]) -> None:
        self.health(block).retired = True

    def is_retired(self, block: tuple[int, int]) -> bool:
        h = self._blocks.get(block)
        return h is not None and h.retired

    @property
    def retired(self) -> tuple[tuple[int, int], ...]:
        return tuple(sorted(b for b, h in self._blocks.items() if h.retired))

    def summary(self) -> dict:
        retired = self.retired
        return {
            "tracked_blocks": len(self._blocks),
            "incidents": sum(h.incidents for h in self._blocks.values()),
            "retired_blocks": len(retired),
            "retired": list(retired),
            "max_rber_pct": max(
                (h.rber_pct for h in self._blocks.values()), default=0.0),
        }

    def histogram(self, edges=(0.0, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0)) -> dict:
        """Bucketed observed-RBER histogram for stats()/trace export."""
        counts = [0] * (len(edges))
        for h in self._blocks.values():
            placed = False
            for i in range(len(edges) - 1, -1, -1):
                if h.rber_pct >= edges[i]:
                    counts[i] += 1
                    placed = True
                    break
            if not placed:
                counts[0] += 1
        return {f">={edges[i]:g}%": counts[i] for i in range(len(edges))}
