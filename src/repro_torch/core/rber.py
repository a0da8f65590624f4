"""Per-block wear bookkeeping the FTL keeps (the reliability layer's input).

Only :class:`BlockHealth` and :class:`WearTracker` of the JAX package's
``core/rber.py`` live here; its RBER measurement harness is not ported yet.
"""
from __future__ import annotations

import dataclasses


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
