"""MCFlash-backed bitmap-filtered data selection.

Per-sample quality / dedup / domain bitmaps live on the simulated SSD as
aligned shared pages; selecting the samples of a training epoch evaluates
the filter predicate as an in-flash AND chain through
:class:`~repro_torch.api.session.ComputeSession` (one MCFlash sense per
pair and one fused combine), so only the final selection bitmap, not the
bitmaps it is built from, crosses to the host.  It mirrors the paper's
bitmap-index case study (§6.2) inside the training stack.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.api.session import ComputeSession


class BitmapFilter:
    """Holds named per-sample bitmaps in flash; evaluates AND-chains in-flash.

    ``session`` defaults to a new one on ``device`` (the card unless
    ``"cpu"``)."""

    def __init__(self, n_samples: int, session: ComputeSession | None = None,
                 device: "torch.device | str | None" = None):
        self.session = session or ComputeSession(device, seed=17)
        page_bits = self.session.device.config.page_bits
        self.n_samples = n_samples
        # round up to whole pages
        self.n_bits = ((n_samples + page_bits - 1) // page_bits) * page_bits
        self._names: list[str] = []

    @property
    def device(self):
        return self.session.device

    @property
    def ftl(self):
        return self.session.ftl

    def add_pair(self, name_a: str, bits_a: np.ndarray,
                 name_b: str, bits_b: np.ndarray) -> None:
        """Store two filter bitmaps co-located (aligned LSB/MSB pages)."""
        self.session.write_pair(name_a, self._pad(bits_a), name_b,
                                self._pad(bits_b))
        self._names += [name_a, name_b]

    def _pad(self, bits: np.ndarray) -> np.ndarray:
        if bits.shape[0] != self.n_samples:
            raise ValueError(f"{bits.shape[0]} bits for {self.n_samples} "
                             "samples")
        out = np.zeros(self.n_bits, np.uint8)
        out[: self.n_samples] = bits.astype(np.uint8)
        return out

    def _expr(self, pairs: list[tuple[str, str]]):
        return self.session.chain("and", [n for pair in pairs for n in pair])

    def select(self, pairs: list[tuple[str, str]]) -> np.ndarray:
        """In-flash AND chain over filter pairs -> boolean sample mask."""
        bits = self.session.materialize(self._expr(pairs), unpacked=True)
        return bits[: self.n_samples].cpu().numpy().astype(bool)

    def count(self, pairs: list[tuple[str, str]]) -> int:
        """Selection cardinality: the chain's popcount on the device."""
        return self.session.popcount(self._expr(pairs))
