"""Typed error taxonomy for the reliability escalation ladder.

Severity order mirrors the escalation policy: a bare detection incident
(``SenseMismatchError``, raised only when the policy forbids retrying)
escalates through the retry ladder (``RetryExhaustedError`` once the ladder
and — if enabled — recalibration both fail) up to data loss on a block that
not even migration could read back clean (``BlockRetiredError``).
"""
from __future__ import annotations

from typing import Sequence, Tuple


class ReliabilityError(RuntimeError):
    """Base class for all detection/recovery failures."""


class SenseMismatchError(ReliabilityError):
    """Checkword verification failed and the policy allows no recovery."""

    def __init__(self, mismatches: int, samples: int, label: str = ""):
        self.mismatches = int(mismatches)
        self.samples = int(samples)
        self.label = label
        pct = 100.0 * self.mismatches / max(1, self.samples)
        super().__init__(
            f"checkword mismatch{f' on {label}' if label else ''}: "
            f"{self.mismatches}/{self.samples} sampled bits differ "
            f"({pct:.2f}%) and the retry ladder is disabled")


class RetryExhaustedError(ReliabilityError):
    """The read-retry ladder (and recalibration, if enabled) found no
    reference offset that clears the checkword mismatch."""

    def __init__(self, attempts: int, offsets: Sequence[float],
                 label: str = "", recalibrated: bool = False):
        self.attempts = int(attempts)
        self.offsets = tuple(float(o) for o in offsets)
        self.label = label
        self.recalibrated = bool(recalibrated)
        tried = ", ".join(f"{o:+.3f}V" for o in self.offsets)
        super().__init__(
            f"read-retry exhausted{f' on {label}' if label else ''}: "
            f"{self.attempts} attempts at offsets [{tried}]"
            + (" plus a full recalibration sweep" if recalibrated else "")
            + " left sampled bit errors")


class BlockRetiredError(ReliabilityError):
    """Blocks were retired but their data could not be relocated intact
    (e.g. stuck bits / dead blocks) — unrecoverable data loss."""

    def __init__(self, blocks: Sequence[Tuple[int, int]], label: str = ""):
        self.blocks = tuple(tuple(b) for b in blocks)
        self.label = label
        where = ", ".join(f"(plane {p}, block {b})" for p, b in self.blocks)
        super().__init__(
            f"block(s) retired with unrecoverable data"
            f"{f' for {label}' if label else ''}: {where}")
