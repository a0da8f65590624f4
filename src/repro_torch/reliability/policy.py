"""Retry/escalation policy knobs for the recovery ladder."""
from __future__ import annotations

import dataclasses
from typing import Tuple

ESCALATION_STAGES = ("retry", "recalibrate", "migrate")


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded read-retry ladder + escalation configuration.

    The ladder probes alternating offsets around the stored per-encoding
    reference trim (attempt 1 is the trim itself once one exists):
    ``trim, trim-step, trim+step, trim-2*step, ...`` up to ``max_attempts``.
    Escalation stages not listed in ``escalation`` are skipped, which maps
    directly onto the error taxonomy: ``()`` raises ``SenseMismatchError``
    on first detection, ``("retry",)`` raises ``RetryExhaustedError`` when
    the ladder runs dry, and the full ladder only raises
    ``BlockRetiredError`` when even migration cannot relocate clean data.
    """

    max_attempts: int = 6
    ref_step_v: float = 0.08
    recal_span_v: float = 0.6      # recalibration sweep half-width
    recal_steps: int = 13          # sweep points (linspace over +/- span)
    migrate_rber_pct: float = 0.05  # EWMA residual-RBER threshold (percent)
    migrate_encoding: str = "reduced-mlc"
    escalation: Tuple[str, ...] = ESCALATION_STAGES
    check_samples: int = 1024      # checkword sample positions per vector
    ewma_alpha: float = 0.5        # wear-tracker RBER smoothing

    def __post_init__(self):
        for stage in self.escalation:
            if stage not in ESCALATION_STAGES:
                raise ValueError(f"unknown escalation stage {stage!r}")

    def allows(self, stage: str) -> bool:
        return stage in self.escalation

    def ladder_offsets(self, trim: float = 0.0) -> Tuple[float, ...]:
        offs = [trim] if trim else []
        i = 1
        while len(offs) < self.max_attempts:
            k = (i + 1) // 2
            sign = -1.0 if i % 2 else 1.0
            offs.append(trim + sign * k * self.ref_step_v)
            i += 1
        return tuple(offs)

    @staticmethod
    def parse(spec) -> "RetryPolicy":
        if spec is None:
            return RetryPolicy()
        if isinstance(spec, RetryPolicy):
            return spec
        if isinstance(spec, dict):
            if "escalation" in spec:
                spec = dict(spec, escalation=tuple(spec["escalation"]))
            return RetryPolicy(**spec)
        raise TypeError(f"cannot parse retry policy {spec!r}")
