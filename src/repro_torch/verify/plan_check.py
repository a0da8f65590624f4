"""Entry point of the static ExecPlan verifier.

:func:`check_plan` runs the ordered invariant catalog from
:mod:`repro_torch.verify.invariants` over one lowered plan.  :class:`PlanVerifier`
is the session-side wrapper: it memoizes clean verdicts by plan signature so
a cache-hit materialize pays nothing, and counts verified plans / memo hits
for ``sess.stats()``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional, Set

from repro_torch.verify.invariants import INVARIANTS, PlanContext, check_paranoid

__all__ = ["PlanVerifier", "check_plan"]

MODES = ("off", "on", "paranoid")


def check_plan(plan, ctx: PlanContext) -> None:
    """Run every invariant over ``plan``; raise
    :class:`~repro_torch.verify.invariants.PlanInvariantError` on the first
    violation.  With ``ctx.paranoid`` the extra-cost audits run too."""
    for _name, check in INVARIANTS:
        check(plan, ctx)
    if ctx.paranoid:
        check_paranoid(plan, ctx)


class PlanVerifier:
    """Signature-memoized plan verification for a session.

    ``mode`` is one of ``"off"`` / ``"on"`` / ``"paranoid"``.  A plan whose
    signature already verified clean is skipped (counted as a memo hit) —
    except in paranoid mode, which re-checks every time.
    """

    def __init__(self, mode: str = "on"):
        if mode not in MODES:
            raise ValueError(
                f"verify mode must be one of {MODES}, got {mode!r}")
        self.mode = mode
        self._clean: Set[tuple] = set()
        self.plans_verified = 0
        self.cache_hits = 0
        self.time_us = 0.0

    @property
    def enabled(self) -> bool:
        return self.mode != "off"

    def verify(self, plan, ctx: PlanContext,
               signature: Optional[tuple] = None) -> None:
        """Verify ``plan`` unless its ``signature`` already passed."""
        if self.mode == "off":
            return
        if (signature is not None and self.mode != "paranoid"
                and signature in self._clean):
            self.cache_hits += 1
            return
        if self.mode == "paranoid" and not ctx.paranoid:
            ctx = dataclasses.replace(ctx, paranoid=True)
        t0 = time.perf_counter()
        try:
            check_plan(plan, ctx)
        finally:
            self.time_us += (time.perf_counter() - t0) * 1e6
        self.plans_verified += 1
        if signature is not None:
            self._clean.add(signature)

    def reset(self) -> None:
        """Clear counters (the clean-signature memo survives: the plans it
        describes did not become invalid because stats reset)."""
        self.plans_verified = 0
        self.cache_hits = 0
        self.time_us = 0.0
