"""Static verification of lowered plans.

:mod:`repro_torch.verify.invariants` / :mod:`repro_torch.verify.plan_check`
hold the static :class:`~repro_torch.api.executor.ExecPlan` verifier that
runs at lowering time, before any dispatch: wave die-disjointness, schedule
topology, arena-slot program/sense hazards, the fused-pass operand budget,
encoding consistency, reference-stack bounds and ledger byte conservation.
Violations raise a typed :class:`PlanInvariantError` carrying the offending
wave/unit and a rendered plan excerpt.  Sessions enable it with
``ComputeSession(verify="on" | "paranoid")`` (the default is
``$REPRO_VERIFY``, else ``"on"``); results memoize per plan signature so
cache-hit materializes pay nothing.

:mod:`repro_torch.verify.corpus` replays the plan corpus through the
verifier in paranoid mode.
"""
from repro_torch.verify.invariants import (
    INVARIANTS,
    PlanContext,
    PlanInvariantError,
    check_overlap_consistency,
    render_plan,
)
from repro_torch.verify.plan_check import PlanVerifier, check_plan

__all__ = [
    "INVARIANTS",
    "PlanContext",
    "PlanInvariantError",
    "PlanVerifier",
    "check_overlap_consistency",
    "check_plan",
    "render_plan",
]
