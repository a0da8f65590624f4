"""Static :class:`~repro_torch.api.executor.ExecPlan` invariants.

The correctness of a lowered plan rests on a stack of schedule rules that the
lowering pass upholds *by construction* — this module makes each one
machine-checkable, so a bug anywhere in lowering / fusion / grouping /
scheduling is caught before a single kernel dispatches, not by sampling:

- ``ledger-conservation`` — every sense unit is booked in exactly one wave
  and the bytes booked across waves equal the bytes the plan transfers;
  the plan's item/sense counters and output page geometry are consistent.
- ``wave-die-disjoint`` — no two units in one wave touch the same die (a
  wave is, by definition, a concurrent dispatch of die-disjoint work).
- ``slot-hazard`` — a program/scatter and a sense/gather of the same
  ``(die, slot)`` wordline must be separated by a wave barrier, and no two
  units in one wave may strobe the same wordline: a race detector for the
  schedule.  Placement writes performed during lowering occupy the implicit
  pre-dispatch barrier wave ``-1``.
- ``schedule-topology`` — every combine's inputs are produced at a strictly
  earlier schedule position, every partial is produced exactly once, and the
  root is produced.
- ``vmem-budget`` — every fused kernel's declared split takes at most the
  executor's ``MAX_FUSED_OPERANDS`` operands per pass (the budget the JAX
  package derives from its VMEM size; the name is kept so both packages
  reject a corrupt split with the same invariant) and covers all its
  operands.
- ``encoding-consistency`` — all senses in a group share ONE
  :class:`~repro_torch.core.mcflash.ReadPlan` (and therefore one encoding); parity
  plans name their encoding in the op label, so TLC / reduced-MLC plans can
  never alias an MLC group.
- ``ref-bounds`` — reference stacks respect the kernels' ``MAX_REFS``
  slot, each sensing mechanism carries its exact reference arity, and parity
  (band-pattern) reference combs are in strictly monotone valley order, per
  the compiler in :mod:`repro_torch.core.tlc`.
- ``migration-barrier`` — copyback program steps scheduled *into* the wave
  timeline (reliability-layer block migrations filling idle die slots) must
  carry a program barrier against every in-flight sense on the same die:
  a scheduled program may share its wave only with units on other dies.

Violations raise :class:`PlanInvariantError` with the offending wave/unit
index, the die where applicable, and a rendered plan excerpt.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.kernels.ref import MAX_REFS

__all__ = ["INVARIANTS", "PlanContext", "PlanInvariantError", "render_plan",
           "check_overlap_consistency"]

#: reference arity of each non-parity sensing mechanism (Table 1)
_KIND_REFS = {"lsb": 1, "msb": 2, "sbr": 4}
#: parity op labels are "<encoding>:<op>:<roles>" (see core.tlc.plan_encoded)
_PARITY_ENCODINGS = ("tlc", "reduced-mlc")


@dataclasses.dataclass(frozen=True)
class PlanContext:
    """Everything the checker needs beyond the plan itself: the device's
    die geometry and the executing session's fused-pass budget."""
    die_of_plane: Callable[[int], int]
    page_words: int                     # packed 32-bit words per page
    max_fused_operands: int             # operands one fused pass may take
    max_refs: int = MAX_REFS
    paranoid: bool = False              # enable the extra-cost audits


class PlanInvariantError(Exception):
    """A lowered plan violates a schedule invariant.

    Carries the invariant name, the offending wave / unit / die where
    applicable, and a rendered excerpt of the schedule around the violation.
    """

    def __init__(self, invariant: str, detail: str, *, plan=None,
                 wave: Optional[int] = None, unit: Optional[str] = None,
                 die: Optional[int] = None):
        self.invariant = invariant
        self.detail = detail
        self.wave = wave
        self.unit = unit
        self.die = die
        self.excerpt = render_plan(plan, highlight=wave) if plan is not None \
            else ""
        where = []
        if wave is not None:
            where.append(f"wave {wave}")
        if unit is not None:
            where.append(f"unit {unit}")
        if die is not None:
            where.append(f"die {die}")
        at = f" at {', '.join(where)}" if where else ""
        msg = f"plan invariant '{invariant}' violated{at}: {detail}"
        if self.excerpt:
            msg += "\n" + self.excerpt
        super().__init__(msg)


# ---------------------------------------------------------------------------
# plan rendering (error excerpts)

def _unit_desc(plan, kind: str, idx: int) -> str:
    if kind == "group":
        g = plan.groups[idx]
        return (f"group[{idx}] {g.op_label} x{len(g.wls)}p dies={g.dies}")
    st = plan.steps[idx]
    if kind == "fused":
        f = st.fused
        return (f"fused[{idx}] {f.op_label} x{f.n_operands}op"
                f" dies={f.dies}")
    args = ",".join(f"p{a}" for a in st.args)
    inv = "~" if st.invert else ""
    return f"combine[{idx}] p{st.out}={inv}{st.op}({args})"


def render_plan(plan, highlight: Optional[int] = None,
                context: int = 2) -> str:
    """Human-readable schedule excerpt: one line per wave (with its unit
    composition), windowed to ±``context`` waves around ``highlight``."""
    lines: List[str] = []
    for pi, pr in enumerate(getattr(plan, "programs", []) or []):
        lines.append(f"  program[{pi}] wave={pr.wave} {pr.label}"
                     f" x{len(pr.wls)}p dies={pr.dies}")
    for wi, wave in enumerate(plan.waves):
        if highlight is not None and abs(wi - highlight) > context:
            if not lines or lines[-1] != "  ...":
                lines.append("  ...")
            continue
        parts = ([_unit_desc(plan, "group", gi) for gi in wave.groups]
                 + [_unit_desc(plan, "fused", si) for si in wave.fused]
                 + [_unit_desc(plan, "combine", ci) for ci in wave.combines])
        mark = ">>" if wi == highlight else "  "
        lines.append(f"{mark}wave {wi}: " + ("; ".join(parts) or "(empty)"))
    roots = getattr(plan, "roots", ()) or ()
    if roots:
        lines.append(f"  roots={','.join(f'p{r}' for r in roots)}"
                     f" words={getattr(plan, 'roots_words', ())}")
    else:
        lines.append(f"  root=p{plan.root} out_pages={plan.out_pages}"
                     f" out_words={plan.out_words}")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# shared helpers

def _wave_units(plan, wi: int) -> List[Tuple[str, int, Tuple[int, ...], list]]:
    """(kind, index, dies, wls) of every dispatch unit in wave ``wi``."""
    wave = plan.waves[wi]
    units = [("group", gi, plan.groups[gi].dies, plan.groups[gi].wls)
             for gi in wave.groups]
    units += [("fused", si, plan.steps[si].fused.dies,
               plan.steps[si].fused.wls) for si in wave.fused]
    return units


def _declared_dies_ok(ctx: PlanContext, plan, kind: str, idx: int,
                      dies: Tuple[int, ...], wls: list,
                      wave: Optional[int]) -> None:
    actual = tuple(sorted({ctx.die_of_plane(p) for p, _, _ in wls}))
    declared = tuple(sorted(set(dies)))
    if actual != declared:
        raise PlanInvariantError(
            "wave-die-disjoint",
            f"declared die set {declared} does not match the dies its"
            f" wordlines live on {actual}", plan=plan, wave=wave,
            unit=f"{kind}[{idx}]",
            die=next(iter(set(actual) ^ set(declared)), None))


# ---------------------------------------------------------------------------
# invariant checks — each raises PlanInvariantError on the first violation

def check_ledger_conservation(plan, ctx: PlanContext) -> None:
    """Bytes booked per wave == bytes the plan transfers: every sense unit
    and combine is scheduled in exactly one wave, and the plan's counters /
    output geometry agree with its units."""
    page_bytes = ctx.page_words * 4
    seen_groups: Dict[int, int] = {}
    seen_steps: Dict[int, Tuple[str, int]] = {}
    booked_pages = 0
    for wi, wave in enumerate(plan.waves):
        for gi in wave.groups:
            if not 0 <= gi < len(plan.groups):
                raise PlanInvariantError(
                    "ledger-conservation", f"wave books unknown group[{gi}]",
                    plan=plan, wave=wi)
            if gi in seen_groups:
                raise PlanInvariantError(
                    "ledger-conservation",
                    f"group[{gi}] double-booked (already in wave"
                    f" {seen_groups[gi]}): its"
                    f" {len(plan.groups[gi].wls) * page_bytes} B would be"
                    " charged twice", plan=plan, wave=wi,
                    unit=f"group[{gi}]", die=plan.groups[gi].dies[0]
                    if plan.groups[gi].dies else None)
            seen_groups[gi] = wi
            booked_pages += len(plan.groups[gi].wls)
        for kind, lst in (("fused", wave.fused), ("combine", wave.combines)):
            for si in lst:
                if not 0 <= si < len(plan.steps):
                    raise PlanInvariantError(
                        "ledger-conservation",
                        f"wave books unknown step[{si}]", plan=plan, wave=wi)
                st = plan.steps[si]
                if (st.fused is not None) != (kind == "fused"):
                    raise PlanInvariantError(
                        "ledger-conservation",
                        f"step[{si}] scheduled as a {kind} but its fused"
                        f" spec is {'set' if st.fused else 'absent'}",
                        plan=plan, wave=wi, unit=f"{kind}[{si}]")
                if si in seen_steps:
                    raise PlanInvariantError(
                        "ledger-conservation",
                        f"step[{si}] double-booked (already in wave"
                        f" {seen_steps[si][1]})", plan=plan, wave=wi,
                        unit=f"{kind}[{si}]")
                seen_steps[si] = (kind, wi)
                if st.fused is not None:
                    booked_pages += len(st.fused.wls)
    for gi, g in enumerate(plan.groups):
        if gi not in seen_groups:
            raise PlanInvariantError(
                "ledger-conservation",
                f"group[{gi}] ({g.op_label} x{len(g.wls)}p) is in no wave:"
                f" {len(g.wls) * page_bytes} B of transfers would go"
                " unbooked", plan=plan, unit=f"group[{gi}]",
                die=g.dies[0] if g.dies else None)
    for si, st in enumerate(plan.steps):
        if si not in seen_steps:
            kind = "fused" if st.fused is not None else "combine"
            raise PlanInvariantError(
                "ledger-conservation", f"{kind} step[{si}] is in no wave",
                plan=plan, unit=f"{kind}[{si}]")
    plan_pages = (sum(len(g.wls) for g in plan.groups)
                  + sum(len(st.fused.wls) for st in plan.steps
                        if st.fused is not None))
    if booked_pages != plan_pages:
        raise PlanInvariantError(
            "ledger-conservation",
            f"waves book {booked_pages * page_bytes} B but the plan"
            f" transfers {plan_pages * page_bytes} B", plan=plan)
    fused_ops = sum(st.fused.n_operands for st in plan.steps
                    if st.fused is not None)
    items = sum(len(g.items) for g in plan.groups) + fused_ops
    if plan.items != items:
        raise PlanInvariantError(
            "ledger-conservation",
            f"plan.items={plan.items} but units account {items}"
            " sense/read items", plan=plan)
    senses = sum(1 for g in plan.groups for it in g.items
                 if it.is_mcflash) + fused_ops
    if plan.senses != senses:
        raise PlanInvariantError(
            "ledger-conservation",
            f"plan.senses={plan.senses} but units account {senses}"
            " in-flash senses", plan=plan)
    if plan.out_words != plan.out_pages * ctx.page_words:
        raise PlanInvariantError(
            "ledger-conservation",
            f"out_words={plan.out_words} != out_pages({plan.out_pages})"
            f" * page_words({ctx.page_words}): the root transfer would be"
            " mis-sized", plan=plan)
    # batch plans: each root's declared word geometry must match its pages
    # (getattr fallbacks keep hand-built single-root plans checkable)
    roots = getattr(plan, "roots", ()) or ()
    roots_pages = getattr(plan, "roots_pages", ()) or ()
    roots_words = getattr(plan, "roots_words", ()) or ()
    if roots and not (len(roots) == len(roots_pages) == len(roots_words)):
        raise PlanInvariantError(
            "ledger-conservation",
            f"batch plan declares {len(roots)} roots but"
            f" {len(roots_pages)} page counts / {len(roots_words)} word"
            " counts", plan=plan)
    for ri, (pages, words) in enumerate(zip(roots_pages, roots_words)):
        if words != pages * ctx.page_words:
            raise PlanInvariantError(
                "ledger-conservation",
                f"batch root[{ri}]: {words} words != {pages} pages *"
                f" page_words({ctx.page_words}) — that request's transfer"
                " would be mis-sized", plan=plan)


def check_wave_die_disjoint(plan, ctx: PlanContext) -> None:
    """No two units in one wave touch the same die."""
    for wi in range(len(plan.waves)):
        units = _wave_units(plan, wi)
        for kind, idx, dies, wls in units:
            _declared_dies_ok(ctx, plan, kind, idx, dies, wls, wi)
        owner: Dict[int, str] = {}
        for kind, idx, dies, _ in units:
            for die in dies:
                if die in owner:
                    raise PlanInvariantError(
                        "wave-die-disjoint",
                        f"{kind}[{idx}] shares die {die} with"
                        f" {owner[die]} in the same wave — concurrent"
                        " dispatch to one die", plan=plan, wave=wi,
                        unit=f"{kind}[{idx}]", die=die)
                owner[die] = f"{kind}[{idx}]"


def check_slot_hazards(plan, ctx: PlanContext) -> None:
    """Program/scatter vs sense/gather of one ``(die, slot)`` must be
    separated by a wave barrier; two units may never strobe one wordline
    concurrently."""
    sense_waves: Dict[tuple, List[Tuple[int, str]]] = {}
    for wi in range(len(plan.waves)):
        owner: Dict[tuple, str] = {}
        for kind, idx, _, wls in _wave_units(plan, wi):
            unit = f"{kind}[{idx}]"
            for wl in wls:
                prev = owner.get(wl)
                if prev is not None and prev != unit:
                    raise PlanInvariantError(
                        "slot-hazard",
                        f"wordline {wl} gathered by both {prev} and {unit}"
                        " in one wave (no barrier between the strobes)",
                        plan=plan, wave=wi, unit=unit,
                        die=ctx.die_of_plane(wl[0]))
                owner[wl] = unit
                sense_waves.setdefault(wl, []).append((wi, unit))
    for pi, pr in enumerate(getattr(plan, "programs", []) or []):
        for wl in pr.wls:
            for wi, unit in sense_waves.get(wl, ()):
                if pr.wave == wi:
                    raise PlanInvariantError(
                        "slot-hazard",
                        f"program[{pi}] ({pr.label}) writes wordline {wl} in"
                        f" the same wave that {unit} senses it — the"
                        " scatter and the gather race without a wave"
                        " barrier", plan=plan, wave=wi,
                        unit=f"program[{pi}]", die=ctx.die_of_plane(wl[0]))


def check_schedule_topology(plan, ctx: PlanContext) -> None:
    """Every combine's inputs are produced at a strictly earlier schedule
    position (waves run in order; within a wave: groups, fused, then
    combines in list order), every partial is produced once, and the root
    is produced."""
    produced: Dict[int, Tuple[int, int, int]] = {}

    def produce(pid: int, pos: Tuple[int, int, int], unit: str,
                wave: int) -> None:
        if pid in produced:
            raise PlanInvariantError(
                "schedule-topology",
                f"partial p{pid} produced twice (first at wave"
                f" {produced[pid][0]})", plan=plan, wave=wave, unit=unit)
        produced[pid] = pos

    for wi, wave in enumerate(plan.waves):
        for k, gi in enumerate(wave.groups):
            for it in plan.groups[gi].items:
                produce(it.pid, (wi, 0, k), f"group[{gi}]", wi)
        for k, si in enumerate(wave.fused):
            produce(plan.steps[si].out, (wi, 1, k), f"fused[{si}]", wi)
        for k, ci in enumerate(wave.combines):
            st = plan.steps[ci]
            pos = (wi, 2, k)
            for a in st.args:
                src = produced.get(a)
                if src is None:
                    raise PlanInvariantError(
                        "schedule-topology",
                        f"combine[{ci}] consumes p{a} which is never"
                        " produced before it in the schedule", plan=plan,
                        wave=wi, unit=f"combine[{ci}]")
                if src >= pos:
                    raise PlanInvariantError(
                        "schedule-topology",
                        f"combine[{ci}] at wave {wi} consumes p{a}"
                        f" produced later (wave {src[0]}) — inputs must"
                        " be produced at a strictly earlier position",
                        plan=plan, wave=wi, unit=f"combine[{ci}]")
            produce(st.out, pos, f"combine[{ci}]", wi)
    # every batch root must be produced (single-root plans degrade to the
    # scalar root; getattr keeps hand-built plans checkable)
    for root in (getattr(plan, "roots", ()) or (plan.root,)):
        if root not in produced:
            raise PlanInvariantError(
                "schedule-topology",
                f"root partial p{root} is never produced", plan=plan)


def check_vmem_budget(plan, ctx: PlanContext) -> None:
    """Every fused kernel's split takes at most ``max_fused_operands``
    operands per pass and its operand stack is shaped consistently."""
    for si, st in enumerate(plan.steps):
        f = st.fused
        if f is None:
            continue
        unit = f"fused[{si}]"
        wave = _wave_of_step(plan, si)
        if len(f.wls) != f.n_operands * f.n_pages:
            raise PlanInvariantError(
                "vmem-budget",
                f"fused spec carries {len(f.wls)} wordlines for"
                f" {f.n_operands} operands x {f.n_pages} pages", plan=plan,
                wave=wave, unit=unit)
        if f.pass_operands < 1:
            raise PlanInvariantError(
                "vmem-budget",
                f"split of {f.pass_operands} operands/pass takes nothing",
                plan=plan, wave=wave, unit=unit)
        if f.pass_operands > ctx.max_fused_operands:
            raise PlanInvariantError(
                "vmem-budget",
                f"fused pass takes {f.pass_operands} operands, over the"
                f" budget of {ctx.max_fused_operands} operands per pass",
                plan=plan, wave=wave, unit=unit,
                die=f.dies[0] if f.dies else None)
        if f.pass_operands > max(f.n_operands, 1):
            raise PlanInvariantError(
                "vmem-budget",
                f"split of {f.pass_operands} operands/pass overruns"
                f" the {f.n_operands}-operand stack", plan=plan, wave=wave,
                unit=unit)


def check_encoding_consistency(plan, ctx: PlanContext) -> None:
    """All senses in a group share ONE ReadPlan (hence one encoding + one
    reference stack), and parity plans name their encoding in the label."""
    for gi, g in enumerate(plan.groups):
        wave = _wave_of_group(plan, gi)
        for it in g.items:
            if it.plan != g.plan or it.op_label != g.op_label \
                    or it.is_mcflash != g.is_mcflash or it.which != g.which:
                raise PlanInvariantError(
                    "encoding-consistency",
                    f"sense of {it.name!r} carries plan"
                    f" {it.plan.op!r}/{it.op_label!r} but its group is"
                    f" {g.plan.op!r}/{g.op_label!r} — one batched kernel"
                    " call cannot mix reference stacks", plan=plan,
                    wave=wave, unit=f"group[{gi}]",
                    die=g.dies[0] if g.dies else None)
            if it.dies != g.dies:
                raise PlanInvariantError(
                    "encoding-consistency",
                    f"sense of {it.name!r} on dies {it.dies} grouped under"
                    f" dies {g.dies}", plan=plan, wave=wave,
                    unit=f"group[{gi}]")
        if g.plan.kind == "parity" \
                and g.plan.op.split(":")[0] not in _PARITY_ENCODINGS:
            raise PlanInvariantError(
                "encoding-consistency",
                f"parity plan {g.plan.op!r} does not name its encoding"
                f" (expected one of {_PARITY_ENCODINGS}) — its cache/"
                "executable keys could alias across encodings", plan=plan,
                wave=wave, unit=f"group[{gi}]")


def check_ref_bounds(plan, ctx: PlanContext) -> None:
    """Reference stacks fit the kernels' MAX_REFS reference slot, carry the
    exact arity of their sensing mechanism, and parity combs are strictly
    monotone in valley order."""
    used = [(f"group[{gi}]", _wave_of_group(plan, gi), g.plan)
            for gi, g in enumerate(plan.groups)]
    used += [(f"fused[{si}]", _wave_of_step(plan, si), st.fused.plan)
             for si, st in enumerate(plan.steps) if st.fused is not None]
    for unit, wave, p in used:
        if p.kind not in (*_KIND_REFS, "parity"):
            raise PlanInvariantError(
                "ref-bounds", f"unknown sensing mechanism {p.kind!r}",
                plan=plan, wave=wave, unit=unit)
        if not 1 <= len(p.refs) <= ctx.max_refs:
            raise PlanInvariantError(
                "ref-bounds",
                f"plan {p.op!r} carries {len(p.refs)} references; the"
                f" kernels' reference slot holds 1..{ctx.max_refs}",
                plan=plan, wave=wave, unit=unit)
        if p.kind == "parity":
            if p.sensing_phases != len(p.refs):
                raise PlanInvariantError(
                    "ref-bounds",
                    f"parity plan {p.op!r} declares {p.sensing_phases}"
                    f" phases for {len(p.refs)} references (one strobe per"
                    " reference)", plan=plan, wave=wave, unit=unit)
            if any(a >= b for a, b in zip(p.refs, p.refs[1:])):
                raise PlanInvariantError(
                    "ref-bounds",
                    f"parity plan {p.op!r} references {p.refs} are not in"
                    " strictly monotone valley order — the band-pattern"
                    " compiler emits one ref per flip, low to high",
                    plan=plan, wave=wave, unit=unit)
        elif len(p.refs) != _KIND_REFS[p.kind]:
            raise PlanInvariantError(
                "ref-bounds",
                f"{p.kind!r} sensing takes exactly {_KIND_REFS[p.kind]}"
                f" references, plan {p.op!r} carries {len(p.refs)}",
                plan=plan, wave=wave, unit=unit)


def check_migration_barriers(plan, ctx: PlanContext) -> None:
    """Copyback programs scheduled into the wave timeline (block-migration
    relocations) only fill *idle* die slots: a program step with a
    non-negative wave must not touch any die a sense unit occupies in that
    wave, and its wave index must exist.  Lowering-time placement writes
    (wave ``-1``) complete before wave 0 and are exempt."""
    n_waves = len(plan.waves)
    for pi, pr in enumerate(getattr(plan, "programs", []) or []):
        if pr.wave < 0:
            continue
        unit = f"program[{pi}]"
        if pr.wave >= n_waves:
            raise PlanInvariantError(
                "migration-barrier",
                f"program step ({pr.label}) scheduled into wave {pr.wave}"
                f" but the plan has only {n_waves} wave(s)", plan=plan,
                wave=pr.wave, unit=unit)
        prog_dies = {ctx.die_of_plane(p) for p, _, _ in pr.wls}
        for kind, idx, dies, _ in _wave_units(plan, pr.wave):
            shared = prog_dies.intersection(dies)
            if shared:
                die = min(shared)
                raise PlanInvariantError(
                    "migration-barrier",
                    f"copyback program ({pr.label}) programs die {die} in"
                    f" wave {pr.wave} while {kind}[{idx}] senses the same"
                    " die — migration copybacks must fill idle die slots"
                    " only (program barrier against in-flight senses)",
                    plan=plan, wave=pr.wave, unit=unit, die=die)


def check_paranoid(plan, ctx: PlanContext) -> None:
    """Extra-cost audits (``verify="paranoid"``): recomputed concurrency,
    group-key uniqueness, and span layout of every batched sense output."""
    widest = 0
    for wi in range(len(plan.waves)):
        dies = set()
        for _, _, unit_dies, _ in _wave_units(plan, wi):
            dies.update(unit_dies)
        widest = max(widest, len(dies))
    if plan.concurrent_dies != widest:
        raise PlanInvariantError(
            "wave-die-disjoint",
            f"plan declares concurrent_dies={plan.concurrent_dies} but the"
            f" widest wave spans {widest} dies", plan=plan)
    keys = [g.plan_key if hasattr(g, "plan_key")
            else (g.plan, g.op_label, g.is_mcflash, g.which, g.dies)
            for g in plan.groups]
    if len(set(keys)) != len(keys):
        raise PlanInvariantError(
            "encoding-consistency",
            "two sense groups share one (plan, die) key — they should have"
            " merged into one batched kernel call", plan=plan)
    for gi, g in enumerate(plan.groups):
        spans = g.spans()
        cursor = 0
        for pid, (s, e) in spans:
            if s != cursor or e - s <= 0:
                raise PlanInvariantError(
                    "ledger-conservation",
                    f"group[{gi}] span for p{pid} is [{s}:{e}), expected"
                    f" to start at row {cursor}", plan=plan,
                    unit=f"group[{gi}]", wave=_wave_of_group(plan, gi))
            cursor = e
        if cursor != len(g.wls):
            raise PlanInvariantError(
                "ledger-conservation",
                f"group[{gi}] spans cover {cursor} rows of"
                f" {len(g.wls)} gathered", plan=plan, unit=f"group[{gi}]",
                wave=_wave_of_group(plan, gi))


def check_overlap_consistency(ledger, plan=None,
                              eps: float = 1e-9) -> None:
    """Overlap-mode ledger audit (a *timeline* invariant, over the booked
    :attr:`~repro_torch.api.Ledger.step_log` rather than the static plan): a
    wave's channel step may overlap only with **later** waves' die steps,
    never with its own producers.

    Concretely, for every logged channel step ``[t0, t1)``:

    - no die step booked *before* it (its producers — in booking order the
      executor emits a wave's die step, then its channel step) may still be
      running at ``t0``: a NAND->controller transfer cannot outrun the
      senses that produce its data;
    - any die step booked *after* it that overlaps ``[t0, t1)`` must belong
      to a strictly later wave of the same plan epoch (or a later epoch) —
      the double-buffered pipelining the overlap mode models.

    Runs only for the dependency-aware ledger modes (the independent mode
    intentionally free-runs its timelines); the executor invokes it after
    accounting each plan when verification is enabled.
    """
    if getattr(ledger, "mode", "independent") == "independent":
        return
    log = ledger.step_log
    for i, (kind, epoch, wave, t0, t1) in enumerate(log):
        if kind != "channel":
            continue
        for k2, e2, w2, s2, t2 in log[:i]:
            if k2 == "die" and t2 > t0 + eps:
                raise PlanInvariantError(
                    "overlap-consistency",
                    f"channel step of wave {wave} (epoch {epoch}) starts at"
                    f" {t0:.3f}us while a producing die step (wave {w2}) is"
                    f" still sensing until {t2:.3f}us — a transfer cannot"
                    " overlap its own producers", plan=plan, wave=wave)
        for k2, e2, w2, s2, t2 in log[i + 1:]:
            if k2 != "die" or s2 >= t1 - eps:
                continue
            # the die step overlaps this channel step: it must be from a
            # strictly later wave (same epoch) or a later plan epoch
            if e2 < epoch or (e2 == epoch and w2 is not None
                              and wave is not None and w2 <= wave):
                raise PlanInvariantError(
                    "overlap-consistency",
                    f"die step of wave {w2} (epoch {e2}) runs"
                    f" [{s2:.3f}, {t2:.3f})us inside the channel transfer of"
                    f" wave {wave} (epoch {epoch})"
                    f" [{t0:.3f}, {t1:.3f})us — a wave's transfer may"
                    " overlap only later waves' die work", plan=plan,
                    wave=wave)


def _wave_of_group(plan, gi: int) -> Optional[int]:
    for wi, wave in enumerate(plan.waves):
        if gi in wave.groups:
            return wi
    return None


def _wave_of_step(plan, si: int) -> Optional[int]:
    for wi, wave in enumerate(plan.waves):
        if si in wave.fused or si in wave.combines:
            return wi
    return None


#: ordered invariant catalog: conservation first (it establishes that the
#: wave lists are a complete, exactly-once booking of the plan's units,
#: which every later check walks), then the concurrency/race checks, then
#: the per-unit structural checks.
INVARIANTS: Tuple[Tuple[str, Callable], ...] = (
    ("ledger-conservation", check_ledger_conservation),
    ("wave-die-disjoint", check_wave_die_disjoint),
    ("slot-hazard", check_slot_hazards),
    ("schedule-topology", check_schedule_topology),
    ("vmem-budget", check_vmem_budget),
    ("encoding-consistency", check_encoding_consistency),
    ("ref-bounds", check_ref_bounds),
    ("migration-barrier", check_migration_barriers),
)
