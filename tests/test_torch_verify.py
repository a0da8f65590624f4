"""The port's static plan verifier against the JAX package's.

Both packages lower the plan corpus (every Table-1 pair op, NOT, fused
chains, mixed multi-wave DAGs, die-contended and scattered operands, seeded
random DAGs) for mlc / tlc / reduced-mlc x {1, 2, 4} dies, in paranoid
mode.  Every plan must pass in both and have the same structure.  Then the
same seeded schedule corruptions are applied to both packages' plans, and
each must be rejected by the same invariant in both.  Sessions in both
packages verify by default (``"on"``) and follow ``$REPRO_VERIFY``.
"""
import copy
import dataclasses

import numpy as np
import pytest
import torch

from repro.api import ComputeSession as RefSession
from repro.api.executor import ProgramStep as RefProgramStep
from repro.flash.geometry import SSDConfig as RefConfig
from repro.verify import PlanInvariantError as RefPlanInvariantError
from repro.verify import check_plan as ref_check_plan
from repro.verify.corpus import iter_corpus as ref_iter_corpus
from repro_torch.api.executor import ProgramStep
from repro_torch.api.session import ComputeSession
from repro_torch.flash.geometry import SSDConfig
from repro_torch.verify import PlanInvariantError, check_plan
from repro_torch.verify.corpus import iter_corpus

torch.set_num_threads(1)

ENCODINGS = ("mlc", "tlc", "reduced-mlc")


def _read_plan(p):
    return (p.op, p.kind, tuple(p.refs), p.sensing_phases, p.uses_inverse)


def _shape(plan):
    """Everything a lowered plan says, with ReadPlans as plain tuples."""
    return (
        [(_read_plan(g.plan), g.op_label, g.is_mcflash, g.which, g.dies,
          [(it.pid, it.name, it.wls, it.rids) for it in g.items])
         for g in plan.groups],
        [(st.out, st.args, st.op, st.invert,
          None if st.fused is None else (
              _read_plan(st.fused.plan), st.fused.op_label, st.fused.wls,
              st.fused.n_operands, st.fused.n_pages, st.fused.dies,
              st.fused.pass_operands))
         for st in plan.steps],
        [(w.groups, w.fused, w.combines) for w in plan.waves],
        [(pr.label, pr.wls, pr.dies, pr.wave) for pr in plan.programs],
        (plan.root, plan.out_pages, plan.out_words, plan.senses, plan.items,
         plan.concurrent_dies, plan.roots, plan.roots_words))


# -- mutation classes: each corrupts a deep copy to break ONE invariant, or
# returns None when the plan has no site for it.  ``pstep`` is the package's
# ProgramStep class.

def _sense_wave_of(plan, wl):
    for wi, wave in enumerate(plan.waves):
        if any(wl in plan.groups[gi].wls for gi in wave.groups):
            return wi
        if any(wl in plan.steps[si].fused.wls for si in wave.fused):
            return wi
    return None


def mutate_unbook_wave(plan, ctx, rng, pstep):
    m = copy.deepcopy(plan)
    for wave in m.waves:
        if wave.groups:
            wave.groups.pop(rng.integers(0, len(wave.groups)))
            return m
    return None


def mutate_merge_same_die_wave(plan, ctx, rng, pstep):
    m = copy.deepcopy(plan)
    first_wave_of_die = {}
    for wi, wave in enumerate(m.waves):
        for gi in list(wave.groups):
            for die in m.groups[gi].dies:
                w0 = first_wave_of_die.setdefault(die, wi)
                if w0 < wi:
                    wave.groups.remove(gi)
                    m.waves[w0].groups.append(gi)
                    return m
    return None


def mutate_drop_program_barrier(plan, ctx, rng, pstep):
    m = copy.deepcopy(plan)
    for pr in m.programs:
        for wl in pr.wls:
            wi = _sense_wave_of(m, wl)
            if wi is not None:
                pr.wave = wi
                return m
    return None


def mutate_move_combine_early(plan, ctx, rng, pstep):
    m = copy.deepcopy(plan)
    late = set()
    for wave in m.waves[1:]:
        for gi in wave.groups:
            late.update(it.pid for it in m.groups[gi].items)
        late.update(m.steps[si].out for si in wave.fused + wave.combines)
    for wave in m.waves[1:]:
        for ci in list(wave.combines):
            if any(a in late and m.steps[ci].out != a
                   for a in m.steps[ci].args):
                wave.combines.remove(ci)
                m.waves[0].combines.insert(0, ci)
                return m
    return None


def mutate_inflate_fused_split(plan, ctx, rng, pstep):
    """One operand per pass more than the fused-pass budget (32 in both
    packages: the JAX one derives it from its 4 MiB VMEM budget)."""
    m = copy.deepcopy(plan)
    for st in m.steps:
        if st.fused is not None:
            st.fused.pass_operands = ctx.max_fused_operands + 1
            return m
    return None


def mutate_cross_plan_group(plan, ctx, rng, pstep):
    m = copy.deepcopy(plan)
    for g in m.groups:
        if g.items:
            it = g.items[0]
            it.plan = dataclasses.replace(it.plan, op=it.plan.op + "-alien")
            return m
    return None


def mutate_ref_overflow(plan, ctx, rng, pstep):
    m = copy.deepcopy(plan)
    refs = tuple(0.1 * (i + 1) for i in range(ctx.max_refs + 1))
    for g in m.groups:
        fat = dataclasses.replace(g.plan, refs=refs, sensing_phases=len(refs))
        g.plan = fat
        for it in g.items:
            it.plan = fat
        return m
    return None


def mutate_program_into_busy_wave(plan, ctx, rng, pstep):
    m = copy.deepcopy(plan)
    for wi, wave in enumerate(m.waves):
        if not wave.groups:
            continue
        plane, blk, wl = m.groups[wave.groups[0]].wls[0]
        m.programs.append(pstep(label="copyback mutant",
                                wls=[(plane, blk, wl + 10_000)],
                                dies=(ctx.die_of_plane(plane),), wave=wi))
        return m
    return None


MUTATIONS = (mutate_unbook_wave, mutate_merge_same_die_wave,
             mutate_drop_program_barrier, mutate_move_combine_early,
             mutate_inflate_fused_split, mutate_cross_plan_group,
             mutate_ref_overflow, mutate_program_into_busy_wave)


def _rejected_by(check, error, plan, ctx):
    with pytest.raises(error) as exc:
        check(plan, ctx)
    return exc.value.invariant


@pytest.mark.parametrize("encoding", ENCODINGS)
def test_corpus_and_mutations_match_reference(encoding):
    """Every corpus plan passes (paranoid) in both packages with the same
    structure; every mutation class is rejected by the same invariant in
    both, and each applies to at least one plan of the encoding."""
    applied = {m.__name__: 0 for m in MUTATIONS}
    for dies in (1, 2, 4):
        ref_corpus = list(ref_iter_corpus(encoding, dies, seed=0))
        port_corpus = list(iter_corpus(encoding, dies, 0, device="cpu"))
        assert [c[0] for c in port_corpus] == [c[0] for c in ref_corpus]
        for (label, r_sess, r_expr), (_, p_sess, p_expr) in zip(
                ref_corpus, port_corpus):
            r_plan, p_plan = r_sess.lower(r_expr), p_sess.lower(p_expr)
            assert _shape(p_plan) == _shape(r_plan), (encoding, dies, label)
            r_ctx, p_ctx = r_sess.plan_context(), p_sess.plan_context()
            assert p_ctx.max_fused_operands == r_ctx.max_fused_operands == 32
            assert p_ctx.max_refs == r_ctx.max_refs == 8
            for mutate in MUTATIONS:
                r_mut = mutate(r_plan, r_ctx, np.random.default_rng(dies),
                               RefProgramStep)
                p_mut = mutate(p_plan, p_ctx, np.random.default_rng(dies),
                               ProgramStep)
                assert (p_mut is None) == (r_mut is None), mutate.__name__
                if p_mut is None:
                    continue
                applied[mutate.__name__] += 1
                want = _rejected_by(ref_check_plan, RefPlanInvariantError,
                                    r_mut, r_ctx)
                got = _rejected_by(check_plan, PlanInvariantError, p_mut,
                                   p_ctx)
                assert got == want, (mutate.__name__, label, got, want)
                check_plan(p_plan, p_ctx)       # the copy did not alias
        stats = port_corpus[0][1].stats()
        assert stats["verify"]["mode"] == "paranoid"
        assert stats["plans_verified"] == len(port_corpus)
    assert all(applied.values()), applied


def test_default_mode_and_fused_pass_budget_match_reference(monkeypatch):
    """Both packages verify by default (``"on"``, memoized by signature),
    take the mode from ``$REPRO_VERIFY``, and reject unknown modes.  A
    33-operand chain splits into passes of at most 32 operands in both, and
    a split declaring all 33 in one pass is over the budget in both."""
    cfg = dict(page_kb=1, channels=1, dies_per_channel=2)
    rng = np.random.default_rng(11)
    bits = [(rng.random(8192) < 0.5).astype(np.uint8) for _ in range(2)]
    monkeypatch.delenv("REPRO_VERIFY", raising=False)
    for mode in (None, "paranoid", "off"):
        if mode is not None:
            monkeypatch.setenv("REPRO_VERIFY", mode)
        ref = RefSession(config=RefConfig(**cfg), backend="sim")
        port = ComputeSession(device="cpu", config=SSDConfig(**cfg))
        assert port.verifier.mode == ref.verifier.mode == (mode or "on")
        for sess in (ref, port):
            a, b = sess.write_pair("a", bits[0], "b", bits[1])
            sess.materialize(a & b)
            sess.materialize(a & b)
            sess.popcount(a | b)
        r, p = ref.stats(), port.stats()
        for key in ("plans_verified", "verify_cache_hits"):
            assert p[key] == r[key], (mode, key)
        assert p["verify"]["mode"] == r["verify"]["mode"]
        assert p["plans_verified"] == {None: 2, "paranoid": 3, "off": 0}[mode]
    with pytest.raises(ValueError, match="verify mode"):
        ComputeSession(device="cpu", config=SSDConfig(**cfg),
                       verify="sometimes")

    monkeypatch.delenv("REPRO_VERIFY")
    bits = [(rng.random(4096) < 0.5).astype(np.uint8) for _ in range(66)]
    ref = RefSession(config=RefConfig(**cfg), backend="sim")
    port = ComputeSession(device="cpu", config=SSDConfig(**cfg))
    plans = []
    for sess in (ref, port):
        for i in range(0, 66, 2):
            sess.write_pair(f"v{i}", bits[i], f"v{i + 1}", bits[i + 1])
        plans.append(sess.lower(sess.chain("and", [f"v{i}"
                                                    for i in range(66)])))
    assert _shape(plans[1]) == _shape(plans[0])
    (fused,) = [st.fused for st in plans[1].steps if st.fused is not None]
    assert (fused.n_operands, fused.pass_operands) == (33, 32)
    for sess, plan, check, error in ((ref, plans[0], ref_check_plan,
                                      RefPlanInvariantError),
                                     (port, plans[1], check_plan,
                                      PlanInvariantError)):
        over = copy.deepcopy(plan)
        for st in over.steps:
            if st.fused is not None:
                st.fused.pass_operands = 33
        assert _rejected_by(check, error, over, sess.plan_context()) == \
            "vmem-budget"
