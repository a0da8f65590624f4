"""One wave walk: the recovery ladder's shifted re-run runs a plan through
the executor's runner and books it from the executor's wave costs.

At offset 0 the re-run must return the words the primary dispatch
materializes and book, wave for wave, the same die and channel values in
the same key order (and the same energy and commands), under the
``recovery`` category; it builds its runner uncached, so it counts no trace
and no cache miss.  A shifted re-run books the same costs (a shift keeps
each plan's sensing phases) and leaves the lowered plan's read plans as
they were.  Three plans: MLC pair senses on two dies under a controller
combine, a 33-pair AND chain whose fused step splits into two passes, and
a TLC triple AND.
"""
import numpy as np
import pytest
import torch

from repro_torch.api.executor import MAX_FUSED_OPERANDS
from repro_torch.api.session import ComputeSession
from repro_torch.flash.geometry import SSDConfig

torch.set_num_threads(1)

N_BITS = 8192 + 100              # two 1 kB pages, a ragged tail


@pytest.fixture(autouse=True)
def _plain_env(monkeypatch):
    monkeypatch.delenv("REPRO_VERIFY", raising=False)
    monkeypatch.delenv("REPRO_FAULTS", raising=False)


def _bits(rng, p=0.5):
    return (rng.random(N_BITS) < p).astype(np.uint8)


def _plan_case(case):
    """A recovery-enabled CPU session and the expression of one case."""
    rng = np.random.default_rng(29)
    encoding = "tlc" if case == "tlc-and3" else "mlc"
    sess = ComputeSession(device="cpu", encoding=encoding, recovery=True,
                          config=SSDConfig(channels=1, dies_per_channel=2,
                                           page_kb=1))
    if case == "pairs-combine":
        a, b = sess.write_pair("a", _bits(rng), "b", _bits(rng), die=0)
        c, d = sess.write_pair("c", _bits(rng), "d", _bits(rng), die=1)
        return sess, (a & b) | (c ^ d)
    if case == "and-chain-split":
        names = [f"v{i}" for i in range(2 * (MAX_FUSED_OPERANDS + 1))]
        for i in range(0, len(names), 2):
            sess.write_pair(names[i], _bits(rng, 0.99),
                            names[i + 1], _bits(rng, 0.99))
        return sess, sess.chain("and", names)
    x, y, z = sess.write_triple("x", _bits(rng), "y", _bits(rng),
                                "z", _bits(rng))
    return sess, x & y & z


def _spy(ledger, monkeypatch):
    """Record every die and channel step the ledger books."""
    steps = []
    for kind, category in (("add_die_batch", "sense"),
                           ("add_channel_batch", "dma")):
        real = getattr(ledger, kind)

        def spy(per, *args, _real=real, _kind=kind, _category=category,
                **kw):
            steps.append((_kind, list(per.items()), args, kw.get("commands"),
                          kw.get("category", _category)))
            return _real(per, *args, **kw)

        monkeypatch.setattr(ledger, kind, spy)
    return steps


@pytest.mark.parametrize("case",
                         ["pairs-combine", "and-chain-split", "tlc-and3"])
def test_shifted_rerun_runs_and_books_the_dispatch_walk(case, monkeypatch):
    sess, expr = _plan_case(case)
    ex = sess.executor
    plan = sess.lower(expr)
    refs = [g.plan.refs for g in plan.groups] + [
        st.fused.plan.refs for st in plan.steps if st.fused is not None]
    if case == "and-chain-split":
        assert [st.fused.n_operands for st in plan.steps
                if st.fused is not None] == [MAX_FUSED_OPERANDS + 1]
    steps = _spy(sess.ledger, monkeypatch)
    want = sess.materialize(expr)
    primary = list(steps)
    assert [s[4] for s in primary] == ["sense", "dma"] * len(plan.waves)
    traces, misses = ex.traces, ex.cache.misses
    for dv in (0.0, 0.05):
        del steps[:]
        got = sess.reliability._execute_shifted(plan, dv, N_BITS, "retry")
        if dv == 0.0:
            assert torch.equal(got, want)
        assert [s[:4] for s in steps] == [s[:4] for s in primary]
        assert {s[4] for s in steps} == {"recovery"}
    assert (ex.traces, ex.cache.misses) == (traces, misses)
    assert [g.plan.refs for g in plan.groups] + [
        st.fused.plan.refs for st in plan.steps
        if st.fused is not None] == refs
