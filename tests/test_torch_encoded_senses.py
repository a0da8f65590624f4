"""The session counters of encoded senses, and the span args that name an
encoding.

``encoded_sense_units`` counts the sense groups and fused units a dispatch
reads under a TLC or reduced-MLC plan, ``sensing_phases`` the sensing
phases of those units (the phases the ledger books).  Both count on the
runner's dispatch and on the recovery ladder's shifted re-run alike, and
stay 0 under MLC.  A traced ``launch`` span carries its units' encoding and
reference counts; ``program`` and ``program_draw`` spans carry the written
encoding and its pages a wordline.
"""
import pytest
import torch

from repro_torch.api.session import ComputeSession
from repro_torch.flash.geometry import SSDConfig

torch.set_num_threads(1)

CFG = dict(channels=1, dies_per_channel=4, page_kb=1)
N_BITS = 2 * 8192


@pytest.fixture(autouse=True)
def _plain_env(monkeypatch):
    monkeypatch.delenv("REPRO_VERIFY", raising=False)
    monkeypatch.delenv("REPRO_FAULTS", raising=False)


def _session(encoding, **kw):
    """Four stored groups (pairs, or triples under TLC) on dies 0..3."""
    width = 3 if encoding == "tlc" else 2
    gen = torch.Generator().manual_seed(7)
    sess = ComputeSession(device="cpu", config=SSDConfig(**CFG),
                          encoding=encoding, **kw)
    write = sess.write_triple if width == 3 else sess.write_pair
    groups = []
    for g in range(4):
        names = [f"g{g}c{j}" for j in range(width)]
        bits = (torch.rand((width, N_BITS), generator=gen) < 0.5).to(
            torch.uint8)
        write(*[x for n, b in zip(names, bits) for x in (n, b)], die=g)
        groups.append(names)
    return sess, groups


def _units(plan):
    return [g.plan for g in plan.groups] + [
        st.fused.plan for st in plan.steps if st.fused is not None]


@pytest.mark.parametrize("encoding", ["mlc", "tlc", "reduced-mlc"])
def test_encoded_units_and_their_phases_are_counted(encoding):
    sess, groups = _session(encoding, recovery=True)
    exprs = [sess.chain("and", groups[0]), sess.chain("or", groups[1]),
             sess.chain("xor", groups[2] + groups[3])]
    want_units = want_phases = 0
    for expr in exprs:
        units = _units(sess.lower(expr))
        if encoding != "mlc":
            want_units += len(units)
            want_phases += sum(p.sensing_phases for p in units)
        sess.popcount(expr)
        assert (sess.encoded_sense_units, sess.sensing_phases) == \
            (want_units, want_phases)
    if encoding == "tlc":
        # a 3-operand AND is ONE single-reference sense
        assert [len(p.refs) for p in _units(sess.lower(exprs[0]))] == [1]
    assert sess.stats()["sensing_phases"] == want_phases
    # the recovery ladder's shifted re-run counts like a dispatch
    plan = sess.lower(exprs[2])
    sess.reliability._execute_shifted(plan, 0.05, N_BITS, "retry")
    if encoding != "mlc":
        want_units += len(_units(plan))
        want_phases += sum(p.sensing_phases for p in _units(plan))
    assert (sess.encoded_sense_units, sess.sensing_phases) == \
        (want_units, want_phases)
    assert want_units > 0 or encoding == "mlc"


def test_launch_and_program_spans_name_the_encoding():
    spans = {}
    for encoding in ("mlc", "tlc"):
        sess, groups = _session(encoding, trace=True)
        sess.popcount(sess.chain("and", groups[0]))
        sess.popcount(sess.chain("and", groups[0] + groups[1]))
        sess.popcount(sess.chain("and", groups[0]) | sess.chain("or", groups[1]))
        spans[encoding] = sess.trace.wall_spans
    launches = [(s.args["encoding"], s.args["refs"])
                for s in spans["tlc"] if s.category == "launch"]
    # AND3 senses one reference; AND3 | OR3 is two units, OR3 brackets L5
    assert launches == [("tlc", [1]), ("tlc", [1]), ("tlc", [1, 2])]
    assert [s.args["encoding"] for s in spans["mlc"]
            if s.category == "launch"] == ["mlc"] * 3
    for encoding, pages in (("mlc", 2), ("tlc", 3)):
        for s in spans[encoding]:
            if s.category in ("program", "program_draw"):
                assert (s.args["encoding"], s.args["pages_per_wordline"]) \
                    == (encoding, pages), s.category
        assert sum(s.category == "program_draw" for s in spans[encoding]) == 4
