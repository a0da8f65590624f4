"""``ComputeSession.between``: range predicates over bit-sliced columns.

A b-bit code column is stored as b bit-slice vectors, adjacent slices as
MLC pairs.  ``between(slices, lo, hi)`` lowers ``lo <= v <= hi`` to pair
senses, page reads and controller combines (``api/predicates.py``) on the
port's normal path; the counts are held against the plain reference
``api/range_ref.py``.  No constant may make an ``ftl`` span (copyback
realignment or a NOT-ready copy), move a stored vector or add a derived
NOT placement.
"""
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro_torch.api import predicates, range_ref
from repro_torch.api.session import ComputeSession
from repro_torch.flash.ftl import FTL
from repro_torch.flash.geometry import SSDConfig

torch.set_num_threads(1)

ROWS = 8192
#: 16 dies of one plane and 1 KiB pages: a slice is one wordline
CFG = dict(channels=4, dies_per_channel=4, planes_per_die=1, page_kb=1)


@pytest.fixture(autouse=True)
def _plain_env(monkeypatch):
    monkeypatch.delenv("REPRO_VERIFY", raising=False)
    monkeypatch.delenv("REPRO_FAULTS", raising=False)


def _column(sess, prefix, width, seed, lone=None):
    """Store a ``width``-bit column of uniform codes; slice i (MSB first)
    pairs with slice i + 1, except ``lone`` ("top" or "bottom"), written
    alone.  Returns (slice names, int64 codes from range_ref)."""
    gen = torch.Generator().manual_seed(seed)
    bits = [torch.randint(0, 2, (ROWS,), generator=gen, dtype=torch.uint8)
            for _ in range(width)]
    names = [f"{prefix}{width - 1 - i}" for i in range(width)]
    first = 0
    if lone == "top":
        sess.write(names[0], bits[0], die=15)
        first = 1
    stop = width - 1 if lone == "bottom" else width
    for j in range(first, stop, 2):
        sess.write_pair(names[j], bits[j], names[j + 1], bits[j + 1],
                        die=(j // 2) % 16)
    if lone == "bottom":
        sess.write(names[-1], bits[-1], die=15)
    return names, range_ref.codes(bits)


def _session(trace=False):
    return ComputeSession(device="cpu", config=SSDConfig(**CFG), seed=5,
                          trace=trace)


@pytest.fixture(scope="module")
def columns():
    sess = _session()
    cols = {"u32": _column(sess, "a", 32, 1),
            "u9-low": _column(sess, "b", 9, 2, lone="bottom"),
            "u9-high": _column(sess, "c", 9, 3, lone="top")}
    return sess, cols


def _edges(width):
    top = 2 ** width - 1
    half = 2 ** (width - 1)
    return [(0, top), (0, 0), (top, top), (half - 1, half - 1), (5, 4),
            (top, 0), (-3, 2), (top - 1, top + 9), (0, half - 1),
            (half, top), (1, top - 1)]


@settings(max_examples=30, deadline=None, database=None)
@given(data=st.data())
def test_between_counts_equal_the_plain_reference(columns, data):
    """32-bit and 9-bit columns (a lone slice at either end): edge
    constants (0, the maximum, lo == hi, lo > hi, the halves) and random
    ones, each count equal to range_ref's."""
    sess, cols = columns
    key = data.draw(st.sampled_from(sorted(cols)))
    names, v = cols[key]
    top = 2 ** len(names) - 1
    bound = st.integers(0, top)
    lo, hi = data.draw(st.one_of(st.sampled_from(_edges(len(names))),
                                 st.tuples(bound, bound)))
    got = sess.between(names, lo, hi).popcount()
    assert got == range_ref.count(v, lo, hi), (key, lo, hi)


def test_no_constant_realigns_or_copies():
    """Every 3-digit constant pattern (4^3) at each of the 4 positions of
    a 12-bit column (6 pair digits), as lo and as hi, plus the edge
    constants (hi = 2^11 - 1: ``v > hi`` is one bare page): counts right,
    no ``ftl`` span, every stored vector where it was, no derived NOT."""
    sess = _session(trace=True)
    names, v = _column(sess, "v", 12, 7)
    placed = {n: list(m.pages) for n, m in sess.ftl.vectors.items()}
    assert len(predicates.digits(sess.ftl, names)) == 6
    rng = np.random.default_rng(12)
    cases = list(_edges(12))
    for pos in range(4):
        for i, pattern in enumerate(np.ndindex(4, 4, 4)):
            fill = (0, 3, None)[i % 3]
            digs = [int(x) if fill is None else fill
                    for x in rng.integers(0, 4, 6)]
            digs[pos:pos + 3] = pattern
            c = sum(d << (2 * (5 - j)) for j, d in enumerate(digs))
            cases += [(c, 4095), (0, c)]
    for lo, hi in cases:
        assert sess.between(names, lo, hi).popcount() == \
            range_ref.count(v, lo, hi), (lo, hi)
    assert [s.name for s in sess.trace.wall_spans if s.category == "ftl"] == []
    assert {n: list(m.pages) for n, m in sess.ftl.vectors.items()} == placed
    assert not any(FTL.derived_not_name(n) in sess.ftl.vectors for n in names)
    assert sess.between_predicates == len(cases)


def test_the_predicate_span_and_counters():
    sess = _session(trace=True)
    names, _ = _column(sess, "w", 6, 9)
    expr = sess.between(names, 9, 40)
    spans = [s for s in sess.trace.wall_spans if s.category == "predicate"]
    assert len(spans) == 1 and spans[0].name == "between"
    assert spans[0].args == {"digits": 3, "lo": 9, "hi": 40}
    nodes = predicates.count_nodes(expr)
    assert nodes > 0
    st_ = sess.stats()
    assert (st_["between_predicates"], st_["between_nodes"]) == (1, nodes)
    empty = sess.between(names, 3, 2)
    assert sess.between_predicates == 2
    assert sess.between_nodes == nodes + predicates.count_nodes(empty)
    assert empty.popcount() == 0
    sess.reset_stats()
    assert (sess.between_predicates, sess.between_nodes) == (0, 0)
