"""Shared-row senses: one page list's rows read once for all its plans.

Where a plan's unfused sense groups read one page list on one stream more
than once (a range query senses each die's pair under two to five read
plans, and may sense one plan twice), the runner senses the list once
through ``mlc_sense_multi``, each distinct plan's words from that one
read.  The plain multi-plan sense is held against one ``mlc_sense`` per
plan; the runner against itself with the branch patched off (words,
ledger, makespan and every counter the port shares with the JAX package)
and against ``api/range_ref.py``; the counters against the plans that
must not engage it.
"""
import numpy as np
import pytest
import torch

from repro_torch.api import executor as executor_mod
from repro_torch.api import range_ref
from repro_torch.api.backends import Backend
from repro_torch.api.session import _SESSION_COUNTERS, ComputeSession
from repro_torch.core.calibration import shift_plan
from repro_torch.core.mcflash import plan_op
from repro_torch.core.vth_model import get_chip_model
from repro_torch.flash.device import FlashDevice
from repro_torch.flash.geometry import SSDConfig
from repro_torch.kernels import mlc_sense, ref
from repro_torch.kernels.rows import Rows

torch.set_num_threads(1)

ROWS = 8192
PAGE_BITS = 8192
#: 16 dies of one plane and 1 KiB pages: a slice is one wordline
CFG = dict(channels=4, dies_per_channel=4, planes_per_die=1, page_kb=1)
SHARED = ("shared_row_senses", "shared_row_items")


@pytest.fixture(autouse=True)
def _plain_env(monkeypatch):
    monkeypatch.delenv("REPRO_VERIFY", raising=False)
    monkeypatch.delenv("REPRO_FAULTS", raising=False)


def _no_shared_rows(monkeypatch):
    monkeypatch.setattr(executor_mod, "_row_sharing",
                        lambda plan, slots, kinds: ())


def _session(trace=False, **kw):
    return ComputeSession(device="cpu", config=SSDConfig(**CFG), seed=5,
                          trace=trace, **kw)


def _column(sess, width, seed):
    """A ``width``-bit column of uniform codes, slice pairs on dies 0, 1,
    ...: (slice names, int64 codes)."""
    gen = torch.Generator().manual_seed(seed)
    bits = [torch.randint(0, 2, (ROWS,), generator=gen, dtype=torch.uint8)
            for _ in range(width)]
    names = [f"v{width - 1 - i}" for i in range(width)]
    for j in range(0, width, 2):
        sess.write_pair(names[j], bits[j], names[j + 1], bits[j + 1],
                        die=j // 2)
    return names, range_ref.codes(bits)


def _ranges(width, n, seed=2013):
    w = int(0.1 * 2 ** width)
    los = np.random.default_rng(seed).integers(0, 2 ** width - w, size=n,
                                               endpoint=True)
    return [(int(lo), int(lo) + w - 1) for lo in los] + [
        (0, 2 ** width - 1), (7, 7), (2 ** (width - 1), 2 ** width - 2)]


def _counters(sess) -> dict:
    """Every session counter but the shared-row ones, and the executor's."""
    out = {name: getattr(sess, name) for name, _ in _SESSION_COUNTERS
           + (("max_concurrent_dies", ""),) if name not in SHARED}
    out["executor"] = sess.executor.stats()
    return out


def test_plain_multi_sense_equals_one_sense_per_plan():
    """lsb, msb and sbr, inverse reads, Table-1 plans and their shifted
    references, a plan twice; dense rows, out-of-order ragged tables over
    two shards, and 40 tables: each plane equals ``mlc_sense`` under its
    plan.  Parity reads are refused."""
    gen = torch.Generator().manual_seed(35)
    chip = get_chip_model()
    table1 = [plan_op(op, chip) for op in
              ("and", "or", "xnor", "nand", "nor", "xor", "not")]
    plans = (table1 + [shift_plan(p, dv) for p in table1[:4]
                       for dv in (-0.12, 0.07)]
             + [plan_op("and", chip)])
    assert len(plans) > 8 and {p.kind for p in plans} == {"lsb", "msb", "sbr"}
    shards = [torch.randn(n, PAGE_BITS, generator=gen) * 2 + 2
              for n in (9, 6)]
    tables = [torch.tensor(t, dtype=torch.int32)
              for t in ([4, 0, 8], [5, 5, 1, 0], [7], [2, 3])]
    ragged = Rows([shards[0], shards[1], shards[0], shards[1]], tables)
    many = Rows([shards[i % 2] for i in range(40)],
                [torch.tensor([i % 6, 5 - i % 6][:1 + i % 2],
                              dtype=torch.int32) for i in range(40)])
    backend = Backend(torch.device("cpu"))
    for vth in (shards[0], ragged, many):
        n_rows = vth.shape[0] if isinstance(vth, torch.Tensor) else vth.n_rows
        got = backend.sense_multi(vth, plans)
        assert got.shape == (len(plans), n_rows, PAGE_BITS // 32)
        for k, p in enumerate(plans):
            assert torch.equal(got[k], backend.sense(vth, p)), (k, p)
        triples = [(p.refs, p.kind, p.uses_inverse) for p in plans[:3]]
        dense = vth if isinstance(vth, torch.Tensor) else vth.gather()
        assert torch.equal(mlc_sense.mlc_sense_multi(vth, triples),
                           ref.mlc_sense_multi(dense, triples))
    with pytest.raises(ValueError, match="read kinds"):
        mlc_sense.mlc_sense_multi(shards[0], [([1.0], "parity", False)])
    with pytest.raises(ValueError, match="read kinds"):
        mlc_sense.mlc_sense_multi(shards[0], [])


def test_between_counts_and_the_books_equal_the_unshared_runner(monkeypatch):
    """Range queries over a 16-bit column (8 pairs on 8 dies), placed and
    unplaced: each count equals range_ref's, the words of each predicate
    equal those of a session with the shared-row branch patched off, and
    so do the ledger's summary and makespan and every counter the port
    shares with the JAX package.  A die holding two more pairs keeps, in
    its AND group, the items of the pairs no other group reads."""
    cases = _ranges(16, 6)
    runs = {}
    for shared in (True, False):
        for placed in (False, True):
            with monkeypatch.context() as m:
                if not shared:
                    _no_shared_rows(m)
                flash = None
                if placed:
                    flash = FlashDevice(shard_devices=["cpu"] * 4,
                                        device="cpu", config=SSDConfig(**CFG),
                                        seed=5)
                sess = (ComputeSession(flash=flash) if placed
                        else _session())
                names, v = _column(sess, 16, 3)
                m3, m5, m7, m11 = (v.remainder(k).eq(0) for k in (3, 5, 7,
                                                                  11))
                a, b = sess.write_pair("a", m3.to(torch.uint8), "b",
                                       m5.to(torch.uint8), die=0)
                c, d = sess.write_pair("c", m7.to(torch.uint8), "d",
                                       m11.to(torch.uint8), die=0)
                words, counts = [], []
                for lo, hi in cases:
                    expr = sess.between(names, lo, hi)
                    counts.append(expr.popcount())
                    words.append(sess.materialize(expr))
                    assert counts[-1] == range_ref.count(v, lo, hi), (lo, hi)
                top = sess.ftl.vectors[names[0]]
                h, l_ = sess[names[0]], sess[names[1]]
                mixed = (h & l_) ^ (h | l_) ^ (a & b) ^ (c & d)
                words.append(sess.materialize(mixed))
                want = ((v >> 15 & 1) ^ (v >> 14 & 1)) ^ (
                    (m3 & m5) ^ (m7 & m11)).long()
                assert torch.equal(
                    sess.materialize(mixed, unpacked=True).long(), want)
                runs[shared, placed] = (counts, words, sess.ledger.summary(),
                                        sess.ledger.makespan_us(),
                                        _counters(sess), sess.stats())
                assert top.pages == sess.ftl.vectors[names[0]].pages
    for placed in (False, True):
        on, off = runs[True, placed], runs[False, placed]
        assert on[0] == off[0]
        assert all(torch.equal(x, y) for x, y in zip(on[1], off[1]))
        assert on[2:5] == off[2:5]
        assert on[5]["shared_row_senses"] > 0
        assert off[5]["shared_row_senses"] == 0
        assert on[5]["shared_row_items"] > on[5]["shared_row_senses"]
    assert runs[True, False][0] == runs[True, True][0]


def _pairs(sess, k, seed, die=None):
    rng = np.random.default_rng(seed)
    out, host = [], []
    for i in range(k):
        bits = [(rng.random(ROWS) < 0.7).astype(np.uint8) for _ in range(2)]
        out += sess.write_pair(f"p{seed}x{i}", bits[0], f"p{seed}y{i}",
                               bits[1], die=i if die is None else die)
        host += bits
    return out, [x.astype(bool) for x in host]


def test_counters_engage_only_where_rows_are_read_twice():
    """A between count engages the branch (one call a die whose pair is
    sensed under two plans or twice, its items served, a ``plans`` list on
    the ``launch`` span); a fused chain count, a counted single-sense root
    and a drained single-sense root do not."""
    sess = _session(trace=True)
    names, v = _column(sess, 32, 1)
    lo, hi = _ranges(32, 1)[0]
    assert sess.between(names, lo, hi).popcount() == range_ref.count(v, lo,
                                                                     hi)
    st = sess.stats()
    calls, items = st["shared_row_senses"], st["shared_row_items"]
    assert 8 <= calls <= 16 and items >= 2 * calls - 1
    assert items <= st["sense_items"]
    spans = [s for s in sess.trace.wall_spans if s.category == "launch"]
    assert len(spans[-1].args["plans"]) == calls
    assert all(1 <= p <= 8 for p in spans[-1].args["plans"])

    quiet = _session(trace=True)
    vecs, host = _pairs(quiet, 6, 7)
    chain = quiet.chain("and", vecs)
    assert chain.popcount() == int(np.logical_and.reduce(host).sum())
    assert quiet.megakernel_calls == 1
    assert (vecs[0] & vecs[1]).popcount() == int((host[0] & host[1]).sum())
    assert quiet.sense_counted_roots == 1
    quiet.materialize_async(vecs[2] | vecs[3]).result()
    assert quiet.pipelined_drains == 1
    assert (quiet.shared_row_senses, quiet.shared_row_items) == (0, 0)
    assert all("plans" not in s.args for s in quiet.trace.wall_spans
               if s.category == "launch")


def test_recovery_reruns_a_between_plan_through_shared_rows():
    """The recovery ladder's shifted re-run of a between plan builds its
    runner through the same branch: at offset 0 its words equal
    ``materialize``'s, and at a small shift equal those of a re-run with
    the branch off; it books no shared-row counter."""
    sess = _session(recovery=True)
    names, v = _column(sess, 16, 11)
    lo, hi = _ranges(16, 1, seed=5)[0]
    expr = sess.between(names, lo, hi)
    want = sess.materialize(expr)
    plan = sess.lower(expr)
    n_bits = expr.n_bits
    assert len(sess.executor.row_sharing(plan, None)) > 0
    before = (sess.shared_row_senses, sess.shared_row_items)
    got = {dv: sess.reliability._execute_shifted(plan, dv, n_bits, "retry")
           for dv in (0.0, 0.04)}
    assert torch.equal(got[0.0], want)
    assert (sess.shared_row_senses, sess.shared_row_items) == before
    real = executor_mod._row_sharing
    executor_mod._row_sharing = lambda plan, slots, kinds: ()
    try:
        unshared = sess.reliability._execute_shifted(plan, 0.04, n_bits,
                                                     "retry")
    finally:
        executor_mod._row_sharing = real
    assert torch.equal(got[0.04], unshared)
    bits = ref.unpack_bits(want.reshape(1, -1))[0][:n_bits]
    assert int(bits.sum()) == range_ref.count(v, lo, hi)


def test_plans_that_share_rows_differently_build_their_own_runners():
    """``(a&b)^(a|b)`` senses one pair's rows under two plans;
    ``(a&b)^(c|d)`` has the same signature (same plans, page counts and
    die topology, both pairs on one die) but reads two pairs.  Each
    equals numpy, the second builds its own runner and shares nothing,
    and replaying the first shares again."""
    sess = _session()
    vecs, host = _pairs(sess, 2, 13, die=0)
    a, b, c, d = vecs
    ha, hb, hc, hd = host
    one, two = (a & b) ^ (a | b), (a & b) ^ (c | d)
    assert (sess.lower(one).signature("sim")
            == sess.lower(two).signature("sim"))
    for expr, want, shared in ((one, (ha & hb) ^ (ha | hb), (1, 2)),
                               (two, (ha & hb) ^ (hc | hd), (0, 0)),
                               (one, (ha & hb) ^ (ha | hb), (1, 2))):
        before = (sess.shared_row_senses, sess.shared_row_items)
        got = sess.materialize(expr, unpacked=True).numpy().astype(bool)
        np.testing.assert_array_equal(got, want)
        assert (sess.shared_row_senses - before[0],
                sess.shared_row_items - before[1]) == shared
    assert sess.executor.stats()["traces"] == 2
