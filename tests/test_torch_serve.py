"""The port's serving engine against the JAX package's.

Both packages serve the quick workload of ``benchmarks/serve_latency.py``
(1 kB pages, 16 column bitmaps written as 8 MLC pairs over the dies, 24
requests of pair AND, pair XOR, 3-operand OR chain and popcount of an AND,
rng seed 11) through ``QueryEngine``: the JAX session on its ``sim``
backend, the port on ``device="cpu"``.  The coalescing counters
(``solo_waves``, batched waves, ``waves_shared``,
``coalesced_sense_groups``) are computed here for both and must be equal;
every result must equal the numpy oracle, and the words must equal the JAX
engine's once the port's arena holds the JAX arena's Vth rows.  Batching
is deterministic here: the delay bound is set beyond any run's length, so
only full batches and the final drain dispatch.
"""
import numpy as np
import pytest
import torch

from benchmarks.check_trace import check_trace
from benchmarks.serve_latency import _workload
from repro.api import ComputeSession as RefSession
from repro.flash.geometry import SSDConfig as RefConfig
from repro.serve import QueryEngine as RefEngine
from repro.serve import SLOConfig as RefSLO
from repro_torch.api.hostio import to_numpy
from repro_torch.api.session import ComputeSession
from repro_torch.flash.geometry import SSDConfig
from repro_torch.serve import QueryEngine, SLOConfig

torch.set_num_threads(1)

#: max_delay_us far beyond a run: batch formation depends on counts only
NO_DELAY_BOUND = 1e15


def _unpacked(words: np.ndarray, n_bits: int) -> np.ndarray:
    bits = np.unpackbits(np.ascontiguousarray(words).view(np.uint8),
                         bitorder="little")
    # lane-major layout: word w of a 4096-cell tile holds column k*128 + w
    return bits.reshape(-1, 128, 32).transpose(0, 2, 1).reshape(-1)[:n_bits]


def _serve(sess, engine_cls, slo, exprs, pcs):
    """The benchmark's loop: a warm-up pass, a stats reset, then a measured
    arrival loop (submit + poll) drained in order."""
    warm = engine_cls(sess, slo)
    warm.drain([warm.submit(e, popcount=pc) for e, pc in zip(exprs, pcs)])
    sess.reset_stats()
    sess.trace.clear()
    eng = engine_cls(sess, slo)
    tickets = []
    for expr, pc in zip(exprs, pcs):
        tickets.append(eng.submit(expr, popcount=pc))
        eng.poll()
    results = eng.drain(tickets)
    return eng, tickets, results


def _counters(sess, eng, solo_waves):
    st = eng.stats()
    return {"solo_waves": solo_waves, "waves": st["sense_waves"],
            "waves_shared": st["waves_shared"],
            "coalesced_sense_groups": st["coalesced_sense_groups"],
            "batches": st["batches_dispatched"],
            "completed": st["requests_completed"],
            "makespan_us": sess.ledger.makespan_us()}


def test_quick_workload_matches_reference(tmp_path):
    ref = RefSession(config=RefConfig(page_kb=1), backend="sim", trace=True)
    port = ComputeSession(device="cpu", config=SSDConfig(page_kb=1),
                          trace=True)
    r_exprs, r_pcs, oracles = _workload(ref, np.random.default_rng(11), 16, 24)
    p_exprs, p_pcs, _ = _workload(port, np.random.default_rng(11), 16, 24)
    assert p_pcs == r_pcs
    r_solo = sum(len(ref.lower(e).waves) for e in r_exprs)
    p_solo = sum(len(port.lower(e).waves) for e in p_exprs)
    r_eng, _, r_out = _serve(ref, RefEngine,
                             RefSLO(max_batch_requests=8, max_wait_batches=3,
                                    max_delay_us=NO_DELAY_BOUND),
                             r_exprs, r_pcs)
    p_eng, p_tickets, p_out = _serve(port, QueryEngine,
                                     SLOConfig(max_batch_requests=8,
                                               max_wait_batches=3,
                                               max_delay_us=NO_DELAY_BOUND),
                                     p_exprs, p_pcs)
    want = _counters(ref, r_eng, r_solo)
    got = _counters(port, p_eng, p_solo)
    assert got == want
    assert got["waves"] < got["solo_waves"] and got["waves_shared"] >= 1
    for out, r, pc, oracle in zip(p_out, r_out, p_pcs, oracles):
        if pc:
            assert out == r == int(oracle.sum())
        else:
            assert out.dtype == np.uint32
            np.testing.assert_array_equal(_unpacked(out, oracle.size), oracle)
    # per-request latency spans, rid-tagged wave spans: the trace checker's
    # serving audit passes on the port's export
    spans = [s for s in port.trace.wall_spans if s.category == "serve"]
    assert sorted(s.args["rid"] for s in spans) == [t.rid for t in p_tickets]
    # one span a batch, whose rids are its tickets'; no admission instants
    steps = [s for s in port.trace.wall_spans if s.category == "serve_step"]
    assert len(steps) == got["batches"]
    assert sorted(r for s in steps for r in s.args["rids"]) == \
        [t.rid for t in p_tickets]
    assert not any(e["name"] == "admit" for e in port.trace.instants)
    assert check_trace(port.trace.export(str(tmp_path / "serve.json")))

    # with the JAX arena's rows the words equal the JAX engine's
    port.device.load_vth({die: np.asarray(shard.buf)
                          for die, shard in ref.device.arena._shards.items()})
    slo = SLOConfig(max_batch_requests=8, max_delay_us=NO_DELAY_BOUND)
    eng = QueryEngine(port, slo)
    loaded = eng.drain([eng.submit(e, popcount=pc)
                        for e, pc in zip(p_exprs, p_pcs)])
    for out, r, pc in zip(loaded, r_out, p_pcs):
        if pc:
            assert out == r
        else:
            np.testing.assert_array_equal(out, np.asarray(r))


@pytest.mark.parametrize("encoding", ("tlc", "reduced-mlc"))
def test_batch_equals_solo_materialize(encoding):
    """A coalesced batch (sync and async) equals each expression
    materialized on its own, words and counts, under an 8-state encoding
    too; the batch lowers to one plan with one root per expression."""
    rng = np.random.default_rng(4)
    n = 2 * 8192 + 96
    bits = [(rng.random(n) < 0.5).astype(np.uint8) for _ in range(6)]
    sess = ComputeSession(device="cpu", encoding=encoding,
                          config=SSDConfig(page_kb=1, channels=1,
                                           dies_per_channel=2))
    a, b = sess.write_pair("a", bits[0], "b", bits[1])
    c, d = sess.write_pair("c", bits[2], "d", bits[3])
    e = sess.write("e", bits[4])
    exprs = [a & b, (a & b) | (c ^ d), sess.chain("or", [a, c, d]), ~e, a & b]
    pcs = [False, True, False, False, True]
    plan = sess.lower_batch(exprs, rids=list(range(5)))
    assert len(plan.all_roots) == 5
    solo = [sess.popcount(x) if pc else to_numpy(sess.materialize(x))
            for x, pc in zip(exprs, pcs)]
    batch = sess.materialize_batch(exprs, popcount=pcs)
    handles = sess.materialize_batch_async(exprs, popcount=pcs, rids=[7] * 5)
    assert [h.rid for h in handles] == [7] * 5
    for s, bt, h, pc in zip(solo, batch, handles, pcs):
        if pc:
            assert s == bt == int(h.result().reshape(-1)[0])
        else:
            np.testing.assert_array_equal(to_numpy(bt), s)
            np.testing.assert_array_equal(h.result(), s)
    with pytest.raises(ValueError, match="popcount flags"):
        sess.materialize_batch(exprs, popcount=[True])


def test_slo_policy_matches_reference():
    """Aging preemption, the queue-depth bound and the delay bound form the
    same batches in both engines; SLOConfig validates alike."""
    def run(session_cls, engine_cls, slo_cls, **kw):
        sess = session_cls(**kw)
        exprs, _, oracles = _workload(sess, np.random.default_rng(3), 8, 10)
        eng = engine_cls(sess, slo_cls(max_batch_requests=2,
                                       max_wait_batches=2,
                                       max_delay_us=NO_DELAY_BOUND,
                                       aging_weight=0.0, max_queue_depth=4))
        low = eng.submit(exprs[0], priority=0.0)
        shipped = []
        for i in range(1, 7, 2):
            eng.submit(exprs[i], priority=10.0)
            eng.submit(exprs[i + 1], priority=10.0)
            eng.step()
            shipped.append(low.dispatched)
        deep = [eng.submit(x) for x in exprs[7:10]]  # depth bound dispatches
        eng.drain()
        delayed = engine_cls(sess, slo_cls(max_batch_requests=8,
                                           max_delay_us=0.0))
        late = delayed.submit(exprs[1])
        assert delayed.poll() == 1 and late.dispatched
        delayed.drain([late])
        return (shipped, [t.batch for t in deep], low.batch,
                {k: v for k, v in eng.stats().items()},
                delayed.stats()["delay_bound_dispatches"])

    want = run(RefSession, RefEngine, RefSLO, config=RefConfig(page_kb=1),
               backend="sim")
    got = run(ComputeSession, QueryEngine, SLOConfig, device="cpu",
              config=SSDConfig(page_kb=1))
    assert got == want
    assert got[0] == [False, False, True] and got[3]["preempted_dispatches"]
    for bad in (dict(max_batch_requests=0), dict(max_wait_batches=0),
                dict(max_batch_requests=8, max_queue_depth=4)):
        with pytest.raises(ValueError):
            SLOConfig(**bad)
