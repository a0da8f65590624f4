"""The port's wall-clock spans: cause links, exact totals, and the spans
the executor, the serving engine, the drain queue and programming record.

``Tracer.totals`` holds, per category, the count, the time and the self
time (duration less the direct children's) of every wall span closed,
whether or not the span cap stored it and across ``clear()``.  Each span
names the span open around it (``parent``).  A traced CPU workload yields
each of the port's own categories as many times as its calls imply, and on
the serving path one request id links its lowering, dispatch, batch and
drain spans.
"""
from collections import Counter

import numpy as np
import pytest
import torch

from repro_torch.api.session import ComputeSession
from repro_torch.flash.geometry import SSDConfig
from repro_torch.obs import Tracer
from repro_torch.serve import QueryEngine, SLOConfig

torch.set_num_threads(1)

CONFIG = dict(page_kb=1, channels=1, dies_per_channel=2)


class _Clock:
    """A tracer clock that moves only when told to."""

    def __init__(self):
        self.us = 0.0

    def __call__(self):
        return self.us


def _clocked(max_spans=200_000):
    tracer = Tracer(max_spans=max_spans)
    clock = _Clock()
    tracer._now_us = clock
    return tracer, clock


def _bits(n_vectors, n_bits, seed=3):
    rng = np.random.default_rng(seed)
    return [(rng.random(n_bits) < 0.5).astype(np.uint8)
            for _ in range(n_vectors)]


def test_totals_stay_exact_past_the_cap_and_across_clear():
    tracer, clock = _clocked(max_spans=5)
    for i in range(12):
        with tracer.span("outer", f"o{i}"):
            clock.us += 1.0
            with tracer.span("inner", "i"):
                clock.us += 2.0
    assert len(tracer.wall_spans) == 5 and tracer.dropped == 19
    assert tracer.totals == {
        "outer": {"count": 12, "us": 36.0, "self_us": 12.0},
        "inner": {"count": 12, "us": 24.0, "self_us": 24.0}}
    tracer.clear()
    assert not tracer.wall_spans and tracer.dropped == 0
    tracer.mark_span("serve", "request 0", 0.0, 50.0, rid=0)
    with tracer.span("outer", "after"):
        clock.us += 4.0
    # a marked request span adds to the totals and is never a parent
    assert tracer.totals["outer"] == {"count": 13, "us": 40.0,
                                      "self_us": 16.0}
    assert tracer.totals["serve"] == {"count": 1, "us": 50.0,
                                      "self_us": 50.0}
    assert [s.parent for s in tracer.wall_spans] == [None, None]
    sids = [s.sid for s in tracer.wall_spans]
    assert sids == sorted(sids) and len(set(sids)) == 2


def test_self_time_subtracts_direct_children_and_parent_names_the_encloser():
    tracer, clock = _clocked()
    with tracer.span("a", "top") as top:
        clock.us += 1.0
        with tracer.span("b", "mid") as mid:
            clock.us += 2.0
            with tracer.span("c", "leaf") as leaf:
                clock.us += 4.0
            clock.us += 8.0
        with tracer.span("b", "mid2") as mid2:
            clock.us += 16.0
        top.args["seen"] = True          # filled in inside the block
    assert (top.dur_us, mid.dur_us, leaf.dur_us, mid2.dur_us) == \
        (31.0, 14.0, 4.0, 16.0)
    assert top.parent is None and mid.parent == mid2.parent == top.sid
    assert leaf.parent == mid.sid
    # top's self time leaves out its children (b: 14 + 16), not the leaf
    assert tracer.totals == {"a": {"count": 1, "us": 31.0, "self_us": 1.0},
                             "b": {"count": 2, "us": 30.0, "self_us": 26.0},
                             "c": {"count": 1, "us": 4.0, "self_us": 4.0}}
    events = {e["name"]: e for e in tracer.to_chrome()["traceEvents"]
              if e["ph"] == "X"}
    assert events["leaf"]["args"] == {"sid": leaf.sid, "parent": mid.sid}
    assert events["top"]["args"] == {"seen": True, "sid": top.sid,
                                     "parent": None}
    # a span that raises still closes, and its parent's stack unwinds
    with pytest.raises(ValueError):
        with tracer.span("a", "fails"):
            clock.us += 1.0
            raise ValueError("x")
    assert tracer.totals["a"]["count"] == 2 and not tracer._open


def test_traced_cpu_workload_yields_each_category():
    bits = _bits(6, 2 * 8192 + 40)
    sess = ComputeSession(device="cpu", config=SSDConfig(**CONFIG),
                          trace=True)
    a, b = sess.write_pair("a", bits[0], "b", bits[1])
    c, d = sess.write_pair("c", bits[2], "d", bits[3])
    sess.materialize((a & b) | (c ^ d))
    sess.materialize((a & b) | (c ^ d))          # verdict and runner reused
    sess.popcount(sess.chain("and", [a, b, c, d]))
    handles = [sess.materialize_async(x) for x in (a ^ c, b | d, a & d)]
    sess.drain()
    spans = sess.trace.wall_spans
    count = Counter(s.category for s in spans)
    plans = count["dispatch"]
    assert plans == count["lower"] == 6
    for cat in ("simplify", "verify", "account", "gather", "launch"):
        assert count[cat] == plans, cat
    assert count["program"] == 2          # one aligned write per pair
    assert count["program_draw"] == count["program_store"] >= 2
    assert count["drain_submit"] == count["drain_wait"] == len(handles)
    assert [s.args["cached"] for s in spans if s.category == "verify"][:2] \
        == [False, True]
    wordlines = {s.args["wordlines"] for s in spans
                 if s.category in ("program", "program_draw")}
    assert wordlines == {3}               # 3 pages of 1 kB a vector
    by_sid = {s.sid: s for s in spans}
    for s in spans:
        if s.category in ("gather", "launch"):
            assert by_sid[s.parent].category == "dispatch"
        if s.category == "program_draw":
            assert by_sid[s.parent].category in ("program", "ftl")
        if s.category == "drain_submit":
            assert s.args["bytes"] == 3 * 256 * 4     # 3 pages of words
    # a drain resolved by backpressure inside a submit nests in it
    waits = [s for s in spans if s.category == "drain_wait"]
    assert by_sid[waits[0].parent].category == "drain_submit"
    assert {e["name"] for e in sess.trace.instants}.isdisjoint(
        {"executable-hit", "executable-miss"})
    for cat, tot in sess.trace.totals.items():
        assert tot["count"] == count[cat], cat
        assert 0.0 <= tot["self_us"] <= tot["us"] + 1e-6
    # with tracing off the same calls record nothing and give the same words
    plain = ComputeSession(device="cpu", config=SSDConfig(**CONFIG))
    pa, pb = plain.write_pair("a", bits[0], "b", bits[1])
    assert plain.trace is None and plain.host_queue.tracer is None
    np.testing.assert_array_equal(plain.materialize_async(pa ^ pb).result(),
                                  sess.materialize_async(a ^ b).result())


def test_one_request_id_links_lower_dispatch_batch_and_drain():
    bits = _bits(4, 8192 - 160, seed=5)
    sess = ComputeSession(device="cpu", config=SSDConfig(**CONFIG),
                          trace=True)
    a, b = sess.write_pair("a", bits[0], "b", bits[1], die=0)
    c, d = sess.write_pair("c", bits[2], "d", bits[3], die=1)
    eng = QueryEngine(sess, SLOConfig(max_batch_requests=2,
                                      max_delay_us=1e15))
    tickets = [eng.submit(a & b, popcount=True), eng.submit(c ^ d)]
    assert eng.poll() == 2
    tickets.append(eng.submit(a | d))
    assert eng.poll() == 0                # waits for the batch to fill
    eng.drain(tickets)
    spans = sess.trace.wall_spans
    by_sid = {s.sid: s for s in spans}
    for t in tickets:
        cats = Counter()
        for s in spans:
            if t.rid in s.args.get("rids", ()) or s.args.get("rid") == t.rid:
                cats[s.category] += 1
        assert cats == {"lower": 1, "dispatch": 1, "serve_step": 1,
                        "drain_submit": 1, "drain_wait": 1, "serve": 1}, cats
    steps = [s for s in spans if s.category == "serve_step"]
    assert [(s.name, s.args["batch"], s.args["rids"]) for s in steps] == \
        [("batch 0", 0, [0, 1]), ("batch 1", 1, [2])]
    # the first batch ran inside a poll; the lowering inside the batch
    assert by_sid[steps[0].parent].category == "serve_poll"
    lowers = [s for s in spans if s.category == "lower"]
    assert [by_sid[s.parent].category for s in lowers] == ["serve_step"] * 2
    assert Counter(s.category for s in spans)["serve_poll"] == 2
    requests = sorted((s.args["rid"], s.args["batch"]) for s in spans
                      if s.category == "serve")
    assert requests == [(0, 0), (1, 0), (2, 1)]
    assert not sess.trace.instants        # no admit, hit or miss instants
