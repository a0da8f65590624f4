"""The port's span tracer and timeline report against the JAX package's.

Both packages take the same writes and expressions with ``trace=True``
(the JAX session on its ``sim`` backend, the port on ``device="cpu"``).
The device timelines must agree exactly: the same lanes, the same span
counts per category, the same lane ends, each tracer's makespan equal to
its ledger's ``makespan_us()``, and the same text report.  The wall-clock
spans and instants of the reference's categories (lowering, runner builds,
dispatch, FTL realignment, fused-chain splits) must come in the same
numbers; their times are host times and differ.  The port adds spans of
its own (canonicalization, verification, accounting, gathers, launches,
drains, programming),
held here by count against the calls that make them, and records runner
cache hits and misses only in the cache's counters, which are held against
the reference's hit and miss instants.  The exported Chrome JSON passes the
repo's trace checker (``benchmarks/check_trace.py``) with the reference's
summary, less the instants the port does not record and plus the spans it
adds.
"""
import json
from collections import Counter

import numpy as np
import pytest
import torch

from benchmarks.check_trace import check_trace
from repro.api import ComputeSession as RefSession
from repro.flash.geometry import SSDConfig as RefConfig
from repro_torch.api.session import ComputeSession
from repro_torch.flash.geometry import SSDConfig
from repro_torch.obs import Tracer, timeline_report

torch.set_num_threads(1)


def _sessions(encoding="mlc", dies=2, **kw):
    cfg = dict(page_kb=1, channels=1, dies_per_channel=dies)
    ref = RefSession(config=RefConfig(**cfg), backend="sim",
                     encoding=encoding, trace=True, **kw)
    port = ComputeSession(device="cpu", config=SSDConfig(**cfg),
                          encoding=encoding, trace=True, **kw)
    return ref, port


def _workload(sess, encoding, bits):
    """Pairs, scattered vectors (realignment), NOT, a fused chain, a mixed
    DAG; materialized, counted and drained."""
    a, b = sess.write_pair("a", bits[0], "b", bits[1])
    c, d = sess.write_pair("c", bits[2], "d", bits[3])
    e, f = sess.write("e", bits[4]), sess.write("f", bits[5])
    sess.materialize((a & b) | (c ^ d))
    sess.materialize((a & b) | (c ^ d))            # runner-cache hit
    sess.popcount(sess.chain("and", [a, b, c, d]))
    sess.materialize(e & f)                        # copyback realignment
    sess.materialize(~a if encoding != "mlc" else ~e)
    sess.materialize_async(a ^ c)
    sess.drain()


def _device_view(tracer):
    lanes = tracer.lanes()
    return ({lane: [(s.name, s.category, s.start_us, s.dur_us)
                    for s in spans] for lane, spans in lanes.items()},
            Counter(s.category for s in tracer.device_spans),
            tracer.lane_end_us())


#: wall-span categories the port adds to the reference's
PORT_CATEGORIES = {"simplify", "verify", "account", "gather", "launch",
                   "drain_submit", "drain_wait", "program", "program_draw",
                   "program_store"}
#: instants the reference records and the port counts in its runner cache
CACHE_INSTANTS = {"executable-hit": "hits", "executable-miss": "misses"}


def _wall_view(tracer, skip=frozenset()):
    return (Counter((s.category, s.name) for s in tracer.wall_spans
                    if s.category not in skip),
            Counter((e["category"], e["name"]) for e in tracer.instants
                    if e["name"] not in skip))


def _hold_wall_views(ref, port, writes, aligned_writes, drains):
    """The reference's wall view, less its cache instants, equals the
    port's, less its own categories; the cache instants equal the port's
    cache counters, and the port's added spans come one per executed plan
    (simplify, verify, account, gather, launch: each plan here is one
    expression's), per aligned write (program), per
    row programming (program_draw, program_store: each write and each FTL
    realignment) and per drained result (drain_submit, drain_wait)."""
    spans, instants = _wall_view(ref.trace, skip=CACHE_INSTANTS)
    assert _wall_view(port.trace, skip=PORT_CATEGORIES) == (spans, instants)
    ref_instants = _wall_view(ref.trace)[1]
    stats = port.executor.stats()
    for name, counter in CACHE_INSTANTS.items():
        assert ref_instants[("cache", name)] == stats[counter], name
    plans = spans[("dispatch", "dispatch-waves")]
    realigned = sum(n for (cat, _), n in spans.items() if cat == "ftl")
    added = Counter(s.category for s in port.trace.wall_spans
                    if s.category in PORT_CATEGORIES)
    assert added == {"simplify": plans, "verify": plans, "account": plans,
                     "gather": plans,
                     "launch": plans, "program": aligned_writes,
                     "program_draw": writes + realigned,
                     "program_store": writes + realigned,
                     "drain_submit": drains, "drain_wait": drains}


def _hold_summaries(ref, port, tmp_path):
    """check_trace of the port's export: the reference's summary, with the
    port's added spans and without its cache instants."""
    got = check_trace(port.trace.export(str(tmp_path / "port.json")))
    want = check_trace(ref.trace.export(str(tmp_path / "ref.json")))
    added = len(port.trace.wall_spans) - len(ref.trace.wall_spans)
    dropped = len(ref.trace.instants) - len(port.trace.instants)
    assert added > 0 and dropped == sum(
        port.executor.stats()[c] for c in CACHE_INSTANTS.values())
    assert got == {**want, "spans": want["spans"] + added,
                   "instants": want["instants"] - dropped,
                   "events": want["events"] + added - dropped}


@pytest.mark.parametrize("encoding", ("mlc", "tlc", "reduced-mlc"))
def test_traced_timeline_matches_reference(encoding, tmp_path):
    rng = np.random.default_rng(3)
    bits = [(rng.random(2 * 8192 + 40) < 0.5).astype(np.uint8)
            for _ in range(6)]
    ref, port = _sessions(encoding)
    _workload(ref, encoding, bits)
    _workload(port, encoding, bits)
    assert _device_view(port.trace) == _device_view(ref.trace)
    # 4 writes (2 pairs, 2 scattered); an 8-state realignment rewrites an
    # aligned group
    align_groups = sum(1 for s in port.trace.wall_spans
                       if s.name.startswith("align-group["))
    _hold_wall_views(ref, port, writes=4, aligned_writes=2 + align_groups,
                     drains=1)
    assert port.trace.makespan_us() == port.ledger.makespan_us()
    assert port.trace.makespan_us() == ref.trace.makespan_us() > 0
    assert port.trace.report(port.ledger) == ref.trace.report(ref.ledger)
    doc = json.loads(json.dumps(port.trace.to_chrome()))
    assert doc["otherData"]["makespan_us"] == port.ledger.makespan_us()
    _hold_summaries(ref, port, tmp_path)


def test_overlap_mode_and_split_chain_match_reference(tmp_path):
    """In the ledger's overlap mode the channel lanes overlap later waves'
    die work in both packages alike (the trace checker audits causality);
    a chain longer than one fused pass records the split instant; a shared
    tracer, ``reset_stats`` and ``clear`` behave alike."""
    rng = np.random.default_rng(5)
    n = 8192
    bits = [(rng.random(n) < 0.99).astype(np.uint8) for _ in range(68)]
    ref, port = _sessions("mlc", dies=4, overlap=True, drain_depth=2)
    for sess in (ref, port):
        for i in range(0, 68, 2):
            sess.write_pair(f"v{i}", bits[i], f"v{i + 1}", bits[i + 1])
        chain = sess.chain("and", [f"v{i}" for i in range(66)])
        pair = sess["v66"] ^ sess["v67"]
        sess.materialize_async(chain)
        sess.materialize_async(pair)
        sess.materialize_async((sess["v0"] & sess["v1"]) | pair)
        sess.drain()
    assert _device_view(port.trace) == _device_view(ref.trace)
    _hold_wall_views(ref, port, writes=34, aligned_writes=34, drains=3)
    splits = [e for e in port.trace.instants
              if e["name"] == "tiled-megakernel-split"]
    assert splits and splits[0]["args"] == {"operands": 33, "passes": 2}
    assert port.trace.meta == ref.trace.meta
    assert port.trace.meta["overlap_mode"] == "overlap"
    _hold_summaries(ref, port, tmp_path)
    assert timeline_report(port.trace) == timeline_report(ref.trace)

    shared = Tracer(max_spans=5)
    capped = ComputeSession(flash=port.device, trace=shared)
    assert capped.trace is shared and port.ledger.tracer is shared
    capped.materialize(capped["v0"] | capped["v1"])
    assert len(shared.device_spans) + len(shared.wall_spans) == 5
    assert shared.dropped > 0 and "spans dropped" in shared.report()
    capped.reset_stats()
    assert shared.device_spans            # spans survive a stats reset
    shared.clear()
    assert not shared.device_spans and shared.dropped == 0
