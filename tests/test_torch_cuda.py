"""The CUDA kernels and the card's main path (``gpu`` marker).

Without a card these tests skip.  On one they run with
``python -m pytest -m gpu tests/test_torch_cuda.py``; this file imports
neither JAX nor the JAX package, so it runs where only the port is
installed.  ``python3 chip_smoke.py`` runs the same checks at full size.
"""
import itertools

import numpy as np
import pytest
import torch

from repro_torch.api import executor as executor_mod
from repro_torch.api.session import ComputeSession
from repro_torch.flash.geometry import SSDConfig
from repro_torch.kernels import bitops, cuda, fused, mlc_sense, popcount
from repro_torch.kernels.rows import Rows
from repro_torch.serve import QueryEngine, SLOConfig

KIND_CASES = ([("lsb", [1.9]), ("msb", [0.1, 3.7]), ("sbr", [0.1, 3.7, 1.9, 5.5])]
              + [("parity", [-1.0 + 0.7 * i for i in range(n)]) for n in range(1, 9)])


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run python3 chip_smoke.py on one)")
    return torch.device("cuda")


def _words(gen, shape, device):
    return torch.randint(-2 ** 31, 2 ** 31, shape, generator=gen,
                         dtype=torch.int64).to(torch.int32).to(device)


@pytest.mark.gpu
def test_cuda_kernels_match_plain_versions(card):
    """Every kind x op x inversion, rows not a multiple of 8, bit-31 words:
    the kernels equal their plain versions bit for bit, on dense stacks
    (the identity table) and on rows read in place from two shards through
    out-of-order slot tables with a repeated slot; ``sense_popcount`` also
    over ragged tails and over 40 tables (two launches into one total);
    ``sense_drain`` in chunks to pinned memory on a copy stream, a tail
    masked, over 40 tables too."""
    gen = torch.Generator().manual_seed(0)
    vth = (torch.randn(3, 5, 8192, generator=gen) * 2 + 2).to(card)
    mask = _words(gen, (5, 256), card)
    words = _words(gen, (3, 5, 130), card)
    shards = [(torch.randn(n, 8192, generator=gen) * 2 + 2).to(card)
              for n in (11, 7)]
    tables = [torch.tensor(t, dtype=torch.int32, device=card) for t in
              ([9, 0, 4, 4, 10], [6, 1, 3, 0, 2], [3, 2, 8, 7, 5])]
    rows = Rows([shards[0], shards[1], shards[0]], tables)
    gathered = rows.gather().reshape(3, 5, 8192)
    many = Rows([shards[i % 2] for i in range(40)],
                [torch.tensor([i % 7, 6 - i % 7], dtype=torch.int32,
                              device=card) for i in range(40)])
    for (kind, refs), invert in itertools.product(KIND_CASES, (False, True)):
        n_refs = len(refs)
        for vth_rows, dense in ((vth[0], vth[0]),
                                (rows, gathered.reshape(15, -1)),
                                (many, many.gather())):
            cells = dense.numel()
            for n_bits in (None, cells - 4096 - 77, 20 * 8192 + 5, 100, 0):
                assert torch.equal(
                    mlc_sense.sense_popcount(vth_rows, refs, kind=kind,
                                             invert=invert, n_refs=n_refs,
                                             n_bits=n_bits),
                    mlc_sense.reference_popcount(dense, refs, kind, invert,
                                                 n_refs, n_bits))
        assert torch.equal(
            mlc_sense.mlc_sense(vth[0], refs, kind=kind, invert=invert,
                                n_refs=n_refs),
            mlc_sense.reference(vth[0], refs, kind, invert, n_refs))
        assert torch.equal(
            mlc_sense.mlc_sense(rows, refs, kind=kind, invert=invert,
                                n_refs=n_refs),
            mlc_sense.reference(gathered.reshape(15, -1), refs, kind, invert,
                                n_refs))
        _hold_sense_drain(gen, (rows, many), refs, kind, invert, card)
        for op, stack in itertools.product(("and", "or", "xor"),
                                           ((vth, vth), (rows, gathered))):
            args = dict(kind=kind, sense_invert=not invert, op=op,
                        invert=invert, n_refs=n_refs)
            assert torch.equal(fused.sense_reduce(stack[0], refs, **args),
                               fused.reference(stack[1], refs, kind,
                                               not invert, op, invert, n_refs))
            assert torch.equal(
                fused.sense_reduce_popcount(stack[0], refs, mask, **args),
                fused.reference_popcount(stack[1], refs, mask, kind,
                                         not invert, op, invert, n_refs))
            assert torch.equal(bitops.bitwise_reduce(words, op=op, invert=invert),
                               bitops.reference(words, op, invert))
    assert torch.equal(popcount.popcount_rows(words[0]),
                       popcount.reference(words[0]))
    _hold_multi_plan_sense(gen, (rows, many), card)
    torch.cuda.synchronize()


def _hold_multi_plan_sense(gen, vths, card):
    """``mlc_sense_multi`` under every MLC kind, both inversions and
    shifted references (1 to 12 plans; past 8, two launches), over the
    out-of-order and the 40 tables, then the range-scan cell's pair shape
    (4,096 rows of 131072 cells through an out-of-order table, three
    plans): each plane equals the plain version's."""
    pool = [(refs, kind, inv) for kind, refs in KIND_CASES[:3]
            for inv in (False, True)]
    pool += [([r - 0.21 for r in refs], kind, inv) for refs, kind, inv in pool]
    for vth_rows in vths:
        dense = vth_rows.gather()
        for n in (1, 3, 8, 12):
            assert torch.equal(mlc_sense.mlc_sense_multi(vth_rows, pool[:n]),
                               mlc_sense.reference_multi(dense, pool[:n]))
    shard = (torch.randn(4096 + 64, 131072, generator=gen) * 2 + 2).to(card)
    table = torch.randperm(4096 + 64, generator=gen)[:4096].to(
        torch.int32).to(card)
    rows = Rows([shard], [table])
    plans = [pool[0], pool[3], pool[4]]
    launches = cuda.launches["mlc_sense_multi"]
    got = mlc_sense.mlc_sense_multi(rows, plans)
    assert cuda.launches["mlc_sense_multi"] - launches == 1
    assert torch.equal(got, mlc_sense.reference_multi(rows.gather(), plans))


def _hold_sense_drain(gen, vths, refs, kind, invert, card):
    """Chunks of 4 rows (the last one short), then one chunk of all: the
    drained words are the plain sense's, those of rows from ``mask_row``
    on ANDed with the mask."""
    stream = torch.cuda.Stream()
    for vth_rows in vths:
        dense = vth_rows.gather()
        r, words = dense.shape[0], dense.shape[1] // 32
        want = mlc_sense.reference(dense, refs, kind, invert, len(refs))
        mask = _words(gen, (r * words,), card)
        for chunk_rows, mask_row in ((4, r - 2), (r, r), (4, 5)):
            host = torch.empty(r * words, dtype=torch.int32, pin_memory=True)
            launches = cuda.launches["mlc_sense"]
            chunks = mlc_sense.sense_drain(
                vth_rows, refs, kind=kind, invert=invert, n_refs=len(refs),
                host=host, chunk_rows=chunk_rows, copy_stream=stream,
                mask=mask if mask_row < r else None, mask_row=mask_row)
            stream.synchronize()
            tables = -(-len(vth_rows) // cuda.MAX_TABLES)
            assert tables <= chunks <= -(-r // chunk_rows) + tables - 1
            # one sense launch a chunk, the mask ANDed inside it
            assert cuda.launches["mlc_sense"] - launches == chunks
            masked = want.clone().reshape(-1)
            masked[mask_row * words:] &= mask[mask_row * words:]
            assert torch.equal(host, masked.cpu()), (kind, chunk_rows)


@pytest.mark.gpu
def test_session_on_the_card_launches_every_kernel(card, monkeypatch):
    """A small session on the card equals the numpy oracle and goes through
    all seven kernels: a fused chain's count, a combine root's count, a
    pair's count sensed in one pass and a pair read once under two plans.  A drained pair root in out-of-order
    slots, sensed and copied host-ward in three chunks, equals the one-shot
    drain bit for bit."""
    rng = np.random.default_rng(0)
    n = 3 * 8192 + 17
    raw = [(rng.random(n) < 0.6).astype(np.uint8) for _ in range(6)]
    sess = ComputeSession(config=SSDConfig(channels=1, dies_per_channel=4,
                                           page_kb=1))
    assert sess.backend.name == "cuda" and sess.torch_device.type == "cuda"
    v = []
    for i in range(0, 6, 2):
        v.extend(sess.write_pair(f"v{i}", raw[i], f"v{i + 1}", raw[i + 1]))
    b = [r.astype(bool) for r in raw]
    cuda.reset_launches()
    chain = sess.chain("and", v)
    want = np.logical_and.reduce(b)
    got = sess.materialize(chain, unpacked=True).cpu().numpy().astype(bool)
    np.testing.assert_array_equal(got, want)
    assert sess.popcount(chain) == int(want.sum())
    mixed = (v[0] & v[1]) | (v[2] ^ v[3])
    got = sess.materialize(mixed, unpacked=True).cpu().numpy().astype(bool)
    np.testing.assert_array_equal(got, (b[0] & b[1]) | (b[2] ^ b[3]))
    assert sess.popcount(mixed) == int(((b[0] & b[1]) | (b[2] ^ b[3])).sum())
    assert sess.popcount(v[4] & v[5]) == int((b[4] & b[5]).sum())
    assert sess.sense_counted_roots == 1
    shared = (v[4] & v[5]) ^ (v[4] | v[5])
    got = sess.materialize(shared, unpacked=True).cpu().numpy().astype(bool)
    np.testing.assert_array_equal(got, (b[4] & b[5]) ^ (b[4] | b[5]))
    assert (sess.shared_row_senses, sess.shared_row_items) == (1, 2)
    assert all(count > 0 for count in cuda.launches.values()), cuda.launches
    _hold_chunked_drain(sess, rng, monkeypatch)


def _hold_chunked_drain(sess, rng, monkeypatch):
    """5 pages less 100 bits in chunks of 2 pages: 3 chunks, the last one
    masked; a filler pair's blocks erased first, so the pair's rows sit in
    freed slots, out of order."""
    monkeypatch.setattr(executor_mod, "DRAIN_CHUNK_PAGES", 2)
    n = 5 * 8192 - 100
    raw = [(rng.random(n) < 0.6).astype(np.uint8) for _ in range(2)]
    sess.write_pair("x", raw[0], "y", raw[1], die=0)
    for plane, block in sorted({wl[:2] for wl in sess.ftl.vectors["x"].pages}):
        sess.device.erase_block(plane, block)
    a, b = sess.write_pair("a", raw[0], "b", raw[1], die=0)
    tables = sess.device.slot_tables(sess.ftl.vectors["a"].pages)
    assert any(bool(torch.any(t[1:] < t[:-1])) for _, t in tables)
    drains, launches = sess.pipelined_drains, cuda.launches["mlc_sense"]
    for expr in (a & b, a | b, a ^ b, a.nand(b)):
        got = sess.materialize_async(expr).result()
        with monkeypatch.context() as m:
            m.setattr(executor_mod, "_root_drains_in_chunks",
                      lambda plan, popcounts: False)
            want = sess.materialize_async(expr).result()
        assert got.dtype == want.dtype == np.uint32
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            got, sess.materialize(expr).cpu().numpy().view(np.uint32))
    assert sess.pipelined_drains - drains == 4
    assert sess.drain_chunks == 12
    # the chunked and the one-shot drain and materialize: 3 + 1 + 1 senses
    assert cuda.launches["mlc_sense"] - launches == 4 * 5
    torch.cuda.synchronize()



def _card_rows(sess):
    """The card session's Vth rows per die, for a CPU twin's ``load_vth``."""
    return {die: shard.buf.cpu().numpy()
            for die, shard in sess.device.arena._shards.items()}


@pytest.mark.gpu
def test_served_batch_matches_plain_versions(card):
    """A QueryEngine batch on the card (pair ops, a 3-operand OR chain, a
    popcount) equals the same batch on the CPU over the same Vth rows, word
    for word, with the same coalescing counters, and goes through the
    sense, combine and popcount kernels."""
    rng = np.random.default_rng(1)
    n = 2 * 8192 + 33
    raw = [(rng.random(n) < 0.5).astype(np.uint8) for _ in range(8)]
    cfg = SSDConfig(channels=1, dies_per_channel=4, page_kb=1)
    sess = ComputeSession(config=cfg, trace=True)
    twin = ComputeSession(device="cpu", config=cfg, trace=True)
    outs, stats = [], []
    for s in (sess, twin):
        v = []
        for i in range(0, 8, 2):
            v.extend(s.write_pair(f"c{i}", raw[i], f"c{i + 1}", raw[i + 1],
                                  die=i // 2))
        if s is twin:
            twin.device.load_vth(_card_rows(sess))
        cuda.reset_launches()
        eng = QueryEngine(s, SLOConfig(max_batch_requests=4))
        tickets = [eng.submit(v[0] & v[1]), eng.submit(v[2] ^ v[3]),
                   eng.submit(s.chain("or", [v[0], v[1], v[4]])),
                   eng.submit(v[6] & v[7], popcount=True),
                   eng.submit(v[0] & v[1])]
        outs.append(eng.drain(tickets))
        stats.append((eng.stats(), dict(cuda.launches)))
    b = [r.astype(bool) for r in raw]
    assert outs[0][3] == outs[1][3] == int((b[6] & b[7]).sum())
    for got, want in zip(outs[0][:3] + outs[0][4:], outs[1][:3] + outs[1][4:]):
        np.testing.assert_array_equal(got, want)
    (card_stats, launches), (cpu_stats, cpu_launches) = stats
    assert card_stats == cpu_stats and card_stats["waves_shared"] >= 1
    for kernel in ("mlc_sense", "bitwise_reduce", "popcount_rows"):
        assert launches[kernel] > 0, launches
    assert not any(cpu_launches.values())
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_shifted_reference_recovery_matches_plain_versions(card):
    """TLC at 5k P/E: the retry ladder re-senses at shifted references on
    the card (sense groups, a fused chain, a controller combine); on the
    CPU over the same perturbed rows it takes the same steps to the same
    words."""
    rng = np.random.default_rng(2)
    n = 2 * 8192
    raw = [(rng.random(n) < 0.5).astype(np.uint8) for _ in range(4)]
    cfg = SSDConfig(channels=1, dies_per_channel=2, page_kb=1)
    faults = {"pe": 5000, "seed": 9}
    sess = ComputeSession(config=cfg, encoding="tlc", faults=faults)
    twin = ComputeSession(device="cpu", config=cfg, encoding="tlc",
                          faults=faults)
    results = []
    for s in (sess, twin):
        a, b = s.write_pair("a", raw[0], "b", raw[1])
        c, d = s.write_pair("c", raw[2], "d", raw[3])
        if s is twin:
            twin.device.load_vth(_card_rows(sess))
        cuda.reset_launches()
        words = [s.materialize(e).cpu().numpy() for e in
                 (a ^ b, s.chain("xor", [a, b, c, d]), (a & b) | (c ^ d))]
        results.append((words, s.reliability.incidents,
                        s.ledger.category_us, dict(cuda.launches)))
    (words, incidents, cats, launches), (cpu_words, cpu_inc, cpu_cats, _) = \
        results
    for got, want in zip(words, cpu_words):
        np.testing.assert_array_equal(got, want)
    assert incidents == cpu_inc and len(incidents) == 3
    assert all(inc["offset"] for inc in incidents)
    assert cats == cpu_cats and cats["recovery"] > 0
    for kernel in ("mlc_sense", "sense_reduce", "bitwise_reduce"):
        assert launches[kernel] > 0, launches
    b = [r.astype(bool) for r in raw]
    got = sess.materialize((sess["a"] & sess["b"]) | (sess["c"] ^ sess["d"]),
                           unpacked=True).cpu().numpy().astype(bool)
    np.testing.assert_array_equal(got, (b[0] & b[1]) | (b[2] ^ b[3]))
    torch.cuda.synchronize()
