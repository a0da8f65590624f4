"""A drained root whose plan is one sense is sensed and copied host-ward in
chunks.

``ComputeSession.materialize_async`` of a root whose plan is one sense
group of one item (an MLC pair, a NOT, a leaf read) senses it
``executor.DRAIN_CHUNK_PAGES`` pages at a time through
``Rows.take`` of its slot tables, and hands each chunk to a
``ChunkedDrain`` as it is made (on the CPU the chunks are plain slices).
Its words equal the one-shot drain's, bit for bit, whatever the op, the
number of chunks or where ``n_bits`` ends; the ledger and every other
counter are the one-shot path's.  Counted roots, combines, fused chains,
batches and sessions with the reliability layer keep their paths.
"""
import numpy as np
import pytest
import torch

from repro_torch.api import executor as executor_mod
from repro_torch.api.session import _SESSION_COUNTERS, ComputeSession
from repro_torch.flash.device import FlashDevice
from repro_torch.flash.geometry import SSDConfig
from repro_torch.kernels import mlc_sense, ref
from repro_torch.kernels.rows import Rows

torch.set_num_threads(1)

PAGE_BITS = 8192
CFG = dict(channels=1, dies_per_channel=2, page_kb=1)


@pytest.fixture(autouse=True)
def _plain_env(monkeypatch):
    monkeypatch.delenv("REPRO_VERIFY", raising=False)
    monkeypatch.delenv("REPRO_FAULTS", raising=False)


def _bits(rng, n_bits, k):
    return [(rng.random(n_bits) < 0.6).astype(np.uint8) for _ in range(k)]


def _scattered_pair(sess, bits):
    """A pair on die 0 whose rows sit in freed slots, out of order: a
    filler pair's blocks are erased first."""
    sess.write_pair("x", bits[0], "y", bits[1], die=0)
    dev = sess.device
    for plane, block in sorted({wl[:2] for wl in sess.ftl.vectors["x"].pages}):
        dev.erase_block(plane, block)
    return sess.write_pair("a", bits[0], "b", bits[1], die=0)


def _counters(sess) -> dict:
    return {name: getattr(sess, name) for name, _ in _SESSION_COUNTERS
            + (("max_concurrent_dies", ""),)
            if name not in ("pipelined_drains", "drain_chunks")}


def test_rows_take_and_the_plain_drain_over_out_of_order_tables():
    gen = torch.Generator().manual_seed(33)
    shards = [torch.randn(9, PAGE_BITS, generator=gen) * 2 + 2,
              torch.randn(6, PAGE_BITS, generator=gen) * 2 + 2]
    tables = [torch.tensor(t, dtype=torch.int32)
              for t in ([4, 0, 8], [5, 5, 1, 0], [7, 1])]
    rows = Rows([shards[0], shards[1], shards[0]], tables)
    dense = rows.gather()
    whole = mlc_sense.mlc_sense(rows, [1.9], kind="lsb")
    for start, stop in ((0, 9), (0, 1), (2, 7), (3, 4), (6, 9), (1, 8)):
        part = rows.take(start, stop)
        assert part.n_rows == stop - start
        # views of the tables' slots, over the same buffers
        assert all(any(s.untyped_storage().data_ptr()
                       == t.untyped_storage().data_ptr() for t in tables)
                   for s in part.slots)
        torch.testing.assert_close(part.gather(), dense[start:stop])
        assert torch.equal(mlc_sense.mlc_sense(part, [1.9], kind="lsb"),
                           whole[start:stop])
    # drained in chunks of 4 rows, rows from 7 on masked: 3 chunks
    mask = torch.randint(-2 ** 31, 2 ** 31, (9 * PAGE_BITS // 32,),
                         generator=gen, dtype=torch.int64).to(torch.int32)
    host = torch.empty(9 * PAGE_BITS // 32, dtype=torch.int32)
    assert mlc_sense.sense_drain(rows, [1.9], kind="lsb", host=host,
                                 chunk_rows=4, mask=mask, mask_row=7) == 3
    want = whole.reshape(-1).clone()
    want[7 * PAGE_BITS // 32:] &= mask[7 * PAGE_BITS // 32:]
    assert torch.equal(host, want)


def _unpacked(words: np.ndarray) -> np.ndarray:
    return ref.unpack_bits(torch.from_numpy(
        words.view(np.int32)).reshape(1, -1))[0].numpy().astype(bool)


def test_chunked_drain_equals_one_shot_drain(monkeypatch):
    """and / or / xor (and an inverse read, a NOT and a leaf read) over up
    to 10 pages: chunks of 3 pages (an even count, the last one short) or
    of 4 (an odd count); n_bits on a page edge, mid-page in the last chunk,
    mid-page inside a chunk and on a chunk's edge; rows in out-of-order
    slots."""
    for chunk_pages, n_bits in ((3, 10 * PAGE_BITS), (4, 10 * PAGE_BITS),
                                (3, 10 * PAGE_BITS - 77),
                                (4, 5 * PAGE_BITS + 5),
                                (3, 4 * PAGE_BITS + 1000),
                                (4, 8 * PAGE_BITS)):
        _hold_chunked_drain(monkeypatch, chunk_pages, n_bits)


def _hold_chunked_drain(monkeypatch, chunk_pages, n_bits):
    monkeypatch.setattr(executor_mod, "DRAIN_CHUNK_PAGES", chunk_pages)
    rng = np.random.default_rng(n_bits + chunk_pages)
    bits = _bits(rng, n_bits, 2)
    chunked = ComputeSession(device="cpu", config=SSDConfig(**CFG),
                             trace=True)
    whole = ComputeSession(device="cpu", config=SSDConfig(**CFG),
                           trace=True)
    v = _scattered_pair(chunked, bits)
    w = _scattered_pair(whole, bits)
    for sess in (chunked, whole):
        tables = sess.device.slot_tables(sess.ftl.vectors["a"].pages)
        assert any(torch.any(t[1:] < t[:-1]) for _, t in tables)
    b = [x.astype(bool) for x in bits]
    n_pages = -(-n_bits // PAGE_BITS)
    cases = ((lambda x: x[0] & x[1], b[0] & b[1]),
             (lambda x: x[0] | x[1], b[0] | b[1]),
             (lambda x: x[0] ^ x[1], b[0] ^ b[1]),
             (lambda x: x[0].nand(x[1]), ~(b[0] & b[1])),
             (lambda x: ~x[0], ~b[0]),
             (lambda x: x[1], b[1]))
    for k, (root, want) in enumerate(cases):
        got = chunked.materialize_async(root(v)).result()
        assert chunked.pipelined_drains == k + 1, (n_bits, k)
        with monkeypatch.context() as m:
            m.setattr(executor_mod, "_root_drains_in_chunks",
                      lambda plan, popcounts: False)
            one_shot = whole.materialize_async(root(w)).result()
        assert whole.pipelined_drains == 0
        assert got.dtype == np.uint32 and got.shape == one_shot.shape
        assert got.shape == (n_pages * PAGE_BITS // 32,)
        np.testing.assert_array_equal(got, one_shot)
        for sess, x in ((chunked, v), (whole, w)):
            np.testing.assert_array_equal(
                got, sess.materialize(root(x)).numpy().view(np.uint32))
        # the first n_bits are the op's, the bits past them zero
        cells = _unpacked(got)
        np.testing.assert_array_equal(cells[:n_bits], want)
        assert not cells[n_bits:].any()
    chunks = -(-n_pages // chunk_pages)
    assert chunked.drain_chunks == len(cases) * chunks
    assert chunked.stats()["pipelined_drains"] == len(cases)
    assert chunked.stats()["drain_chunks"] == len(cases) * chunks
    submits = [s.args for s in chunked.trace.wall_spans
               if s.category == "drain_submit"]
    assert submits == [{"bytes": n_pages * PAGE_BITS // 8, "rid": None,
                        "chunks": chunks}] * len(cases)
    # the same senses and the same bytes host-ward are booked
    assert chunked.ledger.summary() == whole.ledger.summary()
    assert chunked.ledger.makespan_us() == whole.ledger.makespan_us()
    assert _counters(chunked) == _counters(whole)


def test_other_plans_and_reliability_keep_the_one_shot_drain(monkeypatch):
    monkeypatch.setattr(executor_mod, "DRAIN_CHUNK_PAGES", 2)
    rng = np.random.default_rng(34)
    n_bits = 5 * PAGE_BITS - 300
    bits = _bits(rng, n_bits, 8)
    b = [x.astype(bool) for x in bits]
    sess = ComputeSession(device="cpu", config=SSDConfig(
        channels=1, dies_per_channel=4, page_kb=1), trace=True)
    v = []
    for i in range(0, 8, 2):
        v += sess.write_pair(f"v{i}", bits[i], f"v{i + 1}", bits[i + 1],
                             die=i // 2)

    def held(got, want):
        cells = _unpacked(got)
        return (cells[:n_bits] == want).all() and not cells[n_bits:].any()

    chain = sess.chain("and", v)
    assert sess.lower(chain).steps[-1].fused is not None
    combine = (v[0] & v[1]) | (v[2] ^ v[3])
    for expr, want in ((chain, np.logical_and.reduce(b)),
                       (combine, (b[0] & b[1]) | (b[2] ^ b[3]))):
        got = sess.materialize_async(expr).result()
        np.testing.assert_array_equal(
            got, sess.materialize(expr).numpy().view(np.uint32))
        assert held(got, want)
    assert sess.popcount(v[4] & v[5]) == int((b[4] & b[5]).sum())
    handles = sess.materialize_batch_async([v[0] & v[1], v[6] ^ v[7]])
    assert held(handles[0].result(), b[0] & b[1])
    assert held(handles[1].result(), b[6] ^ b[7])
    assert sess.pipelined_drains == sess.drain_chunks == 0
    assert sess.sense_counted_roots == 1
    assert {s.args["chunks"] for s in sess.trace.wall_spans
            if s.category == "drain_submit"} == {1}
    # one eligible root among them: counted once, in 3 chunks of 2 pages
    got = sess.materialize_async(v[6] ^ v[7]).result()
    assert held(got, b[6] ^ b[7])
    assert (sess.pipelined_drains, sess.drain_chunks) == (1, 3)
    # faults on: checkword recovery needs the whole words first
    worn = ComputeSession(device="cpu", config=SSDConfig(**CFG),
                          recovery=True)
    x, y = worn.write_pair("x", bits[0], "y", bits[1])
    got = worn.materialize_async(x & y).result()
    assert held(got, b[0] & b[1])
    assert worn.reliability is not None and worn.pipelined_drains == 0


def test_placed_session_drains_in_chunks_from_the_unit_shard(monkeypatch):
    monkeypatch.setattr(executor_mod, "DRAIN_CHUNK_PAGES", 2)
    rng = np.random.default_rng(35)
    bits = _bits(rng, 3 * PAGE_BITS + 9, 4)
    placed = ComputeSession(flash=FlashDevice(
        config=SSDConfig(**CFG), shard_devices=["cpu"] * 2, device="cpu"))
    plain = ComputeSession(device="cpu", config=SSDConfig(**CFG))
    got = []
    for sess in (placed, plain):
        p0, p1 = sess.write_pair("p0", bits[0], "p1", bits[1], die=0)
        p2, p3 = sess.write_pair("p2", bits[2], "p3", bits[3], die=1)
        got.append([sess.materialize_async(e).result()
                    for e in (p0.nor(p1), p2 ^ p3)])
        assert (sess.pipelined_drains, sess.drain_chunks) == (2, 4)
    for a, b in zip(*got):
        np.testing.assert_array_equal(a, b)
    assert placed.placed_unit_dispatches == 2
    assert placed.ledger.summary() == plain.ledger.summary()
