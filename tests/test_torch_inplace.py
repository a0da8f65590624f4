"""The sense kernels read the Vth arena in place, through slot tables.

The unplaced executor, the placed one on CPU entries, the recovery ladder
and the device's direct reads sense every row where it lives: here
``ShardedVthArena.gather`` raises, and the answers still equal the JAX
package's over the same Vth rows (MLC pair senses and a same-die batch
group, a cross-die fused AND chain and its count, a chain past
``MAX_FUSED_OPERANDS``, TLC and reduced-MLC groups).  The device's slot
tables are built once per page list and reused until a slot changes; a
shard that grows keeps its tables.  The plain row-table versions equal
gather-then-dense on shuffled and repeated slots.
"""
import numpy as np
import pytest
import torch

from repro.api import ComputeSession as RefSession
from repro.flash.geometry import SSDConfig as RefConfig
from repro_torch.api.executor import MAX_FUSED_OPERANDS
from repro_torch.api.hostio import to_numpy
from repro_torch.api.session import ComputeSession
from repro_torch.flash.arena import ShardedVthArena
from repro_torch.flash.device import FlashDevice
from repro_torch.flash.geometry import SSDConfig
from repro_torch.kernels import fused, mlc_sense
from repro_torch.kernels.rows import Rows, identity

torch.set_num_threads(1)

N_BITS = 8192 + 100              # two 1 kB pages, a ragged tail
CFG = dict(channels=1, dies_per_channel=4, page_kb=1)


@pytest.fixture(autouse=True)
def _no_gather(monkeypatch):
    """Every sense reads in place: a copy out of the arena fails the test."""
    monkeypatch.delenv("REPRO_VERIFY", raising=False)
    monkeypatch.delenv("REPRO_FAULTS", raising=False)

    def refuse(self, *a, **k):
        raise AssertionError("a sense gathered Vth rows out of the arena")

    monkeypatch.setattr(ShardedVthArena, "gather", refuse)


def _bits(rng, n):
    return [(rng.random(N_BITS) < 0.7).astype(np.uint8) for _ in range(n)]


def _queries(sess, encoding, names):
    """The expressions both packages run, by encoding."""
    v = [sess[n] for n in names]
    if encoding == "tlc":
        return [v[0] & v[1] & v[2], sess.chain("or", v[:6]), v[3] ^ v[4] ^ v[5]]
    out = [v[0] ^ v[1], sess.chain("and", v[:8])]
    if encoding == "mlc":
        out.append(sess.chain("and", v))         # past one fused pass
    return out


def test_unplaced_senses_in_place_match_the_reference():
    rng = np.random.default_rng(0)
    for encoding in ("mlc", "tlc", "reduced-mlc"):
        n_ops = 2 * (MAX_FUSED_OPERANDS + 1) if encoding == "mlc" else 12
        bits = _bits(rng, n_ops)
        names = [f"v{i}" for i in range(n_ops)]
        ref = RefSession(backend="sim", config=RefConfig(**CFG),
                         encoding=encoding, verify="off")
        port = ComputeSession(device="cpu", config=SSDConfig(**CFG),
                              encoding=encoding)
        group = 3 if encoding == "tlc" else 2
        for sess in (ref, port):
            for i in range(0, n_ops, group):
                args = [x for j in range(group)
                        for x in (names[i + j], bits[i + j])]
                write = sess.write_triple if group == 3 else sess.write_pair
                write(*args, die=(i // group) % 4)
        port.device.load_vth({die: np.asarray(shard.buf) for die, shard
                              in ref.device.arena._shards.items()})
        for r_expr, p_expr in zip(_queries(ref, encoding, names),
                                  _queries(port, encoding, names)):
            np.testing.assert_array_equal(to_numpy(port.materialize(p_expr)),
                                          np.asarray(ref.materialize(r_expr)))
            assert port.popcount(p_expr) == ref.popcount(r_expr), encoding
        if encoding == "mlc":
            # pairs 0 and 4 share die 0: one sense group, two slot tables
            pairs = [port["v0"] & port["v1"], port["v8"] & port["v9"]]
            got = port.materialize_batch(pairs)
            want = ref.materialize_batch([ref["v0"] & ref["v1"],
                                          ref["v8"] & ref["v9"]])
            for g, w in zip(got, want):
                np.testing.assert_array_equal(to_numpy(g), np.asarray(w))
            assert port.tiled_megakernel_splits >= 1
        assert port.slot_table_builds > 0 and port.slot_table_reuses > 0


def test_slot_tables_built_once_and_rebuilt_when_slots_change():
    rng = np.random.default_rng(1)
    sess = ComputeSession(device="cpu", config=SSDConfig(**CFG))
    dev = sess.device
    bits = _bits(rng, 6)
    a, b = sess.write_pair("a", bits[0], "b", bits[1], die=0)
    c, d = sess.write_pair("c", bits[2], "d", bits[3], die=1)
    sess.write_pair("x", bits[0], "y", bits[1], die=2)

    def count(expr, want):
        assert sess.popcount(expr) == int(want.sum())

    sess.reset_stats()
    count(sess.chain("and", [a, b, c, d]),
          bits[0] & bits[1] & bits[2] & bits[3])
    assert (sess.slot_table_builds, sess.slot_table_reuses) == (2, 0)
    count(sess.chain("and", [a, b, c, d]),
          bits[0] & bits[1] & bits[2] & bits[3])
    assert (sess.slot_table_builds, sess.slot_table_reuses) == (2, 2)
    assert sess.stats()["slot_table_builds"] == 2
    # rewriting a pair places it on new wordlines: a new page list
    a, b = sess.write_pair("a", bits[4], "b", bits[5], die=0)
    count(a & b, bits[4] & bits[5])
    assert sess.slot_table_builds == 3
    # freeing a pair's rows changes slots: every table is rebuilt
    version = dev.slot_version
    for plane, block in sorted({wl[:2] for wl in sess.ftl.vectors["x"].pages}):
        dev.erase_block(plane, block)
    assert dev.slot_version > version
    count(c ^ d, bits[2] ^ bits[3])
    assert sess.slot_table_builds == 4
    # a grown shard has a new buffer under the same slots: tables reused
    shard = dev.arena.shard(1)
    buf = shard.buf
    shard._grow(shard.capacity + 1)
    assert shard.buf is not buf and shard.grows == 1
    count(c ^ d, bits[2] ^ bits[3])
    assert (sess.slot_table_builds, sess.slot_table_reuses) == (4, 3)


def _rows_cases(gen):
    """Two shards, shuffled and repeated slot tables."""
    shards = [torch.randn(9, 8192, generator=gen) * 2 + 2,
              torch.randn(6, 8192, generator=gen) * 2 + 2]
    tables = [torch.tensor([4, 0, 8, 4, 2], dtype=torch.int32),
              torch.tensor([5, 5, 1, 0, 3], dtype=torch.int32),
              torch.tensor([7, 1, 1, 6, 0], dtype=torch.int32)]
    rows = Rows([shards[0], shards[1], shards[0]], tables)
    dense = torch.stack([b.index_select(0, t.long())
                         for b, t in zip(rows.bufs, rows.slots)])
    return rows, dense


def test_row_tables_match_gather_then_dense():
    gen = torch.Generator().manual_seed(2)
    rows, dense = _rows_cases(gen)
    mask = torch.randint(-2 ** 31, 2 ** 31, (5, 256), generator=gen,
                         dtype=torch.int64).to(torch.int32)
    cases = [("lsb", [1.9]), ("msb", [0.1, 3.7]), ("sbr", [0.1, 3.7, 1.9, 5.5]),
             ("parity", [-1.0 + 0.7 * i for i in range(7)])]
    for kind, refs in cases:
        n_refs = len(refs)
        for invert in (False, True):
            want = mlc_sense.reference(dense.reshape(15, -1), refs, kind,
                                       invert, n_refs)
            assert torch.equal(mlc_sense.mlc_sense(rows, refs, kind=kind,
                                                   invert=invert,
                                                   n_refs=n_refs), want)
            assert torch.equal(mlc_sense.mlc_sense(rows[1:2], refs, kind=kind,
                                                   invert=invert,
                                                   n_refs=n_refs), want[5:10])
            for op in ("and", "or", "xor"):
                args = dict(kind=kind, sense_invert=not invert, op=op,
                            invert=invert, n_refs=n_refs)
                want = fused.reference(dense, refs, kind, not invert, op,
                                       invert, n_refs)
                assert torch.equal(fused.sense_reduce(rows, refs, **args), want)
                want = fused.reference_popcount(dense, refs, mask, kind,
                                                not invert, op, invert, n_refs)
                assert torch.equal(fused.sense_reduce_popcount(
                    rows, refs, mask, **args), want)
    # a dense stack is one base with the identity table
    ident = identity(dense)
    assert len(ident) == 3 and all(b is ident.bufs[0] for b in ident.bufs)
    assert torch.equal(ident.gather(), dense.reshape(15, -1))
    assert torch.equal(identity(dense[0]).slots[0], torch.arange(5).int())
    with pytest.raises(ValueError):
        fused.sense_reduce(Rows(rows.bufs[:2], [rows.slots[0],
                                                rows.slots[1][:3]]),
                           [1.9], kind="lsb", sense_invert=False, op="and")


def test_direct_reads_placed_runner_and_recovery_read_in_place():
    rng = np.random.default_rng(3)
    bits = _bits(rng, 8)
    # the device's direct reads over a page list that spans two dies
    sess = ComputeSession(device="cpu", config=SSDConfig(**CFG))
    a, b = sess.write_pair("a", bits[0], "b", bits[1], die=0)
    c, d = sess.write_pair("c", bits[2], "d", bits[3], die=2)
    dev = sess.device
    wls = sess.ftl.vectors["a"].pages + sess.ftl.vectors["c"].pages
    assert len(dev.vth_rows(wls)) == 2
    words = dev.mcflash_read_batch(wls, "and")
    want = torch.stack([kernel_words(dev.expected(wl, "and")) for wl in wls])
    assert torch.equal(words, want)
    assert torch.equal(dev.page_read_batch(wls, "msb"), torch.stack(
        [kernel_words(dev.stored_operands(wl)[1]) for wl in wls]))
    # copyback realignment of two scattered vectors reads its sources in place
    e = sess.write("e", bits[4], die=1)
    f = sess.write("f", bits[5], die=3)
    assert sess.popcount(e & f) == int((bits[4] & bits[5]).sum())

    # placed on CPU entries: single-die and cross-die units read in place
    placed = ComputeSession(flash=FlashDevice(config=SSDConfig(**CFG),
                                              shard_devices=["cpu"] * 4,
                                              device="cpu"))
    vs = []
    for i in range(0, 8, 2):
        vs += placed.write_pair(f"p{i}", bits[i], f"p{i + 1}", bits[i + 1],
                                die=i // 2)
    expr = (vs[0] & vs[1]) | placed.chain("xor", vs[2:6]) | (vs[6] ^ vs[7])
    want = (bits[0] & bits[1]) | (bits[2] ^ bits[3] ^ bits[4] ^ bits[5]) \
        | (bits[6] ^ bits[7])
    got = placed.materialize(expr, unpacked=True).numpy()[:N_BITS]
    np.testing.assert_array_equal(got, want)
    assert placed.placed_unit_dispatches > 0
    assert placed.popcount(placed.chain("and", vs)) == int(
        np.logical_and.reduce(bits).sum())

    # the recovery ladder re-senses the plan's rows in place at shifted refs
    worn = ComputeSession(device="cpu", config=SSDConfig(**CFG),
                          encoding="tlc", faults={"pe": 5000, "seed": 9})
    w = []
    for i in range(0, 4, 2):
        w += worn.write_pair(f"w{i}", bits[i], f"w{i + 1}", bits[i + 1])
    got = worn.materialize(worn.chain("xor", w), unpacked=True).numpy()
    np.testing.assert_array_equal(got[:N_BITS],
                                  bits[0] ^ bits[1] ^ bits[2] ^ bits[3])
    assert worn.reliability.incidents


def kernel_words(page_bits: torch.Tensor) -> torch.Tensor:
    """Packed words of one page's stored bits."""
    from repro_torch.kernels.ref import pack_bits
    return pack_bits(page_bits.reshape(1, -1))[0]
