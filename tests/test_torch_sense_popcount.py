"""A counted root whose plan is one sense is sensed and counted in one pass.

``mlc_sense.sense_popcount`` senses R Vth rows (dense, or read through
slot tables in table order) and counts the ones among the first
``n_bits`` cells; its plain version must equal ``popcount_rows`` of
``mlc_sense``'s words under the tail mask.  The executor runs it for a
single-root counted plan with no combine step and one sense group of one
item (an MLC pair, a TLC AND3, a reduced-MLC AND, an encoded NOT, a leaf
read): the count equals the root's materialized words' and the JAX
package's over the same Vth rows, and the ledger and every session counter
but ``sense_counted_roots`` equal those of the path that senses the words
and counts them after.  Fused chains, combine roots, multi-root batches
and the reliability layer keep their paths; a placed session takes it on
the unit's shard stream.
"""
import numpy as np
import pytest
import torch

from repro.api import ComputeSession as RefSession
from repro.flash.geometry import SSDConfig as RefConfig
from repro_torch.api import executor as executor_mod
from repro_torch.api.backends import Backend
from repro_torch.api.hostio import to_numpy
from repro_torch.api.session import _SESSION_COUNTERS, ComputeSession
from repro_torch.flash.device import FlashDevice
from repro_torch.flash.geometry import SSDConfig
from repro_torch.kernels import mlc_sense, popcount, ref
from repro_torch.kernels.rows import Rows

torch.set_num_threads(1)

N_BITS = 8192 + 100              # two 1 kB pages, a ragged tail
CFG = dict(channels=1, dies_per_channel=4, page_kb=1)
KIND_CASES = ([("lsb", [1.9]), ("msb", [0.1, 3.7]),
               ("sbr", [0.1, 3.7, 1.9, 5.5])]
              + [("parity", [-1.0 + 0.7 * i for i in range(n)])
                 for n in (1, 2, 8)])


@pytest.fixture(autouse=True)
def _plain_env(monkeypatch):
    monkeypatch.delenv("REPRO_VERIFY", raising=False)
    monkeypatch.delenv("REPRO_FAULTS", raising=False)


def _tail_mask(n_bits: int, rows: int, cols: int) -> torch.Tensor:
    bits = torch.zeros((1, rows * cols), dtype=torch.uint8)
    bits[0, :n_bits] = 1
    return ref.pack_bits(bits).reshape(rows, cols // 32)


def test_plain_count_equals_masked_popcount_of_the_words():
    gen = torch.Generator().manual_seed(30)
    shards = [torch.randn(9, 8192, generator=gen) * 2 + 2,
              torch.randn(6, 8192, generator=gen) * 2 + 2]
    tables = [torch.tensor(t, dtype=torch.int32)
              for t in ([4, 0, 8], [5, 5, 1, 0], [7, 1])]
    rows = Rows([shards[0], shards[1], shards[0]], tables)
    many = Rows([shards[i % 2] for i in range(40)],
                [torch.tensor([i % 6], dtype=torch.int32) for i in range(40)])
    for vth in (shards[0][:5], rows, many):
        dense = vth if isinstance(vth, torch.Tensor) else vth.gather()
        r, c = dense.shape
        for (kind, refs), invert in ((k, i) for k in KIND_CASES
                                     for i in (False, True)):
            words = mlc_sense.mlc_sense(vth, refs, kind=kind, invert=invert,
                                        n_refs=len(refs))
            for n_bits in (None, r * c, r * c - 8192 - 77, 100, 0):
                want = popcount.popcount_rows(
                    words, _tail_mask(r * c if n_bits is None else n_bits,
                                      r, c)).sum(dtype=torch.int32)
                got = mlc_sense.sense_popcount(vth, refs, kind=kind,
                                               invert=invert,
                                               n_refs=len(refs),
                                               n_bits=n_bits)
                assert got.dtype == torch.int32 and got.dim() == 0
                assert int(got) == int(want), (kind, invert, n_bits)
    with pytest.raises(ValueError):
        mlc_sense.sense_popcount(torch.zeros(2, 4000), [1.0], kind="lsb")


def _bits(rng, n):
    return [(rng.random(N_BITS) < 0.6).astype(np.uint8) for _ in range(n)]


#: (case, encoding, the root over the written vectors)
ROOTS = (
    ("mlc-pair", "mlc", lambda v: v[0].nand(v[1])),
    ("tlc-and3", "tlc", lambda v: v[0] & v[1] & v[2]),
    ("reduced-mlc-and", "reduced-mlc", lambda v: v[0] & v[1]),
    ("tlc-not", "tlc", lambda v: ~v[1]),
    ("leaf-read", "mlc", lambda v: v[1]),
)


def _written(encoding, bits, **kw):
    """Three vectors on die 0 (a triple under TLC, a pair and a single
    otherwise) of a port session."""
    sess = ComputeSession(device="cpu", config=SSDConfig(**CFG),
                          encoding=encoding, **kw)
    return sess, _write(sess, encoding, bits)


def _write(sess, encoding, bits):
    if encoding == "tlc":
        return sess.write_triple("a", bits[0], "b", bits[1], "c", bits[2],
                                 die=0)
    return [*sess.write_pair("a", bits[0], "b", bits[1], die=0),
            sess.write("c", bits[2], die=0)]


def _counters(sess) -> dict:
    return {name: getattr(sess, name) for name, _ in _SESSION_COUNTERS
            + (("max_concurrent_dies", ""),) if name != "sense_counted_roots"}


def test_counted_single_sense_roots_match_words_reference_and_books(
        monkeypatch):
    rng = np.random.default_rng(30)
    calls = []
    real = Backend.sense_popcount
    monkeypatch.setattr(Backend, "sense_popcount",
                        lambda self, *a, **k: calls.append(1) or real(
                            self, *a, **k))
    for case, encoding, root in ROOTS:
        bits = _bits(rng, 3)
        counted, v = _written(encoding, bits)
        words, w = _written(encoding, bits)
        refs = RefSession(backend="sim", config=RefConfig(**CFG),
                          encoding=encoding, verify="off")
        rv = _write(refs, encoding, bits)
        vth = {die: np.asarray(s.buf)
               for die, s in refs.device.arena._shards.items()}
        counted.device.load_vth(vth)
        words.device.load_vth(vth)
        n = len(calls)
        got = counted.popcount(root(v))
        assert len(calls) == n + 1 and counted.sense_counted_roots == 1, case
        # the path before: the root's words sensed, then counted
        with monkeypatch.context() as m:
            m.setattr(executor_mod, "_root_counts_in_sense",
                      lambda plan, popcounts: False)
            want = words.popcount(root(w))
        assert len(calls) == n + 1 and words.sense_counted_roots == 0, case
        packed = to_numpy(counted.materialize(root(v)))
        assert got == want == refs.popcount(root(rv)), case
        assert got == int(np.unpackbits(packed.view(np.uint8)).sum()), case
        words.materialize(root(w))
        assert counted.ledger.summary() == words.ledger.summary(), case
        assert counted.ledger.makespan_us() == words.ledger.makespan_us()
        assert _counters(counted) == _counters(words), case


def test_counted_path_keeps_off_chains_combines_batches_and_recovery():
    rng = np.random.default_rng(31)
    bits = _bits(rng, 8)
    sess = ComputeSession(device="cpu", config=SSDConfig(**CFG))
    v = []
    for i in range(0, 8, 2):
        v += sess.write_pair(f"v{i}", bits[i], f"v{i + 1}", bits[i + 1],
                             die=i // 2)
    b = [x.astype(bool) for x in bits]
    chain = sess.chain("and", v)
    assert sess.lower(chain).steps[-1].fused is not None
    assert sess.popcount(chain) == int(np.logical_and.reduce(b).sum())
    combine = (v[0] & v[1]) | (v[2] ^ v[3])
    assert sess.popcount(combine) == int(((b[0] & b[1]) | (b[2] ^ b[3])).sum())
    got = sess.materialize_batch([v[0] & v[1], v[4] & v[5]],
                                 popcount=[True, True])
    assert got == [int((b[0] & b[1]).sum()), int((b[4] & b[5]).sum())]
    assert sess.sense_counted_roots == 0 and sess.megakernel_calls == 1
    assert sess.popcount(v[6] ^ v[7]) == int((b[6] ^ b[7]).sum())
    assert sess.sense_counted_roots == 1
    worn = ComputeSession(device="cpu", config=SSDConfig(**CFG),
                          recovery=True)
    x, y = worn.write_pair("x", bits[0], "y", bits[1])
    assert worn.popcount(x & y) == int((b[0] & b[1]).sum())
    assert worn.sense_counted_roots == 0 and worn.reliability is not None


def test_placed_session_counts_on_the_unit_shard():
    rng = np.random.default_rng(32)
    bits = _bits(rng, 4)
    b = [x.astype(bool) for x in bits]
    placed = ComputeSession(flash=FlashDevice(
        config=SSDConfig(**CFG), shard_devices=["cpu"] * 2, device="cpu"))
    plain = ComputeSession(device="cpu", config=SSDConfig(**CFG))
    for sess in (placed, plain):
        v = []
        for i in range(0, 4, 2):
            v += sess.write_pair(f"p{i}", bits[i], f"p{i + 1}", bits[i + 1],
                                 die=i // 2)
        for die, (x, y) in enumerate(((v[0], v[1]), (v[2], v[3]))):
            assert sess.popcount(x.nor(y)) == int(
                (~(b[2 * die] | b[2 * die + 1])).sum())
    assert placed.sense_counted_roots == plain.sense_counted_roots == 2
    assert placed.placed_unit_dispatches == 2
    assert plain.placed_unit_dispatches == 0
    assert placed.ledger.summary() == plain.ledger.summary()
