"""The port's device debug surface, FTL accessors and retention aging
against the JAX package's.

Both packages take the same writes; the port's arena is then loaded with
the JAX arena's Vth rows, so every read senses identical cells.  Stored
page bits, row encodings, the per-op oracle, single-wordline MCFlash reads
and their ledger entries must then agree exactly, and so must the Vth rows
after ``FlashDevice.age`` (to 0 ulp) and the recovery ladder's outcome on
them.
"""
import numpy as np
import pytest
import torch

from repro.api import ComputeSession as RefSession
from repro.flash.device import FlashDevice as RefDevice
from repro.flash.ftl import FTL as RefFTL
from repro.flash.geometry import SSDConfig as RefConfig
from repro_torch.api.hostio import to_numpy
from repro_torch.api.session import ComputeSession
from repro_torch.core import encoding as tencoding
from repro_torch.flash.device import FlashDevice
from repro_torch.flash.ftl import FTL
from repro_torch.flash.geometry import SSDConfig

torch.set_num_threads(1)

CFG = dict(channels=1, dies_per_channel=2, page_kb=1, pages_per_block=8)


def _bits(rng, n):
    return (rng.random(n) < 0.5).astype(np.uint8)


def _load_reference_rows(port, ref):
    port.device.load_vth({die: np.asarray(shard.buf)
                          for die, shard in ref.device.arena._shards.items()})


def _sessions(encoding, faults=None, **kw):
    ref = RefSession(config=RefConfig(**CFG), backend="sim",
                     encoding=encoding, faults=faults, **kw)
    port = ComputeSession(device="cpu", config=SSDConfig(**CFG),
                          encoding=encoding, faults=faults, **kw)
    return ref, port


@pytest.mark.parametrize("encoding", ["mlc", "tlc", "reduced-mlc"])
def test_debug_surface_matches_reference(encoding):
    """After the same writes (an aligned group, a scattered vector, a
    realignment): the same stored page bits and row encoding per wordline,
    the same oracle words, the same single-wordline MCFlash reads (packed
    and unpacked) and ledger, the same FTL accessors; erase drops the
    records in both.  Overwriting the written arrays and tensors afterwards
    changes no stored record."""
    rng = np.random.default_rng(3)
    n = 2 * 8192 + 5
    bits = [_bits(rng, n) for _ in range(4)] + [_bits(rng, 8192)]
    ref, port = _sessions(encoding)
    # the JAX package gets copies (on the CPU it may alias numpy arrays);
    # the port gets the arrays, or tensors over them, that are then
    # overwritten: "e" fills a whole page, so the FTL pads (copies) nothing
    mine = [torch.from_numpy(b) for b in bits]
    mine = bits[:3] + mine[3:4] + [bits[4] if encoding == "tlc" else mine[4]]
    for s, v in ((ref, [b.copy() for b in bits]), (port, mine)):
        if encoding == "tlc":
            s.write_triple("a", v[0], "b", v[1], "c", v[2])
        else:
            s.write_pair("a", v[0], "b", v[1])
            s.write("c", v[2])
        s.write("d", v[3], role="msb", die=1)
        s.ftl.align_group(["c", "d"])
        s.write("e", v[4])
    for b in bits:
        b ^= 1
    _load_reference_rows(port, ref)
    wls = list(ref.device._operands)
    assert list(port.device._operands) == wls
    ops = tencoding.ALL_OPS
    for wl in wls:
        want = [np.asarray(p) for p in ref.device.stored_operands(wl)]
        got = [p.numpy() for p in port.device.stored_operands(wl)]
        assert len(got) == len(want) == (3 if encoding == "tlc" else 2)
        for g, w in zip(got, want):
            assert g.dtype == np.uint8
            np.testing.assert_array_equal(g, w)
        assert port.device.encoding_of(wl) == ref.device.encoding_of(wl) \
            == encoding
        for op in ops:
            if encoding == "tlc":
                with pytest.raises(ValueError, match="2-operand"):
                    port.device.expected(wl, op)
            else:
                np.testing.assert_array_equal(
                    port.device.expected(wl, op).numpy(),
                    np.asarray(ref.device.expected(wl, op)))
    for wl in wls[:3]:
        for op in ("and", "xnor", "not"):
            np.testing.assert_array_equal(
                to_numpy(port.device.mcflash_read(wl, op)),
                np.asarray(ref.device.mcflash_read(wl, op)))
            np.testing.assert_array_equal(
                port.device.mcflash_read(wl, op, packed=False,
                                         switch_op=False).numpy(),
                np.asarray(ref.device.mcflash_read(wl, op, packed=False,
                                                   switch_op=False)))
        ref.device.dma_to_controller(wl)
        port.device.dma_to_controller(wl)
    assert port.ledger.summary() == ref.ledger.summary()
    for name in ref.ftl.vectors:
        assert port.ftl.die_of(name) == ref.ftl.die_of(name)
        assert port.ftl.encoding_of(name) == ref.ftl.encoding_of(name)
    assert port.ftl.session is port and ref.ftl.session is ref
    plane, block, _ = wls[0]
    for dev in (ref.device, port.device):
        dev.erase_block(plane, block)
    for dev in (ref.device, port.device):
        with pytest.raises(KeyError):
            dev.stored_operands(wls[0])
    assert list(port.device._operands) == list(ref.device._operands)
    # a bare FTL builds its session on first use, on its device's card
    bare = FTL(FlashDevice(config=SSDConfig(**CFG), device="cpu"))
    ref_bare = RefFTL(RefDevice(config=RefConfig(**CFG)))
    assert bare.session.ftl is bare and bare.session is bare.session
    assert bare.session.torch_device.type == "cpu"
    assert ref_bare.session.ftl is ref_bare


def test_age_matches_reference_on_loaded_rows():
    """5k P/E MLC: after ``age(5000 h)`` on rows loaded from the JAX arena,
    both arenas hold the same float32 rows bit for bit and the same
    ``aged_hours``; both recover ``a ^ b`` to the same words with the same
    retries, no fewer than before aging; a second ``age`` compounds alike
    and ``age`` without a fault model changes nothing."""
    rng = np.random.default_rng(21)
    n = 8192
    ba, bb = _bits(rng, n), _bits(rng, n)
    ref, port = _sessions("mlc", faults={"pe": 5000, "seed": 9})
    pairs = [s.write_pair("a", ba, "b", bb) for s in (ref, port)]
    _load_reference_rows(port, ref)
    want = (ba ^ bb).astype(bool)
    before = []
    for s, (a, b) in zip((ref, port), pairs):
        got = np.asarray(s.materialize(a ^ b, unpacked=True)).astype(bool)
        np.testing.assert_array_equal(got, want)
        before.append(s.stats()["reliability"]["retries"])
    assert before[0] == before[1]
    for hours in (5000.0, 700.0):
        ref.device.age(hours)
        port.device.age(hours)
        assert port.device.faults.aged_hours == ref.device.faults.aged_hours
        for die, shard in ref.device.arena._shards.items():
            np.testing.assert_array_equal(
                port.device.arena.shard(die).buf.numpy(),
                np.asarray(shard.buf))
    words = [np.asarray(ref.materialize(pairs[0][0] ^ pairs[0][1])),
             to_numpy(port.materialize(pairs[1][0] ^ pairs[1][1]))]
    np.testing.assert_array_equal(words[1], words[0])
    after = [s.stats()["reliability"]["retries"] for s in (ref, port)]
    assert after[1] == after[0] >= before[0]
    got = port.materialize(pairs[1][0] ^ pairs[1][1], unpacked=True)
    np.testing.assert_array_equal(got.numpy().astype(bool), want)
    plain = ComputeSession(device="cpu", config=SSDConfig(**CFG))
    plain.write_pair("a", ba, "b", bb)
    rows = plain.device.arena.shard(0).buf.clone()
    plain.device.age(5000.0)
    assert torch.equal(plain.device.arena.shard(0).buf, rows)
