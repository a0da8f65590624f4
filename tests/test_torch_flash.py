"""The port's flash substrate against the JAX package's.

The same writes must give the same (die, slot) placement, the same vector
metadata (pages, roles, home die, encoding, checkwords) and the same ledger
entries.  Page reads inside realignment run through each package's plain
backend.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api.backends import SimBackend as RefSim
from repro.flash import energy as jenergy
from repro.flash import timing as jtiming
from repro.flash.arena import ShardedVthArena as RefArena
from repro.flash.device import FlashDevice as RefDevice
from repro.flash.ftl import FTL as RefFTL
from repro.flash.geometry import SSDConfig as RefConfig
from repro_torch.flash import energy as tenergy
from repro_torch.flash import timing as ttiming
from repro_torch.flash.arena import ShardedVthArena
from repro_torch.flash.device import FlashDevice
from repro_torch.flash.ftl import FTL
from repro_torch.flash.geometry import SSDConfig
from repro_torch.kernels.ref import unpack_bits

torch.set_num_threads(1)

CFG = dict(channels=2, dies_per_channel=2, page_kb=1, pages_per_block=8)


def _pair():
    ref_dev = RefDevice(config=RefConfig(**CFG))
    ref_dev.set_default_backend(RefSim())
    port_dev = FlashDevice(config=SSDConfig(**CFG), device="cpu")
    return RefFTL(ref_dev), FTL(port_dev)


def _meta(m):
    return (m.name, m.n_bits, list(m.pages), m.role, m.zero_co_page, m.die,
            m.encoding, None if m.check is None else m.check.tolist())


def _assert_same_state(ref, port):
    assert sorted(ref.vectors) == sorted(port.vectors)
    for name in ref.vectors:
        assert _meta(port.vectors[name]) == _meta(ref.vectors[name]), name
        assert port.group_of(name) == ref.group_of(name), name
    assert port.device._slot_of == ref.device._slot_of
    assert port.device.arena.shard_stats() == ref.device.arena.shard_stats()
    assert port.device.ledger.summary() == ref.device.ledger.summary()


def _bits(rng, n):
    return (rng.random(n) < 0.5).astype(np.uint8)


def test_writes_place_and_book_like_the_reference():
    rng = np.random.default_rng(0)
    ref, port = _pair()
    n = 3 * 8192 + 11
    a, b, c, d = (_bits(rng, n) for _ in range(4))
    t, j = torch.from_numpy, jnp.asarray
    ref.write_pair_aligned("a", j(a), "b", j(b))
    port.write_pair_aligned("a", t(a), "b", t(b))
    ref.write_scattered("c", j(c))
    port.write_scattered("c", t(c))
    ref.write_scattered("d", j(d), role="msb", die=3)
    port.write_scattered("d", t(d), role="msb", die=3)
    ref.write_group_aligned(["x", "y", "z"], [j(a), j(c), j(d)], encoding="tlc")
    port.write_group_aligned(["x", "y", "z"], [t(a), t(c), t(d)], encoding="tlc")
    ref.write_pair_aligned("r", j(b), "s", j(d), encoding="reduced-mlc")
    port.write_pair_aligned("r", t(b), "s", t(d), encoding="reduced-mlc")
    _assert_same_state(ref, port)
    # realignment: copyback two scattered vectors, regroup encoded ones,
    # build a NOT-ready copy — each reads pages, reprograms, and books
    ref.align("c", "d")
    port.align("c", "d")
    ref.align_group(["y", "x"])
    port.align_group(["y", "x"])
    ref.ensure_not_ready("a")
    port.ensure_not_ready("a")
    _assert_same_state(ref, port)
    assert port.group_for_sense(["a", "c", "b", "d"]) == \
        ref.group_for_sense(["a", "c", "b", "d"])
    # the realigned copies hold the original bits
    for name, want in (("c", c), ("d", d), ("y", c), ("x", a)):
        m = port.vectors[name]
        words = port.device.page_read_batch(m.pages, m.role, encoding=m.encoding)
        got = unpack_bits(words.reshape(1, -1))[0][:n].numpy()
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_erase_and_arena_allocation_match_reference():
    """Erase frees the same slots; the arena allocates, grows and recycles
    slots in the reference's order."""
    rng = np.random.default_rng(1)
    ref, port = _pair()
    bits = _bits(rng, 4 * 8192)
    ref.write_scattered("v", jnp.asarray(bits), die=1)
    port.write_scattered("v", torch.from_numpy(bits), die=1)
    plane, block, _ = ref.vectors["v"].pages[0]
    ref.device.erase_block(plane, block)
    port.device.erase_block(plane, block)
    assert port.device.pe_counts == ref.device.pe_counts
    ref.write_scattered("w", jnp.asarray(bits), die=1)
    port.write_scattered("w", torch.from_numpy(bits), die=1)
    _assert_same_state(ref, port)
    ref, port = RefArena(4096, n_dies=3, init_slots=2), ShardedVthArena(
        4096, n_dies=3, init_slots=2, device="cpu")
    got, want = [], []
    for die, n in ((0, 1), (2, 3), (0, 4), (1, 1), (2, 5)):
        got.append(port.alloc(die, n))
        want.append(ref.alloc(die, n))
    port.free(got[1][:2] + got[2][1:])
    ref.free(want[1][:2] + want[2][1:])
    got.append(port.alloc(2, 3, encoding="tlc"))
    want.append(ref.alloc(2, 3, encoding="tlc"))
    got.append(port.alloc(0, 6))
    want.append(ref.alloc(0, 6))
    assert got == want
    assert port.shard_stats() == ref.shard_stats()
    assert port.capacity == ref.capacity and port.grows == ref.grows


def test_arena_gather_and_load_shards():
    rng = np.random.default_rng(2)
    arena = ShardedVthArena(4096, n_dies=2, device="cpu")
    refs = arena.alloc(0, 3) + arena.alloc(1, 2)
    rows = torch.from_numpy(rng.normal(size=(5, 4096)).astype(np.float32))
    arena.write(refs, rows)
    order = [3, 0, 4, 1, 2]
    assert torch.equal(arena.gather([refs[i] for i in order]), rows[order])
    exported = {d: arena.shard(d).buf.numpy() * 2 for d in (0, 1)}
    arena.load_shards(exported)
    assert torch.equal(arena.gather(refs), rows * 2)
    with pytest.raises(ValueError, match="do not fit"):
        arena.load_shards({0: np.zeros((99, 4096), np.float32)})
    with pytest.raises(ValueError, match="auto"):   # "auto" means the cards
        FlashDevice(config=SSDConfig(**CFG), device="cpu", shard_devices="auto")


def test_timing_and_energy_models_equal_reference():
    tm, jtm = ttiming.TimingModel(), jtiming.TimingModel()
    em, jem = tenergy.EnergyModel(), jenergy.EnergyModel()
    for op in ("and", "or", "not", "xnor", "nand", "nor", "xor"):
        assert tm.op_latency_us(op) == jtm.op_latency_us(op)
        assert em.read_energy_uj_kb(op) == jem.read_energy_uj_kb(op)
        assert em.mcflash_op_energy_uj_kb(op, False) == \
            jem.mcflash_op_energy_uj_kb(op, False)
    for aligned in (True, False):
        assert ttiming.mcflash_time_us(tm, aligned) == \
            jtiming.mcflash_time_us(jtm, aligned)
    assert ttiming.isc_time_us(tm) == jtiming.isc_time_us(jtm)
    assert ttiming.osc_time_us(tm) == jtiming.osc_time_us(jtm)
    cfg, jcfg = SSDConfig(), RefConfig()
    assert (cfg.dies, cfg.planes, cfg.page_bits) == (jcfg.dies, jcfg.planes,
                                                     jcfg.page_bits)
