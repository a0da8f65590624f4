"""Ledger costs booked from per-page-list die and channel counts.

``FlashDevice.mcflash_cost`` / ``page_read_cost`` / ``dma_cost`` read a
command's cost from each page list's cached placement profile (its page
counts per die and per channel, in order of first appearance) and an exact
n-fold sum of the per-page latency.  Their dicts must equal, value for
value and in key order, both the JAX package's per-wordline loops over the
concatenated pages and a per-wordline loop kept here, on random units of
1-15 lists; the n-fold sum must equal the running sum for every latency;
profiles are built once per list and rebuilt only for a new or resized
list, never for a slot move; and a cohort-shaped session books the same
ledger as the reference's.
"""
import random

import numpy as np
import pytest
import torch

from repro.api import ComputeSession as RefSession
from repro.flash.device import FlashDevice as RefDevice
from repro.flash.geometry import SSDConfig as RefConfig
from repro_torch.api.session import ComputeSession
from repro_torch.core.encoding import OP_SENSING_PHASES
from repro_torch.flash.device import PAGE_READ_OP, FlashDevice
from repro_torch.flash.geometry import SSDConfig
from repro_torch.flash.timing import TimingModel

torch.set_num_threads(1)

CFG = dict(channels=4, dies_per_channel=4, page_kb=1)
N_BITS = 2 * 8192 + 40           # three 1 kB pages a vector


@pytest.fixture(autouse=True)
def _plain_env(monkeypatch):
    monkeypatch.delenv("REPRO_VERIFY", raising=False)
    monkeypatch.delenv("REPRO_FAULTS", raising=False)


def _loop(dev, wls, us, of):
    """The per-wordline running sum the costs were booked by."""
    out = {}
    for wl in wls:
        key = of(wl[0])
        out[key] = out.get(key, 0.0) + us
    return out


def _page_list(rng, cfg):
    n = rng.choice([0, 1, rng.randint(2, 40), rng.randint(41, 3000)])
    if rng.random() < 0.5:                      # every page on one die
        die = rng.randrange(cfg.dies)
        planes = [die * cfg.planes_per_die + p
                  for p in range(cfg.planes_per_die)]
    else:                                       # scattered across dies
        planes = range(cfg.planes)
    return [(rng.choice(planes), rng.randrange(cfg.blocks_per_plane),
             rng.randrange(64)) for _ in range(n)]


def test_unit_costs_equal_the_reference_loops_in_value_and_order():
    rng = random.Random(28)
    cfg = SSDConfig(**CFG)
    dev = FlashDevice(config=cfg, device="cpu")
    ref = RefDevice(config=RefConfig(**CFG))
    lists = [_page_list(rng, cfg) for _ in range(40)]
    dma_us = cfg.page_bytes / (cfg.channel_bw_gbps * 1e3)
    used = {}
    for trial in range(60):
        unit = [rng.choice(lists) for _ in range(rng.randint(1, 15))]
        used.update((id(wls), wls) for wls in unit)
        flat = [wl for wls in unit for wl in wls]
        if trial % 4 == 0:
            op, phases = rng.choice(sorted(OP_SENSING_PHASES)), None
        else:                                   # an encoded plan's phases
            op, phases = "parity", rng.randint(1, 7)
        switch = rng.random() < 0.5
        want_die, want_uj = ref.mcflash_cost(flat, op, switch_op=switch,
                                             phases=phases)
        mine = _loop(dev, flat, dev.timing.op_latency_us(
            op, switch_op=False, phases=phases), dev.die_of_plane)
        if switch and flat:
            mine[dev.die_of_plane(flat[0][0])] += dev.timing.t_setfeature_us
        got_die, got_uj = dev.mcflash_cost(unit, op, switch_op=switch,
                                           phases=phases)
        assert list(got_die.items()) == list(want_die.items()) \
            == list(mine.items())
        assert got_uj == want_uj
        which = rng.choice(sorted(PAGE_READ_OP))
        want_die, want_uj = ref.page_read_cost(flat, which, phases)
        mine = _loop(dev, flat, dev.timing.read_latency_us(
            PAGE_READ_OP[which], phases), dev.die_of_plane)
        got_die, got_uj = dev.page_read_cost(unit, which, phases)
        assert list(got_die.items()) == list(want_die.items()) \
            == list(mine.items())
        assert got_uj == want_uj
        want_ch = ref.dma_cost(flat)
        mine = _loop(dev, flat, dma_us, dev._channel_of_plane)
        assert list(dev.dma_cost(unit).items()) \
            == list(want_ch.items()) == list(mine.items())
    # every list of two pages or more was profiled once, then reused
    assert dev.placement_profile_builds == sum(
        1 for wls in used.values() if len(wls) > 1)
    assert dev.placement_profile_reuses > dev.placement_profile_builds


def test_n_fold_sum_equals_the_running_sum_for_every_latency():
    rng = random.Random(5)
    for timing in (TimingModel(), TimingModel(t_sense_us=30.1,
                                              t_fixed_us=9.7)):
        dev = FlashDevice(config=SSDConfig(**CFG), timing=timing,
                          device="cpu")
        lats = {timing.read_latency_us(op) for op in OP_SENSING_PHASES}
        lats |= {timing.read_latency_us("and", p) for p in range(1, 8)}
        lats |= {kb * 1024 / (1.2 * 1e3) for kb in (1, 4, 16)}
        inexact = 0
        for us in sorted(lats):
            sums, acc = [0.0], 0.0
            for _ in range(10_000):
                acc += us
                sums.append(acc)
            order = list(range(len(sums)))
            rng.shuffle(order)
            for n in order:
                assert dev._n_fold(us, n) == sums[n], (us, n)
            inexact += sum(1 for n, s in enumerate(sums) if n * us != s)
        assert inexact > 0          # n * us alone would not do


def _pair_session(rng):
    sess = ComputeSession(device="cpu", config=SSDConfig(**CFG))
    bits = [(rng.random(N_BITS) < 0.6).astype(np.uint8) for _ in range(8)]
    a, b = sess.write_pair("a", bits[0], "b", bits[1], die=0)
    c, d = sess.write_pair("c", bits[2], "d", bits[3], die=1)
    sess.write_pair("x", bits[4], "y", bits[5], die=2)
    e, f = sess.write("e", bits[6]), sess.write("f", bits[7])
    return sess, bits, (a, b, c, d, e, f)


def test_profiles_built_once_per_list_and_kept_across_slot_moves():
    rng = np.random.default_rng(28)
    sess, bits, (a, b, c, d, e, f) = _pair_session(rng)
    dev = sess.device

    def count(expr, want):
        assert sess.popcount(expr) == int(want.sum())
        return sess.placement_profile_builds, sess.placement_profile_reuses

    chain = sess.chain("and", [a, b, c, d])
    want = bits[0] & bits[1] & bits[2] & bits[3]
    sess.reset_stats()
    # two page lists: looked up by lowering, then by the die and the
    # channel costs of the fused unit
    assert count(chain, want) == (2, 4)
    assert count(chain, want) == (2, 10)
    assert sess.stats()["placement_profile_builds"] == 2
    # a copyback realignment places e and f on a new page list: one build
    sess.reset_stats()
    assert count(e & f, bits[6] & bits[7]) == (1, 2)
    assert count(e & f, bits[6] & bits[7]) == (1, 5)
    # freeing a pair's rows moves slots: slot tables rebuild, profiles not
    sess.reset_stats()
    version = dev.slot_version
    for plane, block in sorted({wl[:2] for wl in sess.ftl.vectors["x"].pages}):
        dev.erase_block(plane, block)
    assert dev.slot_version > version
    assert count(chain, want) == (0, 6)
    assert sess.slot_table_builds == 2
    # a list that changed length is profiled anew, with its new page
    wls = list(sess.ftl.vectors["a"].pages)
    builds = dev.placement_profile_builds
    dies, channels = dev.placement_profile(wls)
    assert dev.placement_profile(wls) == (dies, channels)
    assert dev.placement_profile_builds == builds + 1
    wls.append(sess.ftl.vectors["c"].pages[0])
    dies2, _ = dev.placement_profile(wls)
    assert dev.placement_profile_builds == builds + 2
    assert list(dies2) == list(dies) + [1]
    assert sum(dies2.values()) == len(wls)


def test_cohort_shaped_session_books_the_reference_ledger():
    rng = np.random.default_rng(7)
    bits = [(rng.random(N_BITS) < 0.8).astype(np.uint8) for _ in range(6)]
    names = [f"d{i}" for i in range(6)]
    ref = RefSession(config=RefConfig(**CFG), backend="sim")
    port = ComputeSession(device="cpu", config=SSDConfig(**CFG), trace=True)
    for sess in (ref, port):
        for i in range(0, 6, 2):
            sess.write_pair(names[i], bits[i], names[i + 1], bits[i + 1],
                            die=i // 2)
        sess.ledger.reset()
    want = int(np.bitwise_and.reduce(bits).sum())
    for sess in (ref, port):
        assert sess.popcount(sess.chain("and", [sess[n] for n in names])) \
            == want
        sess.materialize(sess["d2"] & sess["d3"])
    assert port.ledger.summary() == ref.ledger.summary()
    for got, exp in ((port.ledger.die_busy_us, ref.ledger.die_busy_us),
                     (port.ledger.channel_busy_us,
                      ref.ledger.channel_busy_us)):
        assert list(got.items()) == list(exp.items())
    built = [s.args["profiles_built"] for s in port.trace.wall_spans
             if s.category == "account"]
    assert built == [3, 0]
