"""The plain reference: its packing, and its answers against the port's on
the CPU at a tiny size.

    python -m pytest mcbench/tests
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from mcbench import data, harness, loadgen, queries
from mcbench.reference import Reference, lane_major_words

BENCH = Path(__file__).resolve().parents[1]
TINY = {"users": 2 ** 14, "ssd": {"channels": 4, "dies_per_channel": 8,
                                  "planes_per_die": 1, "page_kb": 1}}
MIXES = {"fig10-bitmap-mlc": ["cohort_scan", "daypair_host"],
         "ambit-weekly-mlc": ["weekly_steady"]}


def numpy_lane_major(bits: np.ndarray) -> np.ndarray:
    tiles = np.ascontiguousarray(bits.reshape(-1, 32, 128).transpose(0, 2, 1))
    return np.packbits(tiles, axis=-1, bitorder="little").view("<u4").reshape(-1)


def test_lane_major_words_match_numpy_packbits():
    gen = torch.Generator().manual_seed(5)
    bits = (torch.rand(3 * 4096, generator=gen) < 0.5).to(torch.uint8)
    got = lane_major_words(bits).numpy().view(np.uint32)
    assert np.array_equal(got, numpy_lane_major(bits.numpy()))
    with pytest.raises(ValueError):
        lane_major_words(bits[:100])


def test_bits_come_from_the_seed_alone():
    cfg = {**json.loads((BENCH / "configs" / "ambit-weekly-mlc.json")
                        .read_text()), **TINY}
    a = [b for _, _, b in data.group_bits(cfg, 2 ** 33 + 1, "cpu")]
    b = [b for _, _, b in data.group_bits(cfg, 2 ** 33 + 1, "cpu")]
    c = [b for _, _, b in data.group_bits(cfg, 2 ** 33 + 2, "cpu")]
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not all(torch.equal(x, y) for x, y in zip(a, c))
    male = a[-1][1].float().mean().item()
    day = torch.cat([x.float() for x in a[:-1]]).mean().item()
    assert abs(male - 0.5) < 0.02 and abs(day - 0.3) < 0.02


@pytest.mark.parametrize("config", sorted(MIXES))
def test_reference_agrees_with_the_port(config):
    """Every distinct query of every mix, answered by the port's session on
    the CPU and by the reference."""
    from repro_torch.serve import QueryEngine

    cfg = {**json.loads((BENCH / "configs" / f"{config}.json").read_text()),
           **TINY}
    seed = 2 ** 35 + 3
    sess = harness.open_session(cfg, seed, "cpu", False)
    harness.program(sess, cfg, seed, "cpu", lambda: None)
    ref = Reference(cfg, seed, "cpu")
    checked = 0
    for mix in MIXES[config]:
        for q in loadgen.distinct_queries(loadgen.load_mix(mix), cfg):
            exprs = queries.kind(q[0]).roots(sess, q, cfg)
            want = ref.answer(q)
            if q[0] == "range_count":
                assert [sess.popcount(e) for e in exprs] == want, q
            elif q[0] == "group_words":
                got = [sess.materialize_async(e).result() for e in exprs]
                assert len(got) == len(want) == 1
                assert np.array_equal(got[0], want[0].numpy().view(np.uint32)), q
            else:
                eng = QueryEngine(sess)
                tickets = [eng.submit(e, popcount=True) for e in exprs]
                assert eng.drain(tickets) == want, q
            checked += 1
    assert checked >= 21
