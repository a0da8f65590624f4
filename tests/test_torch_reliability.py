"""The port's reliability layer against the JAX package's.

The fault models draw from different generators (``torch.Generator`` in the
port, ``jax.random`` in the JAX package), so they are compared in
distribution.  The recovery ladder is compared exactly once the port's
arena holds the JAX arena's *perturbed* rows (loaded after both packages
programmed the same writes under the same fault config): the same first
detection, the same retry offsets, the same counters, the same ledger
categories and the same words.  A dead block under written data is
unrecoverable by any read in both packages: both retire the blocks and
raise ``BlockRetiredError``, and once the lost vectors are rewritten from
the host's copy no bit error remains.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.api import ComputeSession as RefSession
from repro.flash.geometry import SSDConfig as RefConfig
from repro.reliability import BlockRetiredError as RefBlockRetired
from repro.reliability import FaultConfig as RefFaultConfig
from repro.reliability import FaultModel as RefFaultModel
from repro.reliability import RetryPolicy as RefRetryPolicy
from repro_torch.api.hostio import to_numpy
from repro_torch.api.session import ComputeSession
from repro_torch.core.calibration import shift_plan
from repro_torch.flash.geometry import SSDConfig
from repro_torch.reliability import (BlockRetiredError, FaultConfig,
                                     FaultModel, RetryPolicy)
from repro_torch.reliability.faults import STUCK_VTH

torch.set_num_threads(1)

SPECS = (None, False, "", True, 0, 7000, "10000", "off", "none",
         "pe=5000,seed=3,spread_v=0.1", " pe=2000 , retention_hours=24",
         {"pe": 3000, "dead_blocks": ((0, 1),)},
         "stuck_bit_pct=0.5,mean_shift_v=0.2")


def _load_reference_rows(port, ref):
    port.device.load_vth({die: np.asarray(shard.buf)
                          for die, shard in ref.device.arena._shards.items()})


def _sessions(faults, encoding, n_bits, seed=21, **kw):
    """Both packages' sessions with the same faulted writes of one pair;
    the port's arena then holds the JAX arena's perturbed rows."""
    cfg = dict(page_kb=1, channels=1, dies_per_channel=2)
    ref = RefSession(config=RefConfig(**cfg), backend="sim",
                     encoding=encoding, faults=faults, **kw)
    port = ComputeSession(device="cpu", config=SSDConfig(**cfg),
                          encoding=encoding, faults=faults, **kw)
    rng = np.random.default_rng(seed)
    bits = [(rng.random(n_bits) < 0.5).astype(np.uint8) for _ in range(2)]
    pairs = [s.write_pair("a", bits[0], "b", bits[1]) for s in (ref, port)]
    _load_reference_rows(port, ref)
    return (ref, port), pairs, bits


def test_specs_and_policy_parse_alike(monkeypatch):
    """Every spec form gives the same FaultConfig (or the same error), the
    policies' ladders agree, and both sessions take ``$REPRO_FAULTS``."""
    for spec in SPECS:
        want, got = RefFaultConfig.parse(spec), FaultConfig.parse(spec)
        assert (got is None) == (want is None), spec
        if got is not None:
            assert dataclasses.asdict(got) == dataclasses.asdict(want), spec
    for bad, err in (("bogus_knob=1", ValueError), ([1], TypeError)):
        for parse in (RefFaultConfig.parse, FaultConfig.parse):
            with pytest.raises(err):
                parse(bad)
    for trim in (0.0, -0.4, 0.24):
        assert RetryPolicy().ladder_offsets(trim) == \
            RefRetryPolicy().ladder_offsets(trim)
    assert dataclasses.asdict(RetryPolicy.parse({"escalation": ["retry"]})) \
        == dataclasses.asdict(RefRetryPolicy.parse({"escalation": ["retry"]}))
    monkeypatch.setenv("REPRO_FAULTS", "pe=2000,seed=7")
    cfg = dict(page_kb=1)
    ref = RefSession(config=RefConfig(**cfg), backend="sim")
    port = ComputeSession(device="cpu", config=SSDConfig(**cfg))
    assert port.stats()["faults"] == ref.stats()["faults"]
    assert port.reliability is not None and ref.reliability is not None
    assert port.stats()["reliability"]["policy"] == \
        ref.stats()["reliability"]["policy"]
    off = ComputeSession(device="cpu", config=SSDConfig(**cfg),
                         recovery="off")
    assert off.reliability is None and off.device.faults is not None


def test_perturb_and_calibration_match_reference_in_distribution():
    """Mean shift, spread bounds, stuck fraction and the dead-block range
    agree; each package replays its own draws.  Tolerances: the mean of
    2**16 uniform(-spread, spread) draws lies within 4 sigma
    (spread / sqrt(3 * 2**16)) of 0 in each package; the stuck fraction of
    2**16 Bernoulli(p) draws within 4 sigma of p.  The calibration sweep
    (Fig 7) gives the same offsets, RBER curves within 4 sigma of the
    difference of two 2**16-cell estimates (plus 3 cells), and best
    offsets within one sweep step."""
    import jax.numpy as jnp

    from repro.core.calibration import calibrate as ref_calibrate
    from repro.core.calibration import calibrated_plan as ref_calibrated_plan
    from repro.core.vth_model import get_chip_model as ref_chip_model
    from repro_torch.core.calibration import calibrate, calibrated_plan
    from repro_torch.core.vth_model import get_chip_model

    cells = 1 << 16
    for op, pe in (("and", 0), ("xor", 10_000), ("not", 10_000)):
        want = ref_calibrate(op, ref_chip_model(), n_pe=pe, n_bits=cells)
        got = calibrate(op, get_chip_model(), n_pe=pe, n_bits=cells,
                        device="cpu")
        assert got.offsets_v == pytest.approx(want.offsets_v)
        for r_pct, p_pct in zip(want.rber_pct, got.rber_pct):
            q = r_pct / 100
            tol = 100 * (4 * np.sqrt(2 * q * (1 - q) / cells) + 3 / cells)
            assert abs(p_pct - r_pct) <= tol, (op, pe)
        step = want.offsets_v[1] - want.offsets_v[0]
        assert abs(got.best_offset_v - want.best_offset_v) <= step + 1e-9
        assert abs(got.zero_window_v - want.zero_window_v) <= step + 1e-9
        plan = calibrated_plan(op, get_chip_model(), n_pe=pe, n_bits=cells,
                               device="cpu")
        ref_plan = ref_calibrated_plan(op, ref_chip_model(), n_pe=pe,
                                       n_bits=cells)
        assert (plan.op, plan.kind, plan.sensing_phases) == \
            (ref_plan.op, ref_plan.kind, ref_plan.sensing_phases)
        assert plan.refs == pytest.approx(ref_plan.refs, abs=step + 0.01)

    n = 1 << 16
    base = np.linspace(-1.0, 5.0, n, dtype=np.float32)
    for pe in (1000, 5000, 10_000):
        cfg = dict(pe=pe, seed=3)
        port = FaultModel(FaultConfig(**cfg))
        ref = RefFaultModel(RefFaultConfig(**cfg))
        assert port.wear() == ref.wear()
        s = port.wear()
        got = port.perturb(torch.from_numpy(base), plane=1, block=2, wl=3)
        want = np.asarray(ref.perturb(jnp.asarray(base), plane=1, block=2,
                                      wl=3))
        for delta in (got.numpy() - base, want - base):
            lo = -0.38 * s - 0.10 * s - 1e-5
            hi = -0.38 * s + 0.10 * s + 1e-5
            assert delta.min() >= lo and delta.max() <= hi, pe
            sigma = 0.10 * s / np.sqrt(3 * n)
            assert abs(delta.mean() + 0.38 * s) < 4 * sigma, pe
            assert delta.max() - delta.min() > 1.9 * 0.10 * s   # full spread
        again = port.perturb(torch.from_numpy(base), plane=1, block=2, wl=3)
        assert torch.equal(got, again)                      # replayable
        other = port.perturb(torch.from_numpy(base), plane=1, block=2, wl=4)
        assert not torch.equal(got, other)
    p = 0.02
    cfg = dict(pe=0, seed=5, stuck_bit_pct=100 * p, dead_blocks=((0, 1),))
    port = FaultModel(FaultConfig(**cfg))
    ref = RefFaultModel(RefFaultConfig(**cfg))
    for model, vth in ((port, torch.from_numpy(base)),
                       (ref, jnp.asarray(base))):
        stuck = np.asarray(model.perturb(vth, plane=0, block=2, wl=0))
        frac = float(np.mean(stuck == STUCK_VTH))
        assert abs(frac - p) < 4 * np.sqrt(p * (1 - p) / n)
        dead = np.asarray(model.perturb(vth, plane=0, block=1, wl=0))
        assert dead.min() >= -1.0 and dead.max() < STUCK_VTH
        assert dead.min() < -0.9 and dead.max() > STUCK_VTH - 0.1
        assert abs(float(dead.mean()) - (STUCK_VTH - 1.0) / 2) < 0.05
        assert model.is_dead(0, 1) and not model.is_dead(0, 2)


def test_ladder_matches_reference_on_loaded_rows():
    """TLC at 5k P/E: both packages detect the same mismatch, walk the same
    retry offsets to the same accepted offset (no recalibration, no
    migration), book the same recovery time, and return the same words;
    the recovered result equals the oracle, the popcount and the batch path
    too, and a shifted plan's references move by the offset."""
    (ref, port), ((ra, rb), (pa, pb)), bits = _sessions(
        {"pe": 5000, "seed": 9}, "tlc", 2 * 8192)
    want = (bits[0] ^ bits[1]).astype(bool)
    r_words = np.asarray(ref.materialize(ra ^ rb))
    p_words = to_numpy(port.materialize(pa ^ pb))
    np.testing.assert_array_equal(p_words, r_words)
    r_inc, p_inc = ref.reliability.incidents, port.reliability.incidents
    assert p_inc == r_inc and len(p_inc) == 1
    assert p_inc[0]["offset"] == pytest.approx(-0.24)
    assert p_inc[0]["retries"] == 4 and not p_inc[0]["recalibrated"]
    for key in ("checks", "mismatches", "retries", "recalibrations",
                "migrations", "retired_blocks", "ref_trim", "wear",
                "rber_histogram"):
        assert port.stats()["reliability"][key] == \
            ref.stats()["reliability"][key], key
    assert port.ledger.category_us == ref.ledger.category_us
    assert port.ledger.category_us["recovery"] > 0
    assert port.ledger.makespan_us() == ref.ledger.makespan_us()
    got = port.materialize(pa ^ pb, unpacked=True).numpy().astype(bool)
    np.testing.assert_array_equal(got, want)
    assert port.popcount(pa ^ pb) == ref.popcount(ra ^ rb) == int(want.sum())
    assert port.materialize_batch([pa ^ pb, pa & pb], popcount=[True, True]) \
        == [int(want.sum()), int((bits[0] & bits[1]).sum())]
    plan = port.lower(pa ^ pb).groups[0].plan
    shifted = shift_plan(plan, -0.24)
    assert shifted.refs == pytest.approx([r - 0.24 for r in plan.refs])


def test_dead_block_retires_then_rewrite_reads_clean():
    """10k P/E with a dead block under the written pair, under mlc and
    reduced-mlc: both packages walk the whole ladder, retire the same blocks
    and raise BlockRetiredError; the rewritten vectors land on healthy
    blocks and every Table-1 op then reads back with zero bit errors, with
    the same counters in both."""
    for encoding in ("mlc", "reduced-mlc"):
        _check_dead_block(encoding)


def _check_dead_block(encoding):
    faults = {"pe": 10_000, "seed": 2, "dead_blocks": ((0, 0),)}
    (ref, port), ((ra, rb), (pa, pb)), bits = _sessions(
        faults, encoding, 3 * 8192)
    assert (0, 0, 0) in port.ftl.vectors["a"].pages
    errors = {}
    for sess, err, (a, b) in ((ref, RefBlockRetired, (ra, rb)),
                              (port, BlockRetiredError, (pa, pb))):
        with pytest.raises(err, match="unrecoverable data") as exc:
            sess.materialize(a & b)
        errors[sess is port] = exc.value.blocks
        sess.write_pair("a", bits[0], "b", bits[1])      # from the host copy
    assert errors[True] == errors[False] and (0, 0) in errors[True]
    pages = port.ftl.vectors["a"].pages
    assert pages == ref.ftl.vectors["a"].pages
    assert all((p, b) not in errors[True] for p, b, _ in pages)
    x, y = (bits[0].astype(bool), bits[1].astype(bool))
    oracles = {"and": x & y, "or": x | y, "xor": x ^ y, "nand": ~(x & y),
               "nor": ~(x | y), "xnor": ~(x ^ y), "not": ~y}
    for op, want in oracles.items():
        for sess in (ref, port):
            a, b = sess["a"], sess["b"]
            expr = ~b if op == "not" else a._binary(op, b)
            got = np.asarray(sess.materialize(expr, unpacked=True))
            assert int(np.count_nonzero(got.astype(bool) != want)) == 0, op
    for key in ("mismatches", "retries", "recalibrations", "migrations",
                "retired_blocks"):
        assert port.stats()["reliability"][key] == \
            ref.stats()["reliability"][key], key
    assert port.stats()["reliability"]["recalibrations"] == 1
    assert port.ledger.category_us["recovery"] > 0
