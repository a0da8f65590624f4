"""The port's RBER-vs-endurance harness against the JAX package's.

Counting: on identical numpy Vth and bits, the port's kernel-path count
(sense, XOR with the packed oracle, popcount) equals the JAX package's
per-cell ``sum(execute_plan(plan, vth) != expected_result(...))`` exactly,
for every op, both plan families and Vth shifted across the references.

Drawing: the two packages draw Vth from different generators, so the
claims of ``tests/test_rber.py`` (Table 2, Fig 6, §5.3) are checked on the
port's own draws as rates over 4 seeds, each with the bits it was measured
over, and the rates at 10k P/E are held against the JAX package's own.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mcflash as ref_mcflash
from repro.core import rber as ref_rber
from repro.core import vth_model as ref_vth_model
from repro_torch.api.backends import Backend
from repro_torch.api.plan_cache import PlanCache
from repro_torch.core import encoding, rber, vth_model

torch.set_num_threads(1)

SEEDS = (0, 1, 2, 3)


def _rate(op, pages, seeds=SEEDS, part=None, **kw):
    """(errors, bits) of ``op`` summed over ``seeds`` on the CPU."""
    chip = vth_model.get_chip_model(part)
    runs = [rber.measure_rber(op, chip, pages=pages, seed=s, device="cpu",
                              **kw) for s in seeds]
    return sum(r.errors for r in runs), sum(r.bits for r in runs)


def test_chunk_count_equals_reference_oracle():
    """One 16 kB page programmed by the JAX model at 10k P/E (and 3k P/E
    with 1000 h of retention), shifted by -0.3..+0.3 V: for every op, with
    and without inverse reads, the counts agree exactly, and the plans are
    float-equal."""
    chip = vth_model.get_chip_model()
    ref_chip = ref_vth_model.get_chip_model()
    plans, backend = PlanCache(), Backend(torch.device("cpu"))
    rng = np.random.default_rng(5)
    n = rber.PAGE_BITS
    assert n == ref_rber.PAGE_BITS
    base = {}
    for i, (pe, hours) in enumerate(((10_000, 0.0), (3000, 1000.0))):
        lsb = (rng.random(n) < 0.5).astype(np.uint8)
        msb = (rng.random(n) < 0.5).astype(np.uint8)
        vth, _ = ref_vth_model.program_page(
            jax.random.PRNGKey(i), jnp.asarray(lsb), jnp.asarray(msb),
            ref_chip, n_pe=pe, retention_hours=hours)
        base[i] = (lsb, msb, np.asarray(vth))
    checked = 0
    for lsb, msb, vth in base.values():
        for shift in (-0.3, 0.0, 0.12, 0.3):
            cells = (vth + np.float32(shift)).astype(np.float32)
            for op in encoding.ALL_OPS:
                a = np.zeros_like(lsb) if op == "not" else lsb
                for inverse in (True, False):
                    plan = plans.get(op, chip, inverse)
                    ref_plan = ref_mcflash.plan_op(op, ref_chip, inverse)
                    assert plan.refs == ref_plan.refs and \
                        plan.kind == ref_plan.kind
                    want = int(jnp.sum(
                        ref_mcflash.execute_plan(ref_plan, jnp.asarray(cells))
                        != ref_mcflash.expected_result(
                            op, jnp.asarray(a), jnp.asarray(msb))))
                    got = rber.chunk_errors(
                        plan, op, torch.from_numpy(cells),
                        torch.from_numpy(a), torch.from_numpy(msb), backend)
                    assert got.dtype == torch.int64
                    assert int(got) == want, (op, inverse, shift)
                    checked += want > 0
    assert checked > 20          # the shifts put cells across the references


def test_rber_bounds_hold_as_rates_over_seeds():
    """tests/test_rber.py's claims on the port's draws, as rates over 4
    seeds, each op at the bits that test measures in one draw, split over
    the seeds: fresh pages error-free (2 pages x 4 seeds = 1,048,576 bits
    per op; 1 page x 4 per part); 1.5k-P/E XNOR in (0, 0.01%) (12 pages x 4
    = 6,291,456 bits); 10k P/E under 0.015% x 1.5 for and/or/xnor/not
    (3 pages x 4 = 1,572,864 bits each); OR worse at 10k than at 1.5k; NOT
    worse than AND at 3k P/E + 1000 h; and <= or <= 2 xnor at 10k (6 pages
    x 4 = 3,145,728 bits each)."""
    for op in ("and", "or", "xnor", "not"):
        errors, bits = _rate(op, 2)
        assert errors == 0 and bits == 4 * 2 * rber.PAGE_BITS, op
    for part in sorted(vth_model.CHIP_MODELS):
        assert _rate("and", 1, part=part)[0] == 0, part
    errors, bits = _rate("xnor", 12, n_pe=1500)
    assert bits == 6_291_456 and 0 < 100 * errors / bits < 0.01
    for op in ("and", "or", "xnor", "not"):
        errors, bits = _rate(op, 3, n_pe=10_000)
        assert 100 * errors / bits < 0.015 * 1.5, (op, errors, bits)
    or_15k = _rate("or", 3, n_pe=1500)
    or_10k = _rate("or", 3, n_pe=10_000)
    assert or_10k[0] / or_10k[1] > or_15k[0] / or_15k[1]
    and_ret = _rate("and", 3, n_pe=3000, retention_hours=1000)
    not_ret = _rate("not", 3, n_pe=3000, retention_hours=1000)
    assert not_ret[0] / not_ret[1] > and_ret[0] / and_ret[1]
    errs = {op: _rate(op, 6, n_pe=10_000)[0] for op in ("and", "or", "xnor")}
    assert errs["and"] <= errs["or"] <= 2 * errs["xnor"], errs


def test_rates_agree_with_reference_at_10k():
    """XNOR and NOT at 10k P/E over 12 pages (1,572,864 bits) per seed:
    the port's rate over 4 seeds and the JAX package's over the same 4
    seeds agree within 4 sigma of the difference of two binomial
    estimates; each package replays its own draws."""
    chip = vth_model.get_chip_model()
    ref_chip = ref_vth_model.get_chip_model()
    for op in ("xnor", "not"):
        got, bits = _rate(op, 12, n_pe=10_000)
        want = sum(ref_rber.measure_rber(op, ref_chip, pages=12,
                                         n_pe=10_000, seed=s).errors
                   for s in SEEDS)
        assert got > 0 and want > 0
        p = (got + want) / (2 * bits)
        assert abs(got - want) <= 4 * np.sqrt(2 * bits * p * (1 - p)), \
            (op, got, want, bits)
    again = rber.measure_rber("xnor", chip, pages=3, n_pe=10_000, seed=1,
                              pages_per_chunk=2, device="cpu")
    assert again == rber.measure_rber("xnor", chip, pages=3, n_pe=10_000,
                                      seed=1, pages_per_chunk=2, device="cpu")
    assert (again.pages, again.bits) == (3, 3 * rber.PAGE_BITS)
    assert str(again).startswith("XNOR  pages=3 bits=393216 errors=")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            rber.measure_rber("and", chip, pages=1)
