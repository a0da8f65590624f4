"""The port's core model against the JAX package's.

Read plans (refs, kind, inverse flag, phases) must be float-equal for every
op x chip x encoding.  The Vth samplers draw from different generators, so
they are compared in distribution: every sample inside its verify window,
and per-state mean and standard deviation within a stated tolerance.
"""
import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core import encoding as jenc
from repro.core import mcflash as jmc
from repro.core import tlc as jtlc
from repro.core import vth_model as jvm
from repro_torch.core import encoding as tenc
from repro_torch.core import mcflash as tmc
from repro_torch.core import sensing as tsense
from repro_torch.core import tlc as ttlc
from repro_torch.core import vth_model as tvm

torch.set_num_threads(1)

N_CELLS = 1 << 18            # per-state samples ~65k: moments to ~1e-3 V
#: tolerance on per-state mean and std (V).  Two independent 65k-sample
#: estimates of a sigma <= 2.6 V half-normal differ by < 0.01 V at 5 sigma;
#: the clipped programmed states are ~20x tighter.
MOMENT_TOL = 0.02


def _plan_tuple(p):
    return (p.op, p.kind, tuple(p.refs), p.sensing_phases, p.uses_inverse)


def test_read_plans_equal_reference():
    """Table-1 plans for every chip x op x inverse-read choice, and encoded
    plans for every op x role combination under TLC and reduced-MLC."""
    for chip, use_inverse in itertools.product(sorted(jvm.CHIP_MODELS),
                                               (True, False)):
        jchip, tchip = jvm.CHIP_MODELS[chip], tvm.CHIP_MODELS[chip]
        assert dataclasses.astuple(jchip) == dataclasses.astuple(tchip)
        for op in jenc.ALL_OPS:
            assert (_plan_tuple(tmc.plan_op(op, tchip, use_inverse))
                    == _plan_tuple(jmc.plan_op(op, jchip, use_inverse))), \
                (chip, op, use_inverse)
    for enc in (ttlc.TLC, ttlc.REDUCED_MLC):
        _assert_encoded_plans_equal(enc)


def _encoded_cases(enc):
    roles = ttlc.ROLES_OF[enc]
    yield "read", (roles[0],)
    for r in roles:
        yield "read", (r,)
        yield "not", (r,)
    for k in (2, 3):
        for combo in itertools.combinations_with_replacement(roles, k):
            for op in ("and", "or", "xor", "nand", "nor", "xnor"):
                yield op, combo


def _assert_encoded_plans_equal(enc):
    jchip, tchip = jtlc.TLCChipModel(), ttlc.TLCChipModel()
    assert ttlc.valleys(tchip, enc) == jtlc.valleys(jchip, enc)
    assert ttlc.ROLE_BITS[enc] == jtlc.ROLE_BITS[enc]
    n = 0
    for op, roles in _encoded_cases(enc):
        assert ttlc.op_pattern(op, roles, enc) == jtlc.op_pattern(op, roles, enc)
        assert (_plan_tuple(ttlc.plan_encoded(op, roles, tchip, enc))
                == _plan_tuple(jtlc.plan_encoded(op, roles, jchip, enc)))
        n += 1
    assert n > 20


def test_encodings_and_sensing_equal_reference():
    bits = np.array(list(itertools.product([0, 1], repeat=3)), np.uint8).T
    a, b, c = (torch.from_numpy(x.copy()) for x in bits)
    ja, jb, jc = (jnp.asarray(x) for x in bits)
    np.testing.assert_array_equal(tenc.encode_mlc(a, b).numpy(),
                                  np.asarray(jenc.encode_mlc(ja, jb)))
    np.testing.assert_array_equal(ttlc.encode_tlc(a, b, c).numpy(),
                                  np.asarray(jtlc.encode_tlc(ja, jb, jc)))
    np.testing.assert_array_equal(ttlc.encode_reduced(a, b).numpy(),
                                  np.asarray(jtlc.encode_reduced(ja, jb)))
    states = torch.arange(4, dtype=torch.uint8)
    for op in jenc.ALL_OPS:
        np.testing.assert_array_equal(
            tenc.expected_read(op, states).numpy(),
            np.asarray(jenc.expected_read(op, jnp.arange(4))))
        np.testing.assert_array_equal(
            tenc.logical_op(op, a, b).numpy(),
            np.asarray(jenc.logical_op(op, ja, jb)))
    rng = np.random.default_rng(1)
    vth = rng.normal(2.0, 2.0, 4096).astype(np.float32)
    chip = tvm.get_chip_model()
    for op in jenc.ALL_OPS:
        for inv in (True, False):
            got = tmc.execute_plan(tmc.plan_op(op, chip, inv),
                                   torch.from_numpy(vth))
            want = jmc.execute_plan(jmc.plan_op(op, jvm.get_chip_model(), inv),
                                    jnp.asarray(vth))
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    tc = ttlc.TLCChipModel()
    for fn in ("and3_read", "or3_read", "reduced_and_read", "reduced_or_read"):
        np.testing.assert_array_equal(
            getattr(ttlc, fn)(torch.from_numpy(vth), tc).numpy(),
            np.asarray(getattr(jtlc, fn)(jnp.asarray(vth), jtlc.TLCChipModel())))
    refs = (0.3, 1.1, 2.9)
    np.testing.assert_array_equal(
        tsense.parity_read(torch.from_numpy(vth), refs).numpy(),
        np.asarray(jmc.sensing.parity_read(jnp.asarray(vth), refs)))


def _moments(vth: np.ndarray, states: np.ndarray, n_states: int):
    return [(float(vth[states == s].mean()), float(vth[states == s].std()))
            for s in range(n_states)]


def _assert_moments_close(got, want):
    for s, ((m1, s1), (m2, s2)) in enumerate(zip(got, want)):
        assert abs(m1 - m2) < MOMENT_TOL, (s, m1, m2)
        assert abs(s1 - s2) < MOMENT_TOL, (s, s1, s2)


def test_mlc_sampler_matches_reference_in_distribution():
    """Fresh and worn (3000 P/E, 100 h) MLC pages."""
    for n_pe, retention in ((0.0, 0.0), (3000.0, 100.0)):
        _check_mlc_sampler(n_pe, retention)


def _check_mlc_sampler(n_pe, retention):
    rng = np.random.default_rng(2)
    lsb = (rng.random(N_CELLS) < 0.5).astype(np.uint8)
    msb = (rng.random(N_CELLS) < 0.5).astype(np.uint8)
    chip = tvm.get_chip_model()
    gen = torch.Generator().manual_seed(0)
    vth, states = tvm.program_page(gen, torch.from_numpy(lsb),
                                   torch.from_numpy(msb), chip, n_pe, retention)
    jv, js = jvm.program_page(jax.random.PRNGKey(0), jnp.asarray(lsb),
                              jnp.asarray(msb), jvm.get_chip_model(), n_pe,
                              retention)
    states = states.numpy()
    np.testing.assert_array_equal(states, np.asarray(js))
    vth = vth.numpy()
    assert vth.dtype == np.float32
    _assert_moments_close(_moments(vth, states, 4),
                          _moments(np.asarray(jv), states, 4))
    if n_pe == 0:             # fresh pages sit inside their verify windows
        assert (vth[states == 0] <= chip.erase_hi).all()
        for s in (1, 2, 3):
            v = vth[states == s]
            assert chip.prog_lo[s - 1] <= v.min() and v.max() <= chip.prog_hi[s - 1]
    mu, sigma = tvm.drift_terms(chip, n_pe, retention)
    jmu, jsigma = jvm.drift_terms(jvm.get_chip_model(), n_pe, retention)
    np.testing.assert_allclose(mu.numpy(), np.asarray(jmu), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(sigma.numpy(), np.asarray(jsigma), rtol=1e-6,
                               atol=1e-7)


def test_tlc_sampler_matches_reference_in_distribution():
    """Fresh and worn (5000 P/E) 8-state pages; sampling draws from the
    generator it is given."""
    for n_pe in (0.0, 5000.0):
        _check_tlc_sampler(n_pe)
    chip = tvm.get_chip_model()
    states = torch.randint(0, 4, (4096,), generator=torch.Generator().manual_seed(9))
    a = tvm.sample_fresh_vth(torch.Generator().manual_seed(5), states, chip)
    b = tvm.sample_fresh_vth(torch.Generator().manual_seed(5), states, chip)
    c = tvm.sample_fresh_vth(torch.Generator().manual_seed(6), states, chip)
    assert torch.equal(a, b) and not torch.equal(a, c)


def _check_tlc_sampler(n_pe):
    rng = np.random.default_rng(3)
    states = rng.integers(0, 8, N_CELLS).astype(np.uint8)
    chip = ttlc.TLCChipModel()
    gen = torch.Generator().manual_seed(1)
    vth = ttlc.program_tlc(gen, torch.from_numpy(states), chip, n_pe).numpy()
    jv = np.asarray(jtlc.program_tlc(jax.random.PRNGKey(1), jnp.asarray(states),
                                     jtlc.TLCChipModel(), n_pe))
    _assert_moments_close(_moments(vth, states, 8), _moments(jv, states, 8))
    if n_pe == 0:
        assert (vth[states == 0] <= chip.erase_hi).all()
        for s in range(1, 8):
            v = vth[states == s]
            assert chip.prog_lo[s - 1] <= v.min() and v.max() <= chip.prog_hi[s - 1]
