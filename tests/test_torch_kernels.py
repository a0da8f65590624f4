"""The port's kernels against the JAX package's.

On the CPU every kernel wrapper runs its plain PyTorch version, so this
file holds the plain versions word for word against ``repro.kernels.ref``
(every kind x n_refs x op x invert x sense_invert, row counts that are not
multiples of 8, words with bit 31 set), and once per kernel against the
Pallas kernel in interpret mode at one (8, 4096) tile.  The CUDA kernels
themselves are held against the plain versions on the card, in
``tests/test_torch_cuda.py`` and, at full size, by ``python3 chip_smoke.py``.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import bitops as jbitops
from repro.kernels import fused as jfused
from repro.kernels import popcount as jpop
from repro.kernels import ref as jref
from repro_torch.kernels import bitops, cuda, fused, mlc_sense, popcount
from repro_torch.kernels import ref as tref

torch.set_num_threads(1)
# the package namespace re-exports the function under the submodule's name
jmlc = importlib.import_module("repro.kernels.mlc_sense")

KIND_CASES = ([("lsb", 1), ("msb", 2), ("sbr", 4)]
              + [("parity", n) for n in range(1, 9)])
OPS = ("and", "or", "xor")


def _refs(kind: str, n_refs: int, rng) -> list:
    if kind == "parity":
        return sorted(float(r) for r in rng.uniform(-1.0, 5.0, n_refs))
    return [0.1, 3.7, 1.9, 5.5][:n_refs]


def _jrefs(refs: list) -> jnp.ndarray:
    return jnp.asarray(refs + [0.0] * (8 - len(refs)), jnp.float32)


def _vth(rng, shape) -> np.ndarray:
    return rng.normal(2.0, 2.0, shape).astype(np.float32)


def _words(rng, shape) -> np.ndarray:
    """uint32 words over the full range; bit 31 set in about half."""
    w = rng.integers(0, 2 ** 32, shape, dtype=np.uint64).astype(np.uint32)
    w.reshape(-1)[:3] = (0xFFFFFFFF, 0x80000000, 0x80000001)
    return w


def _t(words: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(words.view(np.int32).copy())


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def test_plain_versions_match_reference(rng):
    """Every kind x n_refs x op x invert x sense_invert, rows 5 and 8 (one
    not a multiple of the TPU's 8-row tile), words with bit 31 set."""
    bits = (rng.random((5, 8192)) < 0.5).astype(np.uint8)
    bits[:, 31 * 128] = 1                     # bit 31 of word 0 in every row
    packed = tref.pack_bits(torch.from_numpy(bits))
    assert packed.dtype == torch.int32
    want = np.asarray(jref.pack_bits(jnp.asarray(bits)))
    np.testing.assert_array_equal(_u32(packed), want)
    assert (want[:, 0] >> 31 == 1).all()
    np.testing.assert_array_equal(tref.unpack_bits(packed).numpy(), bits)

    for kind, n_refs in KIND_CASES:
        refs = _refs(kind, n_refs, rng)
        case = f"{kind}/{n_refs}"
        for rows in (5, 8):
            vth = _vth(rng, (rows, 8192))
            for invert in (False, True):
                got = mlc_sense.mlc_sense(torch.from_numpy(vth), refs, kind=kind,
                                          invert=invert, n_refs=n_refs)
                want = jref.mlc_sense(jnp.asarray(vth), _jrefs(refs), kind,
                                      invert, n_refs)
                np.testing.assert_array_equal(_u32(got), np.asarray(want),
                                              err_msg=f"{case} {rows} {invert}")
        vth = _vth(rng, (3, 5, 4096))
        mask = _words(rng, (5, 128))
        for op in OPS:
            for sense_invert in (False, True):
                for invert in (False, True):
                    msg = f"{case} {op} {sense_invert} {invert}"
                    got = fused.sense_reduce(
                        torch.from_numpy(vth), refs, kind=kind,
                        sense_invert=sense_invert, op=op, invert=invert,
                        n_refs=n_refs)
                    want = jref.sense_reduce(jnp.asarray(vth), _jrefs(refs),
                                             kind, sense_invert, op, invert,
                                             n_refs)
                    np.testing.assert_array_equal(_u32(got), np.asarray(want),
                                                  err_msg=msg)
                    counts = fused.sense_reduce_popcount(
                        torch.from_numpy(vth), refs, _t(mask), kind=kind,
                        sense_invert=sense_invert, op=op, invert=invert,
                        n_refs=n_refs)
                    want = jref.sense_reduce_popcount(
                        jnp.asarray(vth), _jrefs(refs), jnp.asarray(mask), kind,
                        sense_invert, op, invert, n_refs)
                    assert counts.dtype == torch.int32
                    np.testing.assert_array_equal(counts.numpy(),
                                                  np.asarray(want), err_msg=msg)

    for n in (1, 2, 3, 8):
        stack = _words(rng, (n, 5, 130))
        for op in OPS:
            for invert in (False, True):
                got = bitops.bitwise_reduce(_t(stack), op=op, invert=invert)
                want = jref.bitwise_reduce(jnp.asarray(stack), op, invert)
                np.testing.assert_array_equal(_u32(got), np.asarray(want),
                                              err_msg=f"{n} {op} {invert}")

    for shape in ((1, 128), (5, 130), (8, 4096)):
        words = _words(rng, shape)
        got = popcount.popcount_rows(_t(words))
        assert got.dtype == torch.int32
        want = np.asarray(jref.popcount_rows(jnp.asarray(words)))
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            got.numpy(), np.unpackbits(words.view(np.uint8), axis=1).sum(1))
    # each SWAR step on words with the top bits set
    words = np.array([[0xFFFFFFFF, 0x80000000, 0xC0000001, 0x7FFFFFFF,
                       0xAAAAAAAA, 0x55555555, 0xF0F0F0F0, 0]], np.uint32)
    assert tref.popcount_words(_t(words)).tolist() == [[32, 1, 3, 31, 16, 16,
                                                        16, 0]]


# -- one case per kernel against the Pallas kernel (interpret mode) ------------

def test_kernels_match_pallas_interpret(rng):
    """One case per kernel against the Pallas kernel at one (8, 4096) tile."""
    vth = _vth(rng, (8, 4096))
    refs = _refs("parity", 7, rng)
    got = mlc_sense.mlc_sense(torch.from_numpy(vth), refs, kind="parity", n_refs=7)
    want = jmlc.mlc_sense(jnp.asarray(vth), jnp.asarray(refs, jnp.float32),
                          kind="parity", n_refs=7, interpret=True)
    np.testing.assert_array_equal(_u32(got), np.asarray(want))

    vth = _vth(rng, (3, 8, 4096))
    refs = _refs("sbr", 4, rng)
    got = fused.sense_reduce(torch.from_numpy(vth), refs, kind="sbr",
                             sense_invert=True, op="xor", invert=True)
    want = jfused.sense_reduce(jnp.asarray(vth), jnp.asarray(refs, jnp.float32),
                               kind="sbr", sense_invert=True, op="xor",
                               invert=True, interpret=True)
    np.testing.assert_array_equal(_u32(got), np.asarray(want))

    mask = _words(rng, (8, 128))
    refs = _refs("msb", 2, rng)
    got = fused.sense_reduce_popcount(torch.from_numpy(vth), refs, _t(mask),
                                      kind="msb", sense_invert=False, op="or")
    want = jfused.sense_reduce_popcount(
        jnp.asarray(vth), jnp.asarray(refs, jnp.float32), jnp.asarray(mask),
        kind="msb", sense_invert=False, op="or", interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    stack = _words(rng, (3, 8, 512))
    got = bitops.bitwise_reduce(_t(stack), op="and", invert=True)
    want = jbitops.bitwise_reduce(jnp.asarray(stack), op="and", invert=True,
                                  interpret=True)
    np.testing.assert_array_equal(_u32(got), np.asarray(want))

    words = _words(rng, (8, 512))
    got = popcount.popcount_rows(_t(words))
    want = jpop.popcount_rows(jnp.asarray(words), interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- the wrappers' dispatch ------------------------------------------------------

def test_wrappers_run_plain_versions_on_cpu_and_validate(rng):
    """CPU tensors take the plain versions and launch nothing; bad shapes
    raise before any launch."""
    before = dict(cuda.launches)
    vth = torch.from_numpy(_vth(rng, (2, 3, 4096)))
    words = _t(_words(rng, (2, 3, 128)))
    mlc_sense.mlc_sense(vth[0], [1.9], kind="lsb")
    fused.sense_reduce(vth, [1.9], kind="lsb", sense_invert=False, op="and")
    fused.sense_reduce_popcount(vth, [1.9], words[0], kind="lsb",
                                sense_invert=False, op="and")
    bitops.bitwise_reduce(words, op="or")
    popcount.popcount_rows(words[0])
    assert cuda.launches == before
    with pytest.raises(ValueError, match="multiple of 4096"):
        mlc_sense.mlc_sense(torch.zeros(2, 100), [1.0], kind="lsb")
    with pytest.raises(ValueError, match="at least one operand"):
        bitops.bitwise_reduce(torch.zeros(0, 2, 128, dtype=torch.int32),
                              op="and")
    with pytest.raises(ValueError, match="mask shape"):
        fused.sense_reduce_popcount(torch.zeros(1, 2, 4096),
                                    [1.0], torch.zeros(2, 64, dtype=torch.int32),
                                    kind="lsb", sense_invert=False, op="and")
    with pytest.raises(ValueError, match="parity read needs"):
        cuda.sense_args([1.0, 2.0], "parity", 3)
