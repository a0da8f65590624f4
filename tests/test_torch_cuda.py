"""The CUDA kernels and the card's main path (``gpu`` marker).

Without a card these tests skip.  On one they run with
``python -m pytest -m gpu tests/test_torch_cuda.py``; this file imports
neither JAX nor the JAX package, so it runs where only the port is
installed.  ``python3 chip_smoke.py`` runs the same checks at full size.
"""
import itertools

import numpy as np
import pytest
import torch

from repro_torch.api.session import ComputeSession
from repro_torch.flash.geometry import SSDConfig
from repro_torch.kernels import bitops, cuda, fused, mlc_sense, popcount

KIND_CASES = ([("lsb", [1.9]), ("msb", [0.1, 3.7]), ("sbr", [0.1, 3.7, 1.9, 5.5])]
              + [("parity", [-1.0 + 0.7 * i for i in range(n)]) for n in range(1, 9)])


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run python3 chip_smoke.py on one)")
    return torch.device("cuda")


def _words(gen, shape, device):
    return torch.randint(-2 ** 31, 2 ** 31, shape, generator=gen,
                         dtype=torch.int64).to(torch.int32).to(device)


@pytest.mark.gpu
def test_cuda_kernels_match_plain_versions(card):
    """Every kind x op x inversion, rows not a multiple of 8, bit-31 words:
    the kernels equal their plain versions bit for bit."""
    gen = torch.Generator().manual_seed(0)
    vth = (torch.randn(3, 5, 8192, generator=gen) * 2 + 2).to(card)
    mask = _words(gen, (5, 256), card)
    words = _words(gen, (3, 5, 130), card)
    for (kind, refs), invert in itertools.product(KIND_CASES, (False, True)):
        n_refs = len(refs)
        assert torch.equal(
            mlc_sense.mlc_sense(vth[0], refs, kind=kind, invert=invert,
                                n_refs=n_refs),
            mlc_sense.reference(vth[0], refs, kind, invert, n_refs))
        for op in ("and", "or", "xor"):
            args = dict(kind=kind, sense_invert=not invert, op=op,
                        invert=invert, n_refs=n_refs)
            assert torch.equal(fused.sense_reduce(vth, refs, **args),
                               fused.reference(vth, refs, kind, not invert, op,
                                               invert, n_refs))
            assert torch.equal(
                fused.sense_reduce_popcount(vth, refs, mask, **args),
                fused.reference_popcount(vth, refs, mask, kind, not invert, op,
                                         invert, n_refs))
            assert torch.equal(bitops.bitwise_reduce(words, op=op, invert=invert),
                               bitops.reference(words, op, invert))
    assert torch.equal(popcount.popcount_rows(words[0]),
                       popcount.reference(words[0]))
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_session_on_the_card_launches_every_kernel(card):
    """A small session on the card equals the numpy oracle and goes through
    all five kernels."""
    rng = np.random.default_rng(0)
    n = 3 * 8192 + 17
    raw = [(rng.random(n) < 0.6).astype(np.uint8) for _ in range(6)]
    sess = ComputeSession(config=SSDConfig(channels=1, dies_per_channel=4,
                                           page_kb=1))
    assert sess.backend.name == "cuda" and sess.torch_device.type == "cuda"
    v = []
    for i in range(0, 6, 2):
        v.extend(sess.write_pair(f"v{i}", raw[i], f"v{i + 1}", raw[i + 1]))
    b = [r.astype(bool) for r in raw]
    cuda.reset_launches()
    chain = sess.chain("and", v)
    want = np.logical_and.reduce(b)
    got = sess.materialize(chain, unpacked=True).cpu().numpy().astype(bool)
    np.testing.assert_array_equal(got, want)
    assert sess.popcount(chain) == int(want.sum())
    mixed = (v[0] & v[1]) | (v[2] ^ v[3])
    got = sess.materialize(mixed, unpacked=True).cpu().numpy().astype(bool)
    np.testing.assert_array_equal(got, (b[0] & b[1]) | (b[2] ^ b[3]))
    assert sess.popcount(v[4] & v[5]) == int((b[4] & b[5]).sum())
    assert all(count > 0 for count in cuda.launches.values()), cuda.launches
