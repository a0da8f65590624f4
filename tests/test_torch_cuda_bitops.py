"""``bitwise_reduce`` with operands by pointer and the masked
``popcount_rows`` on the card (``gpu`` marker).

Without a card these tests skip.  On one they run with
``python -m pytest -m gpu tests/test_torch_cuda_bitops.py``; this file
imports neither JAX nor the JAX package.  Each CUDA kernel is held bit for
bit against its plain version: the sequence form over separate
allocations (up to past the 64-pointer cap, where the fold runs in
passes), views offset by 4 bytes (the scalar path), plane lengths that are
not a multiple of 4, ``out=``, and the masked count at (3, 2**21) words.
"""
import pytest
import torch

from repro_torch.kernels import bitops, cuda, popcount

OPS = ("and", "or", "xor")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run python3 chip_smoke.py on one)")
    return torch.device("cuda")


def _words(gen, shape, device):
    return torch.randint(-2 ** 31, 2 ** 31, shape, generator=gen,
                         dtype=torch.int64).to(torch.int32).to(device)


@pytest.mark.gpu
def test_bitwise_reduce_by_pointer_matches_plain_version(card):
    """Separate operands, N = 1 .. 130 (one, two and three launches),
    aligned and 4-byte-offset views, planes of 4096 and 1001 words,
    ``out=``: equal to the plain version bit for bit."""
    gen = torch.Generator().manual_seed(1)
    for plane in (4096, 1001):
        for n in (1, 2, 3, 8, 32, 64, 65, 130):
            seq = [_words(gen, (plane,), card) for _ in range(n)]
            # the same words at an offset of 4 bytes: the scalar loop
            shifted = [torch.cat([_words(gen, (1,), card), t])[1:] for t in seq]
            assert all(t.data_ptr() % 16 == 4 for t in shifted)
            for op in OPS:
                for invert in (False, True):
                    want = bitops.reference(seq, op, invert)
                    before = cuda.launches["bitwise_reduce"]
                    assert torch.equal(bitops.bitwise_reduce(
                        seq, op=op, invert=invert), want), (plane, n, op)
                    passes = 1 + max(0, -(-(n - cuda.MAX_OPERANDS)
                                          // (cuda.MAX_OPERANDS - 1)))
                    assert cuda.launches["bitwise_reduce"] == before + passes
                    assert torch.equal(bitops.bitwise_reduce(
                        shifted, op=op, invert=invert), want), (plane, n, op)
                    out = torch.full((plane,), 7, dtype=torch.int32, device=card)
                    assert bitops.bitwise_reduce(seq, op=op, invert=invert,
                                                 out=out) is out
                    assert torch.equal(out, want), (plane, n, op)
            if n <= 8:
                stack = torch.stack(seq).reshape(n, 1, plane)
                assert torch.equal(bitops.bitwise_reduce(stack, op="xor"),
                                   bitops.reference(stack, "xor"))
    with pytest.raises(ValueError, match="out must be"):
        bitops.bitwise_reduce(seq[:2], op="or",
                              out=torch.empty(1001, dtype=torch.int64,
                                              device=card))
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_masked_popcount_matches_plain_version(card):
    """Masked and unmasked counts at (3, 2**21) words, one launch each, at
    rows of 1001 words (the scalar path) and on a 4-byte-offset view."""
    gen = torch.Generator().manual_seed(2)
    for shape in ((3, 2 ** 21), (5, 1001), (1, 1001), (1, 4096)):
        words, mask = _words(gen, shape, card), _words(gen, shape, card)
        words[0, :7] = -1                               # all-ones words
        mask[-1] = -1
        for m in (None, mask):
            before = cuda.launches["popcount_rows"]
            got = popcount.popcount_rows(words, m)
            assert cuda.launches["popcount_rows"] == before + 1
            assert torch.equal(got, popcount.reference(words, m)), shape
        r, w = shape
        flat = torch.cat([_words(gen, (1,), card), words.reshape(-1)])[1:]
        view = flat.reshape(r, w)
        assert view.data_ptr() % 16 == 4
        assert torch.equal(popcount.popcount_rows(view, mask),
                           popcount.reference(words, mask)), shape
    torch.cuda.synchronize()
