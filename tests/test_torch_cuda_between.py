"""``ComputeSession.between`` on the card (``gpu`` marker).

Without a card this test skips.  On one it runs with
``python -m pytest -m gpu tests/test_torch_cuda_between.py``; this file
imports neither JAX nor the JAX package.  A 32-bit column of 2**20 uniform
codes is stored as 16 MLC pairs on 16 dies of the section-6 SSD; every
predicate's count through the CUDA kernels equals the plain reference's,
and none makes an ``ftl`` span.
"""
import pytest
import torch

from repro_torch.api import range_ref
from repro_torch.api.session import ComputeSession

ROWS = 2 ** 20
WIDTH = 32


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run python3 chip_smoke.py on one)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_between_on_the_card_matches_range_ref(card, monkeypatch):
    monkeypatch.delenv("REPRO_VERIFY", raising=False)
    monkeypatch.delenv("REPRO_FAULTS", raising=False)
    gen = torch.Generator(device=card).manual_seed(34)
    bits = [torch.randint(0, 2, (ROWS,), generator=gen, device=card,
                          dtype=torch.uint8) for _ in range(WIDTH)]
    sess = ComputeSession(device=card, trace=True)
    assert sess.stats()["backend"] == "cuda"
    names = [f"v{WIDTH - 1 - i}" for i in range(WIDTH)]
    for j in range(0, WIDTH, 2):
        sess.write_pair(names[j], bits[j], names[j + 1], bits[j + 1],
                        die=j // 2)
    v = range_ref.codes(bits)
    top, w = 2 ** WIDTH - 1, int(0.1 * 2 ** WIDTH)
    cases = [(0, top), (5, 4), (0, 2 ** 31 - 1), (2 ** 31, top), (7, 7)]
    cases += [(lo, lo + w - 1) for lo in torch.randint(
        0, 2 ** WIDTH - w, (12,), generator=torch.Generator().manual_seed(2013),
        dtype=torch.int64).tolist()]
    for lo, hi in cases:
        assert sess.between(names, lo, hi).popcount() == \
            range_ref.count(v, lo, hi), (lo, hi)
    assert not [s for s in sess.trace.wall_spans if s.category == "ftl"]
    torch.cuda.synchronize()
