"""TLC triples on the port's normal path, against a plain-torch fold.

Four Y, U, V-like triples are written with ``ComputeSession.write_triple``
(one TLC wordline group each, on its own die).  Each op reads every triple
as ONE encoded sense (3 operands on one wordline) and folds chains of 1 to
4 triples (several senses, fused into one pass); the counts and the packed
words in the lane-major layout equal the same op folded over the seeded
bits in plain torch.
"""
import pytest
import torch

from repro_torch.api.session import ComputeSession
from repro_torch.flash.geometry import SSDConfig

torch.set_num_threads(1)

CFG = dict(channels=1, dies_per_channel=4, page_kb=1)
PAGE_BITS = 8192
N_BITS = 2 * PAGE_BITS + 4096 + 100       # three pages, a ragged tail
TRIPLES = 4
FOLD = {"and": torch.bitwise_and, "or": torch.bitwise_or,
        "xor": torch.bitwise_xor}


@pytest.fixture(autouse=True)
def _plain_env(monkeypatch):
    monkeypatch.delenv("REPRO_VERIFY", raising=False)
    monkeypatch.delenv("REPRO_FAULTS", raising=False)


def _fold(op, vecs):
    out = vecs[0].clone()
    for v in vecs[1:]:
        out = FOLD[op](out, v)
    return out


def _lane_major(bits):
    """(n,) {0, 1} bits, zero-padded to whole pages -> int32 words: word w
    of each 4096-bit tile holds bit k from column k * 128 + w."""
    pages = -(-bits.numel() // PAGE_BITS)
    padded = torch.zeros(pages * PAGE_BITS, dtype=torch.int64)
    padded[: bits.numel()] = bits.to(torch.int64)
    tiles = padded.reshape(-1, 32, 128)
    words = torch.zeros(tiles.shape[0], 128, dtype=torch.int64)
    for k in range(32):
        words |= tiles[:, k, :] << k
    words -= (words >= 2 ** 31).to(torch.int64) << 32
    return words.to(torch.int32).reshape(-1)


@pytest.mark.parametrize("op", ["and", "or", "xor"])
def test_tlc_triples_fold_like_plain_torch(op):
    gen = torch.Generator().manual_seed(2 ** 31 + 27)
    bits = (torch.rand((TRIPLES, 3, N_BITS), generator=gen) < 0.5).to(
        torch.uint8)
    sess = ComputeSession(device="cpu", config=SSDConfig(**CFG),
                          encoding="tlc", seed=27)
    names = [[f"t{t}{p}" for p in "yuv"] for t in range(TRIPLES)]
    for t in range(TRIPLES):
        sess.write_triple(*[x for n, b in zip(names[t], bits[t])
                            for x in (n, b)], die=t)
    # each triple alone: one encoded sense group, no controller combine
    for t in range(TRIPLES):
        expr = sess.chain(op, names[t])
        plan = sess.lower(expr)
        assert len(plan.groups) == 1 and not plan.steps
        assert plan.groups[0].plan.op.startswith(f"tlc:{op}:")
        want = _fold(op, list(bits[t]))
        assert sess.popcount(expr) == int(want.sum())
        assert torch.equal(sess.materialize(expr), _lane_major(want))
    # chains of 1..4 triples: one sense a triple, fused into one pass
    for k in range(1, TRIPLES + 1):
        expr = sess.chain(op, [n for t in range(k) for n in names[t]])
        want = _fold(op, [b for t in range(k) for b in bits[t]])
        assert sess.popcount(expr) == int(want.sum())
        assert torch.equal(sess.materialize(expr), _lane_major(want))
    assert sess.megakernel_calls > 0          # the chains took fused passes
