"""The placed runner, the XOR delta and the LM engine on the card (``gpu``
marker).

Without a card these tests skip.  On one they run with
``python -m pytest -m gpu tests/test_torch_cuda_lm.py``; this file imports
neither JAX nor the JAX package.  ``python3 chip_smoke.py`` runs the same
checks at full size (its placed and LM phases).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.api.session import ComputeSession
from repro_torch.checkpoint import delta_apply, delta_encode
from repro_torch.configs import get_config
from repro_torch.flash.device import FlashDevice
from repro_torch.flash.geometry import SSDConfig
from repro_torch.kernels import cuda
from repro_torch.models import lm
from repro_torch.models.specs import flatten
from repro_torch.serve import Engine, ServeConfig


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run python3 chip_smoke.py on one)")
    return torch.device("cuda")


def _dag(sess, rng, n_pairs: int, n_bits: int):
    """Mixed-op pairs over four dies under an OR fold, and its oracle."""
    expr = ref = None
    for i in range(n_pairs):
        a = rng.integers(0, 2, n_bits, dtype=np.uint8)
        b = rng.integers(0, 2, n_bits, dtype=np.uint8)
        va, vb = sess.write_pair(f"a{i}", a, f"b{i}", b, die=i % 4)
        op = ("and", "xor", "or")[i % 3]
        expr = (va._binary(op, vb) if expr is None
                else expr | va._binary(op, vb))
        pr = {"and": a & b, "xor": a ^ b, "or": a | b}[op]
        ref = pr if ref is None else ref | pr
    return expr, ref


@pytest.mark.gpu
def test_placed_runner_matches_unplaced_on_four_streams(card):
    """``shard_devices=["cuda"] * 4``: four streams on one card; the placed
    runner's words and counts equal the unplaced runner's and numpy's."""
    for encoding in ("mlc", "tlc", "reduced-mlc"):
        outs = []
        for shards in (["cuda"] * 4, None):
            flash = FlashDevice(config=SSDConfig(page_kb=1), device=card,
                                shard_devices=shards)
            sess = ComputeSession(flash=flash, encoding=encoding)
            expr, ref = _dag(sess, np.random.default_rng(1), 8, 40000)
            words = sess.materialize(expr)
            bits = sess.materialize(expr, unpacked=True).cpu().numpy()
            np.testing.assert_array_equal(bits, ref)
            assert sess.popcount(expr) == int(ref.sum())
            assert (sess.placed_unit_dispatches > 0) == (shards is not None)
            # a die-local fused chain: its popcount stays on die 3's stream
            chain = sess.chain("and", [sess.vector(f"{p}{i}")
                                       for i in (3, 7) for p in "ab"])
            want = np.ones(40000, bool)
            for i in (3, 7):
                for p in "ab":
                    want &= sess.materialize(sess.vector(f"{p}{i}"),
                                             unpacked=True).cpu().numpy() > 0
            assert sess.popcount(chain) == int(want.sum())
            outs.append(words.cpu())
        assert torch.equal(outs[0], outs[1])
    arena = FlashDevice(device=card, shard_devices=["cuda"] * 4).arena
    assert len({arena.stream(s).cuda_stream for s in range(4)}) == 4


@pytest.mark.gpu
def test_delta_bitwise_reduce_matches_plain_version(card):
    """The delta's XOR launches ``bitwise_reduce`` on the card; its words
    equal the plain version's (the same tree on the CPU) and the round trip
    is bit-exact, with every leaf left on the card."""
    g = torch.Generator().manual_seed(0)
    base = {"w": torch.randn(300, 517, generator=g),
            "b": {"x": torch.randn(7, generator=g).half()}}
    new = {"w": base["w"].clone(), "b": {"x": base["b"]["x"].clone()}}
    new["w"][5] += 1.0
    on_card = lambda t: {"w": t["w"].to(card),                 # noqa: E731
                         "b": {"x": t["b"]["x"].to(card)}}
    before = cuda.launches["bitwise_reduce"]
    delta = delta_encode(on_card(base), on_card(new))
    assert cuda.launches["bitwise_reduce"] == before + 2
    plain = delta_encode(base, new)
    for (path, got), (_, want) in zip(flatten(delta), flatten(plain)):
        assert got.device.type == "cuda", path
        assert torch.equal(got.cpu(), want), path
    back = delta_apply(on_card(base), delta)
    for (path, got), (_, want) in zip(flatten(back), flatten(new)):
        assert got.device.type == "cuda" and got.dtype == want.dtype
        assert torch.equal(got.cpu().view(torch.uint8).reshape(-1),
                           want.view(torch.uint8).reshape(-1)), path


@pytest.mark.gpu
def test_lm_engine_deterministic_and_decode_matches_prefill(card):
    """A reduced gemma3-style engine on the card: two greedy calls agree,
    ``decode_calls`` counts ``max_new_tokens - 1``, and each decode step's
    logits equal a full prefill's within 2e-2 of the logits' scale."""
    cfg = get_config("gemma3-1b")
    swa = dataclasses.replace(cfg.pattern[0], window=64)
    cfg = dataclasses.replace(cfg, d_model=256, n_heads=4, n_kv_heads=1,
                              head_dim=64, d_ff=512, vocab=4096,
                              pattern=(swa, cfg.pattern[-1]), repeats=2,
                              tail=(swa,))
    eng = Engine.from_seed(cfg, seed=0, device=card,
                           serve_cfg=ServeConfig(max_seq=64))
    gen = torch.Generator(device=card).manual_seed(1)
    prompts = torch.randint(1, cfg.vocab, (2, 32), generator=gen, device=card)
    out = eng.generate(prompts, 8)
    assert torch.equal(eng.generate(prompts, 8), out)
    assert eng.decode_calls == 14
    assert torch.equal(out[:, :32], prompts)
    compute = lm.cast_params(eng.params)
    caches = lm.init_cache(cfg, 2, 64, card)
    _, caches = lm.prefill(compute, cfg, {"tokens": out[:, :32]}, caches)
    for i in range(7):
        logits, caches = lm.decode_step(compute, cfg, out[:, 32 + i:33 + i],
                                        caches, 32 + i)
        full, _ = lm.prefill(compute, cfg, {"tokens": out[:, :33 + i]},
                             lm.init_cache(cfg, 2, 64, card))
        err = (logits.float() - full.float()).abs().max()
        assert err <= 2e-2 * full.float().abs().max()
