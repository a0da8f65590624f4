"""The placed runner, the XOR delta, the LM engine and the RG-LRU / SSD /
MoE / encoder-decoder / embeddings stacks on the card (``gpu`` marker).

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
from repro_torch.models.specs import flatten, init_tree, tree_map
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
def test_placed_runner_matches_unplaced_on_four_streams(card, monkeypatch):
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
    # a partial handed to the compute stream ("cuda", its tensor on
    # "cuda:0"): that one stream waits once for the side stream's event
    waits = []
    real_wait = torch.cuda.Stream.wait_event
    monkeypatch.setattr(torch.cuda.Stream, "wait_event",
                        lambda s, ev: waits.append(s) or real_wait(s, ev))
    with arena.on_slot(1):
        part = torch.ones(8, device=card)
    arena.to_compute(part, arena.ready(1))
    assert len(waits) == 1


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


def _reduced(arch: str):
    """The reduced config of ``arch`` (the cuts of
    ``tests/test_arch_smoke.py``, windows cut to 32)."""
    cfg = get_config(arch)
    kw = dict(d_model=64, vocab=512, repeats=2,
              rnn_width=64 if cfg.rnn_width else 0,
              ssm_state=32 if cfg.ssm_state else 0,
              ssm_head_dim=16 if cfg.ssm_state else 64,
              n_experts=4 if cfg.n_experts else 0,
              top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
              enc_layers=2 if cfg.enc_layers else 0,
              dec_seq=32 if cfg.encdec else 448)
    if cfg.n_heads:
        kw.update(n_heads=min(cfg.n_heads, 4), head_dim=16, d_ff=128,
                  n_kv_heads=1 if cfg.n_kv_heads == 1 else 2)
    win = lambda bs: tuple(  # noqa: E731
        dataclasses.replace(b, window=32 if b.window else 0) for b in bs)
    return dataclasses.replace(cfg, pattern=win(cfg.pattern),
                               tail=win(cfg.tail), **kw)


def _steps(params, cfg, device, inputs, tokens) -> list:
    """Float32 logits of a prefill and 4 decode steps (the encoder-decoder:
    an encode and 5 decode steps), through the model's own layer functions
    with float32 caches on ``device``."""
    params = tree_map(lambda t: t.to(device), params)
    seq = inputs.shape[1] if cfg.encdec else 96    # frames / max tokens
    caches = tree_map(lambda t: t.float(), lm.init_cache(cfg, 2, seq, device))
    inputs, tokens = inputs.to(device), tokens.to(device)
    out = []
    if cfg.encdec:
        lm._encdec_stage(params, cfg, inputs, caches)
        for i in range(tokens.shape[1]):
            logits, _ = lm._encdec_decode_step(params, cfg, tokens[:, i:i + 1],
                                               caches, i)
            out.append(logits)
        return out
    s = inputs.shape[1]
    x, _ = lm._run_stack(params, inputs, cfg, positions=torch.arange(
        s, device=device), caches=caches)
    out.append(lm._logits(params, cfg, x[:, -1:]))
    for i in range(tokens.shape[1]):
        x, _ = lm._run_stack(params, params["embed"][tokens[:, i:i + 1]],
                             cfg, positions=torch.tensor([s + i], device=device),
                             caches=caches, cur_index=s + i)
        out.append(lm._logits(params, cfg, x))
    return out


@pytest.mark.gpu
def test_new_stacks_on_card_match_cpu(card, monkeypatch):
    """The reduced mamba2, recurrentgemma, mixtral, internvl2 and whisper
    configs: in float32 (matmuls without TF32) the card's logits equal the
    CPU's within 1e-3 of their scale, prefill and every decode step; the
    served bfloat16 path on the card gives finite logits, and for mamba2
    (no attention: well-conditioned in bfloat16) they equal the CPU's
    within 2e-2."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    for arch in ("mamba2-130m", "recurrentgemma-9b", "mixtral-8x7b",
                 "internvl2-26b", "whisper-tiny"):
        cfg = _reduced(arch)
        params = init_tree(0, lm.build_specs(cfg), "cpu")
        g = torch.Generator().manual_seed(1)
        inputs = (torch.randint(1, cfg.vocab, (2, 64), generator=g)
                  if cfg.uses_tokens else torch.randn(2, 64, 64, generator=g))
        tokens = torch.randint(1, cfg.vocab, (2, 5 if cfg.encdec else 4),
                               generator=g)
        x = params["embed"][inputs] if cfg.uses_tokens else inputs
        for got, want in zip(_steps(params, cfg, card, x, tokens),
                             _steps(params, cfg, "cpu", x, tokens)):
            err = (got.cpu() - want).abs().max() / want.abs().max()
            assert err <= 1e-3, (arch, float(err))
        served = {}
        for dev in ("cpu", card):
            compute = lm.cast_params(tree_map(lambda t: t.to(dev), params))
            if cfg.encdec:
                caches = lm.encdec_prefill(compute, cfg,
                                           {"frames": inputs.to(dev)},
                                           lm.init_cache(cfg, 2, 64, dev))
                logits, _ = lm.decode_step(compute, cfg, tokens[:, :1].to(dev),
                                           caches, 0)
            else:
                key = "tokens" if cfg.uses_tokens else "embeds"
                logits, caches = lm.prefill(compute, cfg,
                                            {key: inputs.to(dev)},
                                            lm.init_cache(cfg, 2, 96, dev))
                logits, _ = lm.decode_step(compute, cfg, tokens[:, :1].to(dev),
                                           caches, 64)
            served[str(dev)] = logits.float().cpu()
        got, want = served[str(card)], served["cpu"]
        assert bool(torch.isfinite(got).all()), arch
        if arch == "mamba2-130m":
            assert (got - want).abs().max() <= 2e-2 * want.abs().max()
