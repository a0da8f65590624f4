"""The port's LM serving path against the JAX package's.

Reduced configs of the two families the port runs: a qwen3-style stack of
``attn`` blocks and a gemma3-style stack of ``swa`` (window 64, as in
``examples/serve_lm.py``'s ``tiny()``) and ``attn`` blocks with a tail,
at 2-3 layers.  Parameters come from the JAX package's
``init_tree(PRNGKey(seed))`` and are carried across with
``params_from_jax``; the same numpy inputs go through both packages.

Tolerances: the layer functions on float32 inputs agree within 1e-5
(absolute and relative; the two packages sum in other orders).  Prefill
and decode run in bfloat16 (``cast_params``), which rounds at other places
in the two frameworks: their logits agree within 2e-2 of the logits' scale
(the largest magnitude of the reference's logits), and so do the port's
own decode logits and a full prefill over the same prefix.
"""
import dataclasses
import runpy
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import attention as ref_attn
from repro.models import layers as ref_layers
from repro.models import lm as ref_lm
from repro.models.specs import init_tree as ref_init_tree
from repro.serve.lm_engine import Engine as RefEngine
from repro.serve.lm_engine import ServeConfig as RefServeConfig
from repro_torch import configs
from repro_torch.models import attention, layers, lm
from repro_torch.models.attention import _local_attention_scanned
from repro_torch.models.specs import params_from_jax
from repro_torch.serve import Engine, ServeConfig

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
F32_TOL = 1e-5
BF16_TOL = 2e-2          # of the logits' scale


def _small(pkg, arch: str):
    """The reduced config of ``arch`` in one package's own dataclasses."""
    cfg = pkg.get_config(arch)
    kw = dict(d_model=64, n_heads=4, n_kv_heads=min(cfg.n_kv_heads, 2),
              head_dim=16, d_ff=128, vocab=512)
    if arch == "gemma3-1b":
        swa = dataclasses.replace(cfg.pattern[0], window=64)
        kw.update(pattern=(swa, cfg.pattern[-1]), repeats=1, tail=(swa,))
    else:
        kw.update(repeats=2)
    return dataclasses.replace(cfg, **kw)


def _pair(arch: str, seed: int = 0):
    """(port cfg, JAX cfg, port params, JAX params), the same weights."""
    cfg, ref_cfg = _small(configs, arch), _small(ref_configs, arch)
    ref_params = ref_init_tree(jax.random.PRNGKey(seed),
                               ref_lm.build_specs(ref_cfg))
    params = params_from_jax(jax.tree.map(np.asarray, ref_params), "cpu",
                             specs=lm.build_specs(cfg))
    return cfg, ref_cfg, params, ref_params


def _close(got: torch.Tensor, want, tol: float = F32_TOL) -> None:
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def _logits_close(got: torch.Tensor, want) -> None:
    want = np.asarray(jnp.asarray(want, jnp.float32))
    err = np.abs(got.float().numpy() - want).max()
    assert err <= BF16_TOL * np.abs(want).max(), (err, np.abs(want).max())


def test_layers_and_attention_match_jax_on_f32():
    rng = np.random.default_rng(0)

    def r(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    x, w = r(2, 5, 32), r(32)
    _close(layers.rms_norm(torch.tensor(x), torch.tensor(w)),
           ref_layers.rms_norm(x, w))
    xr = r(2, 4, 7, 16)
    for pos in (np.arange(7), np.arange(7) + 90):
        _close(layers.rotary(torch.tensor(xr), torch.tensor(pos), 1e6),
               ref_layers.rotary(xr, jnp.asarray(pos), 1e6))
    p = {"w_gate": r(32, 48), "w_up": r(32, 48), "w_down": r(48, 32)}
    _close(layers.mlp_apply({k: torch.tensor(v) for k, v in p.items()},
                            torch.tensor(x)),
           ref_layers.mlp_apply(p, x), 1e-4)
    table, tok = r(50, 8), rng.integers(0, 50, (2, 5))
    _close(layers.embed_lookup(torch.tensor(table), torch.tensor(tok)),
           ref_layers.embed_lookup(table, tok))

    q, k, v = r(2, 4, 16, 8), r(2, 2, 16, 8), r(2, 2, 16, 8)
    tq, tk, tv = map(torch.tensor, (q, k, v))
    for causal in (True, False):
        _close(attention.flash_attention(tq, tk, tv, causal=causal, block=4),
               ref_attn.flash_attention(q, k, v, causal=causal, block=4))
    _close(attention.flash_attention(tq[:, :, 12:], tk, tv, block=8,
                                     q_offset=12),
           ref_attn.flash_attention(q[:, :, 12:], k, v, block=8, q_offset=12))
    _close(attention.local_attention(tq, tk, tv, window=4),
           ref_attn.local_attention(q, k, v, window=4))
    _close(_local_attention_scanned(tq, tk, tv, window=6, q_chunk=4),
           ref_attn._local_attention_scanned(q, k, v, window=6, q_chunk=4))
    q1 = r(2, 4, 1, 8)
    _close(attention.decode_attention(torch.tensor(q1), tk[:, :, :12],
                                      tv[:, :, :12], cur_index=7),
           ref_attn.decode_attention(q1, k[:, :, :12], v[:, :, :12],
                                     cur_index=jnp.asarray(7)))
    ring = np.array([12, 13, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11])
    _close(attention.decode_attention(torch.tensor(q1), tk[:, :, :12],
                                      tv[:, :, :12], cur_index=13,
                                      entry_positions=torch.tensor(ring)),
           ref_attn.decode_attention(q1, k[:, :, :12], v[:, :, :12],
                                     cur_index=jnp.asarray(13),
                                     entry_positions=jnp.asarray(ring)))
    # a ring not yet full: the port masks the unwritten (negative) slots,
    # as the JAX function masks slots past the current position
    part = np.array([0, 1, 2, 3, -8, -7, -6, -5, -4, -3, -2, -1])
    _close(attention.decode_attention(torch.tensor(q1), tk[:, :, :12],
                                      tv[:, :, :12], cur_index=3,
                                      entry_positions=torch.tensor(part)),
           ref_attn.decode_attention(q1, k[:, :, :12], v[:, :, :12],
                                     cur_index=jnp.asarray(3),
                                     entry_positions=jnp.asarray(
                                         np.where(part < 0, 99, part))))
    # training's head: the chunked cross-entropy at a chunk below S
    xs, head = r(2, 8, 16), r(40, 16)
    labels = rng.integers(0, 40, (2, 8))
    mask = (labels > 0).astype(np.float32)
    _close(layers.chunked_softmax_xent(torch.tensor(xs), torch.tensor(head),
                                       torch.tensor(labels),
                                       torch.tensor(mask), chunk=4),
           ref_layers.chunked_softmax_xent(xs, head, labels, mask, chunk=4))


@pytest.mark.parametrize("arch,prompt,max_seq", [("qwen3-1.7b", 16, 32),
                                                 ("gemma3-1b", 64, 96)])
def test_prefill_and_decode_logits_match_jax(arch, prompt, max_seq):
    """Prefill logits and 8 decode steps' logits; the gemma3-style prompt
    fills the 64-token window, so its decode steps wrap the ring."""
    cfg, ref_cfg, params, ref_params = _pair(arch)
    tokens = np.random.default_rng(1).integers(1, cfg.vocab, (2, prompt))
    ref_caches = ref_lm.init_cache(ref_cfg, 2, max_seq)
    ref_logits, ref_caches = jax.jit(
        lambda p, b, c: ref_lm.prefill(p, ref_cfg, b, c))(
            ref_params, {"tokens": jnp.asarray(tokens)}, ref_caches)
    caches = lm.init_cache(cfg, 2, max_seq, "cpu")
    logits, caches = lm.prefill(params, cfg, {"tokens": torch.tensor(tokens)},
                                caches)
    _logits_close(logits, ref_logits)
    assert caches["pattern"]["b0"]["k"].shape[0] == cfg.repeats
    ref_decode = jax.jit(lambda p, t, c, i: ref_lm.decode_step(p, ref_cfg, t,
                                                               c, i))
    step = np.random.default_rng(2).integers(1, cfg.vocab, (8, 2, 1))
    for i in range(8):
        ref_logits, ref_caches = ref_decode(
            ref_params, jnp.asarray(step[i]), ref_caches,
            jnp.asarray(prompt + i, jnp.int32))
        logits, caches = lm.decode_step(params, cfg, torch.tensor(step[i]),
                                        caches, prompt + i)
        _logits_close(logits, ref_logits)


def _ref_step_logits(ref_eng, ref_out, s0: int, new: int):
    """The JAX model's logits before each new token, teacher-forced on the
    JAX engine's tokens (through the engine's own jitted steps)."""
    caches = ref_lm.init_cache(ref_eng.cfg, ref_out.shape[0],
                               ref_eng.scfg.max_seq)
    logits, caches = ref_eng._prefill(
        ref_eng.params, {"tokens": jnp.asarray(ref_out[:, :s0])}, caches)
    steps = [logits]
    for i in range(new - 1):
        logits, caches = ref_eng._decode(
            ref_eng.params, jnp.asarray(ref_out[:, s0 + i:s0 + i + 1]),
            caches, jnp.asarray(s0 + i, jnp.int32))
        steps.append(logits)
    return [np.asarray(jnp.asarray(x, jnp.float32)) for x in steps]


def _decode_vs_prefill_err(prefill, decode_step, init_cache, params, cfg,
                           toks, s0: int, steps: int, max_seq: int):
    """Largest relative gap between a decode step's logits and a full
    prefill's over the same prefix, for one package's functions."""
    _, caches = prefill(params, cfg, {"tokens": toks[:, :s0]},
                        init_cache(max_seq))
    worst = 0.0
    for i in range(steps):
        logits, caches = decode_step(params, cfg, toks[:, s0 + i:s0 + i + 1],
                                     caches, s0 + i)
        full, _ = prefill(params, cfg, {"tokens": toks[:, :s0 + i + 1]},
                          init_cache(max_seq))
        got, want = (np.asarray(x, np.float32) if not torch.is_tensor(x)
                     else x.float().numpy() for x in (logits, full))
        worst = max(worst, np.abs(got - want).max() / np.abs(want).max())
    return worst


def test_generate_tokens_decode_calls_and_prefill_consistency(monkeypatch,
                                                              capsys):
    """Greedy tokens equal the JAX engine's at every step up to the first
    whose top-2 logit gap is within the tolerance; ``decode_calls`` counts
    ``max_new_tokens - 1``; each decode step's logits equal a full prefill
    over the same prefix, also while a sliding-window ring is not yet full,
    where the JAX package's decode does not (ROADMAP R5); the example
    driver runs on the CPU."""
    new = 8
    # the gemma3-style prompt fills its ring: there both packages agree
    for arch, s0, max_seq in (("qwen3-1.7b", 32, 64), ("gemma3-1b", 64, 96)):
        cfg, ref_cfg, params, ref_params = _pair(arch, seed=3)
        prompts = np.random.default_rng(4).integers(1, cfg.vocab, (2, s0))
        ref_eng = RefEngine(ref_cfg, ref_params,
                            RefServeConfig(max_seq=max_seq))
        ref_out = np.asarray(ref_eng.generate(jnp.asarray(prompts, jnp.int32),
                                              new))
        eng = Engine(cfg, params, ServeConfig(max_seq=max_seq))
        out = eng.generate(prompts, new)
        assert eng.decode_calls == new - 1
        assert eng.generate(prompts, new).equal(out)
        assert eng.decode_calls == 2 * (new - 1)
        assert np.array_equal(out[:, :s0].numpy(), prompts)
        step_logits = _ref_step_logits(ref_eng, ref_out, s0, new)
        compared = 0
        for row in range(2):          # each row until its first close call
            for i, logits in enumerate(step_logits):
                top = np.sort(logits[row, -1])
                if top[-1] - top[-2] <= BF16_TOL * np.abs(logits).max():
                    break
                assert out[row, s0 + i] == ref_out[row, s0 + i], (arch, i)
                compared += 1
        assert compared >= 2, arch

    cfg, ref_cfg, params, ref_params = _pair("gemma3-1b", seed=3)
    toks = np.random.default_rng(5).integers(1, cfg.vocab, (2, 40))
    port_err = _decode_vs_prefill_err(
        lm.prefill, lm.decode_step,
        lambda n: lm.init_cache(cfg, 2, n, "cpu"), lm.cast_params(params),
        cfg, torch.tensor(toks), 32, new, 64)
    assert port_err <= BF16_TOL
    ref_eng = RefEngine(ref_cfg, ref_params)
    ref_err = _decode_vs_prefill_err(
        lambda p, c, b, ca: ref_eng._prefill(p, b, ca),
        lambda p, c, t, ca, i: ref_eng._decode(p, t, ca,
                                               jnp.asarray(i, jnp.int32)),
        lambda n: ref_lm.init_cache(ref_cfg, 2, n), ref_params, ref_cfg,
        jnp.asarray(toks), 32, 1, 64)
    assert ref_err > BF16_TOL          # the reference's R5

    monkeypatch.setattr(sys, "argv", ["torch_serve_lm", "--device", "cpu",
                                      "--batch", "2", "--new-tokens", "4"])
    runpy.run_path(str(ROOT / "examples" / "torch_serve_lm.py"),
                   run_name="__main__")
    assert "generated 2x4 tokens" in capsys.readouterr().out
