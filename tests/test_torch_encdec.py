"""The port's encoder-decoder (whisper-tiny) and embeddings frontend
(internvl2-26b) against the JAX package's, every registry config through
the port's serving entry points, and the serving example on the newly
ported stacks.

Reduced configs at d_model 64 (the cuts of ``tests/test_arch_smoke.py``);
parameters come from the JAX package's ``init_tree(PRNGKey(seed))`` and
are carried across with ``params_from_jax``; frames, patch embeddings and
tokens are numpy arrays from a seed.

Tolerances, as in ``tests/test_torch_lm_archs.py``: in float32 (the
packages' private encoder, decoder and layer-stack functions, float32
caches) logits and caches agree within 1e-3 of their scale, and the
port's decode steps equal its full decoder pass within 1e-3.  These
attention stacks have no query/key norm, and with the reference
initializer's query and key projections their softmax is saturated and
amplifies rounding (ROADMAP R9): whisper's bfloat16 logits lie 30% to
163% of the scale from its float32 ones at every step, internvl2's 1% to
33%.  So the float32 checks run on those weights and again with
``wq``/``wk`` scaled to the width's fan-in (``_fan_in``), and the
bfloat16 checks, through the public entry points, on the latter, against
the float32 logits there (``_bf16_check``): at every step the port's
bfloat16 logits lie no further from the reference's float32 logits than
the reference's own bfloat16 logits do, plus 2e-2 of the scale, and at
each step where the reference's own lie within 2e-2 of its float32 ones
the port's are within 2e-2 of the reference's: 8 of 8 steps for whisper,
7 of 7 for internvl2.
"""
import dataclasses
import runpy
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as ref_configs
from repro.configs.base import BlockCfg as RefBlockCfg
from repro.models import attention as ref_attn
from repro.models import layers as ref_layers
from repro.models import lm as ref_lm
from repro.models.specs import init_tree as ref_init_tree
from repro_torch import configs
from repro_torch.models import lm
from repro_torch.models.specs import (flatten, init_tree, params_from_jax,
                                      tree_map)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
F32_TOL = 1e-3           # of the scale, float32
BF16_TOL = 2e-2          # of the logits' scale, bfloat16


def reduced(cfg):
    """Shrink a full config, keeping the family's shape (the cuts of
    ``tests/test_arch_smoke.py``)."""
    return dataclasses.replace(
        cfg, d_model=64, n_heads=max(2, min(cfg.n_heads, 4)),
        n_kv_heads=1 if cfg.n_kv_heads == 1 else 2, head_dim=16, d_ff=128,
        vocab=512, repeats=2, enc_layers=2 if cfg.enc_layers else 0,
        dec_seq=32 if cfg.encdec else 448)


def _pair(arch: str, seed: int = 0):
    """(port cfg, JAX cfg, port params, JAX params), the same weights."""
    cfg = reduced(configs.get_config(arch))
    ref_cfg = reduced(ref_configs.get_config(arch))
    ref_params = ref_init_tree(jax.random.PRNGKey(seed),
                               ref_lm.build_specs(ref_cfg))
    params = params_from_jax(jax.tree.map(np.asarray, ref_params), "cpu",
                             specs=lm.build_specs(cfg))
    return cfg, ref_cfg, params, ref_params


def _np(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _err(got, want) -> float:
    """Largest difference as a share of ``want``'s largest magnitude."""
    got, want = _np(got), _np(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _caches_close(caches: dict, ref_caches) -> None:
    ref = dict(flatten(jax.tree.map(np.asarray, ref_caches)))
    for path, leaf in flatten(caches):
        assert _err(leaf, ref[path]) <= F32_TOL, path


def _fan_in(ref_params):
    """The JAX tree with every attention query and key projection (leaves
    ``wq``/``wk`` of shape (..., D, heads, head_dim)) scaled from the
    initializer's std ``1/sqrt(heads)`` to ``1/sqrt(D)`` (ROADMAP R9)."""
    def scale(path, a):
        if getattr(path[-1], "key", None) in ("wq", "wk"):
            return a * np.float32(np.sqrt(a.shape[-2] / a.shape[-3]))
        return a
    return jax.tree_util.tree_map_with_path(scale, ref_params)


def _carry(cfg, ref_params) -> dict:
    return params_from_jax(jax.tree.map(np.asarray, ref_params), "cpu",
                           specs=lm.build_specs(cfg))


def _bf16_check(served: list, exact: list) -> int:
    """``served``: per step (port bfloat16 logits, reference bfloat16
    logits); ``exact``: the reference's float32 logits.  Every step's
    port logits are finite and no further from ``exact`` than the
    reference's plus 2e-2 of the scale; where the reference's lie within
    2e-2 of ``exact``, the port's are within 2e-2 of the reference's.
    Returns the number of those steps."""
    compared = 0
    for i, ((got, ref), want) in enumerate(zip(served, exact)):
        assert bool(torch.isfinite(got.float()).all()), i
        assert _err(got, want) <= _err(ref, want) + BF16_TOL, i
        if _err(ref, want) <= BF16_TOL:
            assert _err(got, ref) <= BF16_TOL, i
            compared += 1
    return compared


def _ref_encode(p, cfg, frames):
    """The JAX package's ``_encdec_encode`` in float32 (its own rounds the
    frames, and so the first layer's normed input, to bfloat16)."""
    x, pos = frames, jnp.arange(frames.shape[1])
    for i in range(cfg.enc_layers):
        x, _, _ = ref_lm._apply_block(p["encoder"][f"e{i}"], x, cfg,
                                      RefBlockCfg("attn", "dense"),
                                      positions=pos, cache=None,
                                      cur_index=None, causal=False)
    return ref_layers.rms_norm(x, p["enc_final_norm"], cfg.norm_eps)


def _ref_decode_step(p, cfg, x, caches, cur):
    """The JAX package's ``_encdec_decode_step`` in float32 from the
    token embeddings x (B, 1, D) (its own rounds them to bfloat16)."""
    pos, new = jnp.full((1,), 0) + cur, {}
    for i in range(cfg.repeats):
        d, c = p["decoder"][f"d{i}"], caches[f"d{i}"]
        x, nc, _ = ref_lm._apply_block(d, x, cfg, RefBlockCfg("attn", "dense"),
                                       positions=pos,
                                       cache={"k": c["k"], "v": c["v"]},
                                       cur_index=cur)
        h = ref_layers.rms_norm(x, d["ln_cross"], cfg.norm_eps)
        q = jnp.einsum("bsd,dhk->bhsk", h, d["cross"]["wq"])
        o = ref_attn.decode_attention(
            q, c["ck"], c["cv"], cur_index=jnp.asarray(c["ck"].shape[2] - 1))
        x = x + jnp.einsum("bhsk,hkd->bsd", o, d["cross"]["wo"])
        new[f"d{i}"] = dict(c, k=nc["k"], v=nc["v"])
    x = ref_layers.rms_norm(x, p["final_norm"], cfg.norm_eps)
    return x @ p["embed"].T, new


def _whisper_f32(cfg, ref_cfg, params, ref_params, frames, tokens) -> list:
    """In float32 through the private encoder and decoder functions: each
    step's logits and caches against the JAX package's, and the port's
    steps against its full decoder pass.  Returns the reference's logits
    per step."""
    enc = lm._encdec_encode(params, cfg, torch.tensor(frames))
    ref_enc = jax.jit(_ref_encode, static_argnums=1)(ref_params, ref_cfg,
                                                     frames)
    assert _err(enc, ref_enc) <= F32_TOL
    caches = lm._encdec_stage(params, cfg, torch.tensor(frames), tree_map(
        lambda t: t.float(), lm.init_cache(cfg, 2, 64, "cpu")))
    ref_caches = jax.tree.map(lambda a: a.astype(jnp.float32),
                              ref_lm.init_cache(ref_cfg, 2, 64))
    for i in range(cfg.repeats):
        ref_cross = ref_params["decoder"][f"d{i}"]["cross"]
        for name, w in (("ck", "wk"), ("cv", "wv")):
            ref_caches[f"d{i}"][name] = jnp.einsum(
                "bsd,dhk->bhsk", ref_enc, ref_cross[w])
    ref_step = jax.jit(lambda p, t, c, i: _ref_decode_step(
        p, ref_cfg, p["embed"][t], c, i))
    exact, steps = [], []
    for i in range(tokens.shape[1]):
        tok = tokens[:, i:i + 1]
        logits, caches = lm._encdec_decode_step(params, cfg, torch.tensor(tok),
                                                caches, i)
        ref_logits, ref_caches = ref_step(ref_params, jnp.asarray(tok),
                                          ref_caches,
                                          jnp.asarray(i, jnp.int32))
        assert _err(logits, ref_logits) <= F32_TOL, i
        _caches_close(caches, ref_caches)
        exact.append(ref_logits)
        steps.append(logits)
    full = lm._encdec_forward(params, cfg, enc, torch.tensor(tokens))
    assert _err(torch.cat(steps, dim=1), full) <= F32_TOL
    return exact


def test_whisper_encdec_prefill_decode_match_jax_and_full_pass():
    """Encode 64 frames, stage the cross K/V, decode 8 tokens from token 1:
    in float32 the logits and caches of each step against the JAX
    package's and the port's steps against its full decoder pass, on the
    initializer's weights and at the width's fan-in; on the latter in
    bfloat16 through ``encdec_prefill`` / ``decode_step``."""
    cfg, ref_cfg, params, ref_params = _pair("whisper-tiny")
    rng = np.random.default_rng(1)
    frames = rng.standard_normal((2, 64, 64)).astype(np.float32)
    tokens = np.concatenate([np.ones((2, 1), np.int64),
                             rng.integers(1, cfg.vocab, (2, 7))], axis=1)
    _whisper_f32(cfg, ref_cfg, params, ref_params, frames, tokens)
    ref_params = _fan_in(ref_params)
    params = _carry(cfg, ref_params)
    exact = _whisper_f32(cfg, ref_cfg, params, ref_params, frames, tokens)

    # bfloat16: the public entry points of both packages
    caches = lm.encdec_prefill(params, cfg, {"frames": torch.tensor(frames)},
                               lm.init_cache(cfg, 2, 64, "cpu"))
    ref_caches = jax.jit(lambda p, b, c: ref_lm.encdec_prefill(
        p, ref_cfg, b, c))(ref_params, {"frames": jnp.asarray(frames)},
                           ref_lm.init_cache(ref_cfg, 2, 64))
    ref_decode = jax.jit(lambda p, t, c, i: ref_lm.decode_step(p, ref_cfg, t,
                                                               c, i))
    served = []
    for i in range(tokens.shape[1]):
        tok = tokens[:, i:i + 1]
        logits, caches = lm.decode_step(params, cfg, torch.tensor(tok),
                                        caches, i)
        ref_logits, ref_caches = ref_decode(ref_params, jnp.asarray(tok),
                                            ref_caches,
                                            jnp.asarray(i, jnp.int32))
        served.append((logits, ref_logits))
    assert len(served) == len(exact) == 8
    assert _bf16_check(served, exact) >= 8


def _internvl_f32(cfg, ref_cfg, params, ref_params, embeds, tokens) -> list:
    """In float32 through both packages' layer stacks: the prefill's and
    each decode step's logits and caches.  Returns the reference's logits
    per step."""
    table = np.asarray(ref_params["embed"])

    def ref_stack(p, x, c, start, cur):
        pos = jnp.arange(x.shape[1]) + start
        x, c, _ = ref_lm._run_stack(p, x, ref_cfg, positions=pos, caches=c,
                                    cur_index=cur)
        x = ref_layers.rms_norm(x, p["final_norm"], ref_cfg.norm_eps)
        return x[:, -1:] @ p["embed"].T, c

    ref_prefill = jax.jit(lambda p, x, c: ref_stack(p, x, c, 0, None))
    ref_decode = jax.jit(lambda p, x, c, i: ref_stack(p, x, c, i, i))
    caches = tree_map(lambda t: t.float(), lm.init_cache(cfg, 2, 64, "cpu"))
    ref_caches = jax.tree.map(lambda a: a.astype(jnp.float32),
                              ref_lm.init_cache(ref_cfg, 2, 64))
    x, _ = lm._run_stack(params, torch.tensor(embeds), cfg,
                         positions=torch.arange(48), caches=caches)
    ref_logits, ref_caches = ref_prefill(ref_params, embeds, ref_caches)
    assert _err(lm._logits(params, cfg, x[:, -1:]), ref_logits) <= F32_TOL
    exact = [ref_logits]
    for i in range(tokens.shape[1]):
        row = table[tokens[:, i:i + 1]]
        x, _ = lm._run_stack(params, torch.tensor(row), cfg,
                             positions=torch.tensor([48 + i]),
                             caches=caches, cur_index=48 + i)
        ref_logits, ref_caches = ref_decode(ref_params, row, ref_caches,
                                            jnp.asarray(48 + i, jnp.int32))
        assert _err(lm._logits(params, cfg, x), ref_logits) <= F32_TOL, i
        _caches_close(caches, ref_caches)
        exact.append(ref_logits)
    return exact


def test_internvl_embeds_prefill_and_token_decode_match_jax():
    """Prefill from 48 patch embeddings, then 6 decoded text tokens (one
    step as embeds (B, 1, D), which equal the token's embedding row): in
    float32 through both packages' layer stacks, on the initializer's
    weights and at the width's fan-in; on the latter in bfloat16 through
    ``prefill`` / ``decode_step``."""
    cfg, ref_cfg, params, ref_params = _pair("internvl2-26b")
    assert not cfg.uses_tokens
    rng = np.random.default_rng(2)
    embeds = rng.standard_normal((2, 48, 64)).astype(np.float32) * 0.02
    tokens = rng.integers(1, cfg.vocab, (2, 6))
    _internvl_f32(cfg, ref_cfg, params, ref_params, embeds, tokens)
    ref_params = _fan_in(ref_params)
    params = _carry(cfg, ref_params)
    exact = _internvl_f32(cfg, ref_cfg, params, ref_params, embeds, tokens)

    logits, caches = lm.prefill(params, cfg, {"embeds": torch.tensor(embeds)},
                                lm.init_cache(cfg, 2, 64, "cpu"))
    ref_logits, ref_caches = jax.jit(
        lambda p, b, c: ref_lm.prefill(p, ref_cfg, b, c))(
            ref_params, {"embeds": jnp.asarray(embeds)},
            ref_lm.init_cache(ref_cfg, 2, 64))
    served = [(logits, ref_logits)]
    ref_step = jax.jit(lambda p, t, c, i: ref_lm.decode_step(p, ref_cfg, t,
                                                             c, i))
    compute = lm.cast_params(params)
    for i in range(tokens.shape[1]):
        tok = torch.tensor(tokens[:, i:i + 1])
        if i == 3:            # the same step as embeds: the same logits
            probe = tree_map(torch.clone, caches)
            by_row, _ = lm.decode_step(compute, cfg,
                                       compute["embed"][tok], probe, 48 + i)
        logits, caches = lm.decode_step(compute, cfg, tok, caches, 48 + i)
        if i == 3:
            assert torch.equal(by_row, logits)
        ref_logits, ref_caches = ref_step(ref_params, jnp.asarray(tok.numpy()),
                                          ref_caches,
                                          jnp.asarray(48 + i, jnp.int32))
        served.append((logits, ref_logits))
    assert len(served) == len(exact) == 7
    assert _bf16_check(served, exact) >= 7


def test_every_registry_config_prefills_and_decodes():
    """All ten configs at reduced size (windows cut to 32, every block
    kind, MLP and frontend): ``build_specs``, ``init_cache``, ``prefill``
    (or ``encdec_prefill``) and three ``decode_step``s give finite logits
    of shape (B, 1, V); ``forward_loss`` on the same inputs (frames and
    tokens, embeds and labels, or tokens) gives a finite loss."""
    assert len(configs.REGISTRY) == 10
    g = torch.Generator().manual_seed(3)
    for name, full in configs.REGISTRY.items():
        win = tuple(dataclasses.replace(b, window=32 if b.window else 0)
                    for b in full.pattern)
        tail = tuple(dataclasses.replace(b, window=32 if b.window else 0)
                     for b in full.tail)
        cfg = dataclasses.replace(
            reduced(full), pattern=win, tail=tail,
            rnn_width=64 if full.rnn_width else 0,
            ssm_state=32 if full.ssm_state else 0,
            ssm_head_dim=16 if full.ssm_state else 64,
            n_experts=4 if full.n_experts else 0,
            top_k=min(full.top_k, 2) if full.top_k else 0)
        params = init_tree(0, lm.build_specs(cfg), "cpu")
        if cfg.encdec:
            batch = {"frames": torch.randn(2, 64, 64, generator=g),
                     "tokens": torch.randint(1, 512, (2, 16), generator=g)}
            caches = lm.encdec_prefill(params, cfg, batch,
                                       lm.init_cache(cfg, 2, 64, "cpu"))
            start = 0
        else:
            batch = ({"tokens": torch.randint(1, 512, (2, 64), generator=g)}
                     if cfg.uses_tokens else
                     {"embeds": torch.randn(2, 64, 64, generator=g) * 0.02})
            logits, caches = lm.prefill(params, cfg, batch,
                                        lm.init_cache(cfg, 2, 96, "cpu"))
            assert logits.shape == (2, 1, 512), name
            start = 64
        for i in range(3):
            logits, caches = lm.decode_step(
                params, cfg, torch.ones(2, 1, dtype=torch.long), caches,
                start + i)
            assert logits.shape == (2, 1, 512), name
            assert bool(torch.isfinite(logits.float()).all()), name
        if not cfg.uses_tokens:
            batch = dict(batch, labels=torch.randint(1, 512, (2, 64),
                                                     generator=g))
        loss, metrics = lm.forward_loss(params, cfg, batch)
        assert bool(torch.isfinite(loss)), name
        assert set(metrics) == {"xent", "aux"}, name


def test_serve_example_runs_the_new_stacks(monkeypatch, capsys):
    """``examples/torch_serve_lm.py --device cpu`` on the tiny family
    configs of the SSM, hybrid and MoE arches."""
    for arch in ("mamba2-130m", "recurrentgemma-9b", "mixtral-8x7b"):
        monkeypatch.setattr(sys, "argv", [
            "torch_serve_lm", "--arch", arch, "--device", "cpu", "--batch",
            "2", "--new-tokens", "4"])
        runpy.run_path(str(ROOT / "examples" / "torch_serve_lm.py"),
                       run_name="__main__")
        out = capsys.readouterr().out
        assert f"{arch} (tiny family config): generated 2x4 tokens" in out
