"""The port's prefill and decode for the recurrent, SSM and MoE stacks
against the JAX package's, and the sliding-window ring after a long
prompt (ROADMAP R6).

Reduced configs of mamba2-130m (``ssd`` blocks, no MLP), recurrentgemma-9b
(``rglru`` / ``swa`` with a tail) and mixtral-8x7b (``swa`` with a ``moe``
MLP) at d_model 64, windows cut to 32 (as ``tests/test_arch_smoke.py``
cuts them); parameters come from the JAX package's
``init_tree(PRNGKey(seed))`` and are carried across with
``params_from_jax``.

Tolerances.  In float32 (both packages' layer stacks, float32 caches)
the logits and every cache leaf agree within 1e-3 of their scale (the
largest magnitude of the reference's values): the blocks agree within
1e-5 (``tests/test_torch_blocks.py``), and over the layers the saturated
attention softmax (below) of the recurrentgemma config amplifies that to
1.3e-4 (mamba2 and mixtral stay near 1e-6).  In bfloat16, through the
public ``prefill`` / ``decode_step`` (``cast_params``), the two frameworks
round at other places (XLA keeps excess precision across fused ops; the
port rounds each op).  With the reference initializer's query and key
projections the attention softmax is saturated, so a one-ulp change of a
score moves the output (ROADMAP R9): the JAX package's own bfloat16
logits then lie up to 27% (mixtral) and 52% (recurrentgemma) of the
scale from its float32 ones.  So the bfloat16 comparison runs on the
same weights with ``wq``/``wk`` scaled to the width's fan-in
(``_fan_in``), where the scores are of order 1, against the float32
steps on those weights (``_bf16_check``).  At every step (the prefill and
6 decode steps, 7 per arch) the port's bfloat16 logits lie no further
from the reference's float32 logits than the reference's own bfloat16
logits do, plus 2e-2 of the scale; at each step where the reference's
own lie within 2e-2 of its float32 ones, the port's are within 2e-2 of
the reference's: 7 of 7 steps for mamba2, 5 of 7 for mixtral and none
for recurrentgemma, whose reference bfloat16 logits lie more than 2e-2
from its own float32 ones at every step of this seed (the test asserts
these counts as floors).  The MoE router is
held in bfloat16 on the port's own router inputs: the JAX package's
routing of them picks the same experts, except at near-ties, where the
two experts' router logits differ by less than bfloat16's resolution
(``torch.finfo(torch.bfloat16).resolution``, 0.01) of the token's
largest router logit.  The R6 ring check is exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import layers as ref_layers
from repro.models import lm as ref_lm
from repro.models.specs import init_tree as ref_init_tree
from repro_torch import configs
from repro_torch.models import lm, moe
from repro_torch.models.specs import (flatten, init_tree, params_from_jax,
                                      tree_map)

torch.set_num_threads(1)

F32_TOL = 1e-3           # of the scale, float32
BF16_TOL = 2e-2          # of the logits' scale, bfloat16
BF16_RES = torch.finfo(torch.bfloat16).resolution
PROMPT, STEPS = 64, 6


def reduced(cfg, window: int = 32):
    """Shrink a full config, keeping the family's shape (the cuts of
    ``tests/test_arch_smoke.py``)."""
    kw = dict(
        d_model=64,
        n_heads=max(2, min(cfg.n_heads, 4)) if cfg.n_heads else 0,
        n_kv_heads=(1 if cfg.n_kv_heads == 1 else 2) if cfg.n_kv_heads else 0,
        head_dim=16 if cfg.head_dim else 0,
        d_ff=128 if cfg.d_ff else 0,
        vocab=512,
        repeats=2 if cfg.repeats > 0 else 0,
        rnn_width=64 if cfg.rnn_width else 0,
        ssm_state=32 if cfg.ssm_state else 0,
        ssm_head_dim=16 if cfg.ssm_state else 64,
        n_experts=4 if cfg.n_experts else 0,
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
    )
    pattern = tuple(dataclasses.replace(b, window=window if b.window else 0)
                    for b in cfg.pattern)
    tail = tuple(dataclasses.replace(b, window=window if b.window else 0)
                 for b in cfg.tail)
    return dataclasses.replace(cfg, pattern=pattern, tail=tail, **kw)


def _np(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _err(got, want) -> float:
    """Largest difference as a share of ``want``'s largest magnitude."""
    got, want = _np(got), _np(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _f32_steps(cfg, ref_cfg, params, ref_params, tokens):
    """Prefill and decode through both packages' layer stacks in float32,
    with float32 caches: per step (port logits, reference logits), after
    checking every cache leaf."""
    def ref_stack(p, x, c, start, cur):
        pos = jnp.arange(x.shape[1]) + start
        x, c, _ = ref_lm._run_stack(p, x, ref_cfg, positions=pos, caches=c,
                                    cur_index=cur)
        x = ref_layers.rms_norm(x, p["final_norm"], ref_cfg.norm_eps)
        return x[:, -1:] @ p["embed"].T, c

    ref_prefill = jax.jit(lambda p, x, c: ref_stack(p, x, c, 0, None))
    ref_decode = jax.jit(lambda p, x, c, i: ref_stack(p, x, c, i, i))
    b, s = tokens.shape
    ref_caches = jax.tree.map(lambda a: a.astype(jnp.float32),
                              ref_lm.init_cache(ref_cfg, b, 96))
    caches = tree_map(lambda t: t.float(), lm.init_cache(cfg, b, 96, "cpu"))
    table = np.asarray(ref_params["embed"])
    out = []
    for i in range(s - PROMPT + 1):
        lo, hi = (0, PROMPT) if i == 0 else (PROMPT + i - 1, PROMPT + i)
        x = table[tokens[:, lo:hi]]
        if i == 0:
            ref_logits, ref_caches = ref_prefill(ref_params, x, ref_caches)
        else:
            ref_logits, ref_caches = ref_decode(ref_params, x, ref_caches,
                                                jnp.asarray(lo, jnp.int32))
        h, _ = lm._run_stack(params, torch.tensor(x), cfg,
                             positions=torch.arange(lo, hi), caches=caches,
                             cur_index=None if i == 0 else lo)
        out.append((lm._logits(params, cfg, h[:, -1:]), ref_logits))
        ref = dict(flatten(jax.tree.map(np.asarray, ref_caches)))
        for path, leaf in flatten(caches):
            assert _err(leaf, ref[path]) <= F32_TOL, (i, path)
    return out


def _fan_in(ref_params):
    """The JAX tree with every attention query and key projection (leaves
    ``wq``/``wk`` of shape (..., D, heads, head_dim)) scaled from the
    initializer's std ``1/sqrt(heads)`` to ``1/sqrt(D)`` (ROADMAP R9)."""
    def scale(path, a):
        if getattr(path[-1], "key", None) in ("wq", "wk"):
            return a * np.float32(np.sqrt(a.shape[-2] / a.shape[-3]))
        return a
    return jax.tree_util.tree_map_with_path(scale, ref_params)


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


def _ref_routing(xt, router, top_k: int, capacity_factor: float):
    """The JAX package's routing lines of ``_moe_tokens``: router logits,
    expert ids (N, k) and the kept mask (N, k)."""
    n, e = xt.shape[0], router.shape[-1]
    logits = (xt @ router).astype(jnp.float32)
    _, idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), top_k)
    cap = max(int(capacity_factor * n * top_k / e), top_k)
    eid = idx.reshape(-1)
    pos = jnp.cumsum(jax.nn.one_hot(eid, e, dtype=jnp.int32), axis=0) - 1
    pos = jnp.take_along_axis(pos, eid[:, None], axis=-1)[:, 0]
    return logits, idx, (pos < cap).reshape(idx.shape)


def _record_routes(monkeypatch) -> list:
    """A list that fills with each of the port's MoE routing calls:
    (router input, router weights, options, result)."""
    calls = []
    real = moe.route

    def route(p, xt, **kw):
        out = real(p, xt, **kw)
        calls.append((xt, p["router"], kw, out))
        return out

    monkeypatch.setattr(moe, "route", route)
    return calls


def _check_routes(calls: list) -> int:
    """The JAX package's routing of the port's own router inputs (jitted,
    as it serves) picks the same experts and keeps the same assignments,
    except at near-ties: where an expert differs, the two experts' router
    logits differ by less than bfloat16's resolution of the token's largest
    router logit, in both frameworks; where only the kept mask differs, an
    earlier assignment of the same call changed expert.  Returns the
    number of tokens routed differently."""
    ref_route = jax.jit(_ref_routing, static_argnums=(2, 3))
    bf16 = lambda t: jnp.asarray(t.float().numpy(), jnp.bfloat16)  # noqa: E731
    differ = 0
    for xt, router, kw, (_, idx, dest, cap, _) in calls:
        ref_logits, ref_idx, ref_kept = map(np.asarray, ref_route(
            bf16(xt), bf16(router), kw["top_k"], kw["capacity_factor"]))
        logits = (xt @ router).float().numpy()
        idx = idx.numpy()
        kept = (dest < router.shape[-1] * cap).reshape(idx.shape).numpy()
        flipped = np.nonzero((idx != ref_idx).any(-1))[0]
        for t in np.nonzero((idx != ref_idx).any(-1)
                            | (kept != ref_kept).any(-1))[0]:
            differ += 1
            if t not in flipped:
                assert flipped.size and flipped[0] < t, t
                continue
            j = int(np.nonzero(idx[t] != ref_idx[t])[0][0])
            a, e = idx[t, j], ref_idx[t, j]
            for lg in (logits[t], ref_logits[t]):
                assert abs(lg[a] - lg[e]) < BF16_RES * np.abs(lg).max(), lg
    return differ


@pytest.mark.parametrize("arch", ["mamba2-130m", "recurrentgemma-9b",
                                  "mixtral-8x7b"])
def test_prefill_decode_logits_and_caches_match_jax(arch, monkeypatch):
    """A 64-token prompt (the 32-slot rings wrap twice), then 6 decode
    steps: in float32 the logits and caches after each step; in bfloat16,
    with the query and key projections at the width's fan-in, the served
    logits of every step and the MoE routes."""
    cfg = reduced(configs.get_config(arch))
    ref_cfg = reduced(ref_configs.get_config(arch))
    ref_params = ref_init_tree(jax.random.PRNGKey(0),
                               ref_lm.build_specs(ref_cfg))
    params = params_from_jax(jax.tree.map(np.asarray, ref_params), "cpu",
                             specs=lm.build_specs(cfg))
    tokens = np.random.default_rng(1).integers(1, cfg.vocab,
                                               (2, PROMPT + STEPS))
    for got, want in _f32_steps(cfg, ref_cfg, params, ref_params, tokens):
        assert _err(got, want) <= F32_TOL

    ref_params = _fan_in(ref_params)
    params = params_from_jax(jax.tree.map(np.asarray, ref_params), "cpu",
                             specs=lm.build_specs(cfg))
    exact = []
    for got, want in _f32_steps(cfg, ref_cfg, params, ref_params, tokens):
        assert _err(got, want) <= F32_TOL
        exact.append(want)
    routes = _record_routes(monkeypatch)
    ref_logits, ref_caches = jax.jit(
        lambda p, b, c: ref_lm.prefill(p, ref_cfg, b, c))(
            ref_params, {"tokens": jnp.asarray(tokens[:, :PROMPT])},
            ref_lm.init_cache(ref_cfg, 2, 96))
    logits, caches = lm.prefill(params, cfg,
                                {"tokens": torch.tensor(tokens[:, :PROMPT])},
                                lm.init_cache(cfg, 2, 96, "cpu"))
    served = [(logits, ref_logits)]
    ref_decode = jax.jit(lambda p, t, c, i: ref_lm.decode_step(p, ref_cfg, t,
                                                               c, i))
    for i in range(STEPS):
        pos = PROMPT + i
        ref_logits, ref_caches = ref_decode(
            ref_params, jnp.asarray(tokens[:, pos:pos + 1]), ref_caches,
            jnp.asarray(pos, jnp.int32))
        logits, caches = lm.decode_step(
            params, cfg, torch.tensor(tokens[:, pos:pos + 1]), caches, pos)
        served.append((logits, ref_logits))
    assert len(served) == len(exact) == STEPS + 1
    compared = _bf16_check(served, exact)
    assert compared >= {"mamba2-130m": 7, "recurrentgemma-9b": 0,
                        "mixtral-8x7b": 5}[arch]
    assert bool(routes) == (arch == "mixtral-8x7b")
    assert _check_routes(routes) <= 2


def test_long_prompt_ring_slots_and_next_decode(monkeypatch):
    """R6: a recurrentgemma-style stack at window 2048 after a 2560-token
    prompt (not a multiple of the window): every ``swa`` ring holds the
    K/V of position ``p`` in slot ``p % 2048`` for the last 2048 positions,
    exactly; and in float32 the next decode step's logits are within 1e-3
    of one forward pass's at the same position."""
    cfg = dataclasses.replace(reduced(configs.get_config("recurrentgemma-9b"),
                                      window=2048), repeats=1)
    assert [b.kind for b in cfg.pattern + cfg.tail] == ["rglru", "rglru",
                                                        "swa", "rglru",
                                                        "rglru"]
    params = init_tree(0, lm.build_specs(cfg), "cpu")
    s, window = 2560, 2048
    toks = torch.tensor(np.random.default_rng(2).integers(1, cfg.vocab,
                                                          (1, s + 1)))
    written = []
    real = lm._cache_write_prefill

    def keep(cache, k, v, blk):
        written.append((cache, k.clone(), v.clone()))
        real(cache, k, v, blk)

    monkeypatch.setattr(lm, "_cache_write_prefill", keep)
    lm.prefill(params, cfg, {"tokens": toks[:, :s]},
               lm.init_cache(cfg, 1, 4096, "cpu"))
    assert len(written) == 1
    cache, k, v = written[0]
    slots = torch.arange(s - window, s) % window
    assert torch.equal(cache["k"][:, :, slots], k[:, :, s - window:])
    assert torch.equal(cache["v"][:, :, slots], v[:, :, s - window:])

    x = lm.embed_lookup(params["embed"], toks)
    caches = tree_map(lambda t: t.float(), lm.init_cache(cfg, 1, 4096, "cpu"))
    lm._run_stack(params, x[:, :s], cfg, positions=torch.arange(s),
                  caches=caches)
    step, _ = lm._run_stack(params, x[:, s:], cfg,
                            positions=torch.tensor([s]), caches=caches,
                            cur_index=s)
    full, _ = lm._run_stack(params,
                            torch.nn.functional.pad(x, (0, 0, 0, 511)), cfg,
                            positions=torch.arange(3072), caches=None)
    assert _err(lm._logits(params, cfg, step),
                lm._logits(params, cfg, full[:, s:s + 1])) <= F32_TOL
