"""The port's RG-LRU, SSD and MoE blocks and ``causal_conv1d`` against the
JAX package's, on float32.

Parameters come from the JAX package's ``init_tree(PRNGKey(seed))`` and
are carried across with ``params_from_jax``; inputs are numpy arrays from
a seed.  On float32, outputs, carried states and the MoE aux loss agree
within 1e-5
(absolute and relative): the port's log-depth scan and the JAX package's
``associative_scan`` associate the same products in another order, as do
the two frameworks' einsums.  The MoE routing is compared exactly: the
expert indices and the kept mask are equal, at a capacity that drops some
assignments.  The port's own step-by-step decode equals its forward pass
within 1e-5 (prime SSD lengths included, where the chunk is one token).
The RG-LRU and SSD blocks also run in bfloat16 (the parameters cast as
``cast_params`` casts them) on equal inputs: outputs within 2e-2 of their
scale, the frameworks rounding at other places.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as ref_configs
from repro.models import layers as ref_layers
from repro.models import moe as ref_moe
from repro.models import rglru as ref_rglru
from repro.models import ssd as ref_ssd
from repro.models.specs import init_tree as ref_init_tree
from repro_torch import configs
from repro_torch.models import layers, moe, rglru, ssd
from repro_torch.models.specs import params_from_jax

torch.set_num_threads(1)

TOL = 1e-5
BF16_TOL = 2e-2          # of the output's scale


def _cfg(pkg, arch: str, **kw):
    """A narrow config of ``arch`` in one package's own dataclasses."""
    return dataclasses.replace(pkg.get_config(arch), d_model=32, **kw)


def _params(specs, seed: int):
    """(port params, JAX params) of one spec tree, the same values."""
    ref = ref_init_tree(jax.random.PRNGKey(seed), specs)
    return params_from_jax(jax.tree.map(np.asarray, ref), "cpu"), ref


def _jit(fn):
    """``fn(params, x, cfg, state=None)`` jitted with ``cfg`` static."""
    return jax.jit(fn, static_argnums=2)


def _t(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32))


def _close(got, want, tol: float = TOL) -> None:
    if isinstance(got, dict):
        assert got.keys() == want.keys()
        for k in got:
            _close(got[k], want[k], tol)
        return
    if isinstance(got, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w, tol)
        return
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def _state(tree) -> dict:
    return {k: _t(v) for k, v in tree.items()}


def _bf16_close(fn, ref_fn, p, ref_p, cfg, ref_cfg, x) -> None:
    """``fn`` and ``ref_fn`` (a block's forward) on bfloat16 parameters and
    input: outputs within ``BF16_TOL`` of the reference output's scale."""
    ref_p = jax.tree.map(lambda a: a.astype(jnp.bfloat16), ref_p)
    p = {k: v.to(torch.bfloat16) for k, v in p.items()}
    got, _ = fn(p, _t(x).to(torch.bfloat16), cfg)
    want, _ = _jit(ref_fn)(ref_p, jnp.asarray(x, jnp.bfloat16), ref_cfg)
    want = np.asarray(want.astype(jnp.float32))
    err = np.abs(got.float().numpy() - want).max() / np.abs(want).max()
    assert err <= BF16_TOL, err


def test_causal_conv_and_rglru_match_jax():
    rng = np.random.default_rng(0)
    x, w, b = (rng.standard_normal(s).astype(np.float32)
               for s in ((2, 9, 6), (4, 6), (6,)))
    st = rng.standard_normal((2, 3, 6)).astype(np.float32)
    for state in (None, st):
        _close(layers.causal_conv1d(_t(x), _t(w), _t(b),
                                    None if state is None else _t(state)),
               ref_layers.causal_conv1d(x, w, b, state))

    cfg = _cfg(configs, "recurrentgemma-9b", rnn_width=64)
    ref_cfg = _cfg(ref_configs, "recurrentgemma-9b", rnn_width=64)
    p, ref_p = _params(ref_rglru.rglru_specs(ref_cfg), 1)
    for s in (1, 13, 64):
        xs = rng.standard_normal((2, s, 32)).astype(np.float32)
        y, st = rglru.rglru_forward(p, _t(xs), cfg)
        ref_y, ref_st = _jit(ref_rglru.rglru_forward)(ref_p, xs, ref_cfg)
        _close(y, ref_y)
        _close(st, ref_st)
        carried = {"h": rng.standard_normal((2, 64)).astype(np.float32),
                   "conv": rng.standard_normal((2, 3, 64)).astype(np.float32)}
        y, st = rglru.rglru_forward(p, _t(xs), cfg, _state(carried))
        ref_y, ref_st = _jit(ref_rglru.rglru_forward)(ref_p, xs, ref_cfg,
                                                      carried)
        _close(y, ref_y)
        _close(st, ref_st)
        y, st = rglru.rglru_decode(p, _t(xs[:, :1]), cfg, _state(carried))
        ref_y, ref_st = _jit(ref_rglru.rglru_decode)(ref_p, xs[:, :1], ref_cfg,
                                               carried)
        _close(y, ref_y)
        _close(st, ref_st)
    _bf16_close(rglru.rglru_forward, ref_rglru.rglru_forward, p, ref_p, cfg,
                ref_cfg, xs)


def test_ssd_matches_jax():
    """Lengths of one chunk, of several (256: two of 128; 150: two of 75)
    and a prime past the chunk (131: chunks of one token)."""
    cfg = _cfg(configs, "mamba2-130m", ssm_state=16, ssm_head_dim=8)
    ref_cfg = _cfg(ref_configs, "mamba2-130m", ssm_state=16, ssm_head_dim=8)
    d = ssd.ssd_dims(cfg)
    assert d == ref_ssd.ssd_dims(ref_cfg)
    p, ref_p = _params(ref_ssd.ssd_specs(ref_cfg), 2)
    rng = np.random.default_rng(1)
    for s in (7, 256, 150, 131):
        xs = (rng.standard_normal((2, s, 32)) * 0.5).astype(np.float32)
        y, st = ssd.ssd_forward(p, _t(xs), cfg)
        ref_y, ref_st = _jit(ref_ssd.ssd_forward)(ref_p, xs, ref_cfg)
        _close(y, ref_y)
        _close(st, ref_st)
        carried = {
            "ssm": rng.standard_normal((2, d["n_heads"], d["p"], d["n"])
                                       ).astype(np.float32),
            "conv": rng.standard_normal((2, 3, d["conv_dim"])
                                        ).astype(np.float32)}
        y, st = ssd.ssd_forward(p, _t(xs), cfg, _state(carried))
        ref_y, ref_st = _jit(ref_ssd.ssd_forward)(ref_p, xs, ref_cfg, carried)
        _close(y, ref_y)
        _close(st, ref_st)
    y, st = ssd.ssd_decode(p, _t(xs[:, :1]), cfg, _state(carried))
    ref_y, ref_st = _jit(ref_ssd.ssd_decode)(ref_p, xs[:, :1], ref_cfg,
                                             carried)
    _close(y, ref_y)
    _close(st, ref_st)
    for s in (256, 131):
        xs = (rng.standard_normal((2, s, 32)) * 0.5).astype(np.float32)
        _bf16_close(ssd.ssd_forward, ref_ssd.ssd_forward, p, ref_p, cfg,
                    ref_cfg, xs)


def _ref_routing(p, xt, top_k: int, capacity_factor: float):
    """The JAX package's routing steps of ``_moe_tokens`` (its lines, on
    its functions): expert indices (N, k) and the kept mask (N * k,)."""
    n, e = xt.shape[0], p["router"].shape[-1]
    probs = jax.nn.softmax((xt @ p["router"]).astype(jnp.float32), axis=-1)
    _, idx = jax.lax.top_k(probs, top_k)
    cap = max(int(capacity_factor * n * top_k / e), top_k)
    eid = idx.reshape(-1)
    pos = jnp.cumsum(jax.nn.one_hot(eid, e, dtype=jnp.int32), axis=0) - 1
    pos = jnp.take_along_axis(pos, eid[:, None], axis=-1)[:, 0]
    return np.asarray(idx), np.asarray(pos < cap)


def test_moe_matches_jax_routes_and_drops(monkeypatch):
    """Outputs and aux loss within 1e-5, the routes equal, some of them
    dropped at the published capacity factor 1.25; then the token-chunked
    path (``MAX_DISPATCH_TOKENS`` cut to 32 in both packages)."""
    e, k = 4, 2
    p, ref_p = _params(ref_moe.moe_specs(32, 48, e), 3)
    # a shared offset skews the routing toward some experts, as real
    # activations do, so the published 1.25 drops assignments
    x = (np.random.default_rng(2).standard_normal((4, 16, 32))
         + 0.5).astype(np.float32)
    xt = x.reshape(-1, 32)
    for cf in (1.25, 2.0):
        _, idx, dest, cap, _ = moe.route(p, _t(xt), top_k=k,
                                         capacity_factor=cf)
        ref_idx, ref_kept = _ref_routing(ref_p, xt, k, cf)
        np.testing.assert_array_equal(idx.numpy(), ref_idx)
        kept = (dest < e * cap).numpy()
        np.testing.assert_array_equal(kept, ref_kept)
        assert (not kept.all()) == (cf == 1.25)
        out, aux = moe.moe_apply(p, _t(x), top_k=k, capacity_factor=cf)
        ref_out, ref_aux = ref_moe.moe_apply(ref_p, x, top_k=k,
                                             capacity_factor=cf)
        _close(out, ref_out)
        _close(aux, ref_aux)
    monkeypatch.setattr(moe, "MAX_DISPATCH_TOKENS", 32)
    monkeypatch.setattr(ref_moe, "MAX_DISPATCH_TOKENS", 32)
    out, aux = moe.moe_apply(p, _t(x), top_k=k, capacity_factor=1.25)
    ref_out, ref_aux = ref_moe.moe_apply(ref_p, x, top_k=k,
                                         capacity_factor=1.25)
    _close(out, ref_out)
    _close(aux, ref_aux)
    whole, _ = moe.moe_apply(p, _t(x)[:1, :8], top_k=k, capacity_factor=1.25)
    assert whole.shape == (1, 8, 32)


def test_port_decode_steps_equal_forward():
    """Step-by-step decode from a zero state equals the forward pass and
    ends in the same state (SSD at 67 tokens, a prime: one chunk of 67;
    at 131, a prime past the chunk: chunks of one token; at 256: two
    chunks of 128)."""
    for block in ("rglru", "ssd"):
        _decode_steps_equal_forward(block)


def _decode_steps_equal_forward(block: str) -> None:
    if block == "rglru":
        cfg = _cfg(configs, "recurrentgemma-9b", rnn_width=32)
        p, _ = _params(ref_rglru.rglru_specs(
            _cfg(ref_configs, "recurrentgemma-9b", rnn_width=32)), 6)
        fwd, dec, init = (rglru.rglru_forward, rglru.rglru_decode,
                          rglru.rglru_init_state)
        lengths = (64,)
    else:
        cfg = _cfg(configs, "mamba2-130m", ssm_state=16, ssm_head_dim=8)
        p, _ = _params(ref_ssd.ssd_specs(
            _cfg(ref_configs, "mamba2-130m", ssm_state=16, ssm_head_dim=8)), 5)
        fwd, dec, init = ssd.ssd_forward, ssd.ssd_decode, ssd.ssd_init_state
        lengths = (67, 131, 256)
    rng = np.random.default_rng(3)
    for s in lengths:
        x = _t(rng.standard_normal((2, s, 32)) * 0.5)
        y_full, st_full = fwd(p, x, cfg)
        state = init(cfg, 2, "cpu")
        ys = []
        for t in range(s):
            y_t, state = dec(p, x[:, t:t + 1], cfg, state)
            ys.append(y_t)
        _close(torch.cat(ys, dim=1), y_full.numpy())
        _close(state, {n: v.numpy() for n, v in st_full.items()})
