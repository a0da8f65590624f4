"""The port's training loss (``forward_loss``) and its gradients against
the JAX package's, for every block kind.

Reduced configs at d_model 64 (the cuts of ``tests/test_torch_lm_archs.py``):
qwen3 (``attn``), gemma3 (``swa``), mamba2 (``ssd``), recurrentgemma
(``rglru`` with its tail), mixtral (``moe``, its aux loss included),
internvl2 (``embeds`` / ``labels``) and whisper (the encoder-decoder).
Parameters come from the JAX package's ``init_tree(PRNGKey(seed))`` and
are carried across with ``params_from_jax``; tokens, patch embeddings and
frames are numpy arrays from a seed.

The JAX package's public ``forward_loss`` computes in bfloat16, so the
float32 comparison runs its own internals in float32 (``_run_stack``,
``rms_norm``, ``chunked_softmax_xent``, the encoder-decoder's blocks) under
``jax.value_and_grad`` against the port's ``forward_loss(...,
dtype=torch.float32)`` and ``.backward()``.  The JAX package's
``grad_bf16`` hands a bfloat16 cotangent to a float32 input, which its own
float32 backward cannot take (``lax.mul`` refuses the mixed dtypes,
ROADMAP R10); the ``ref_f32`` fixture gives it the port's float32 meaning,
the identity.  Whisper's frames are bfloat16 values, since its encoder
rounds them to bfloat16.

Tolerances: the loss within 1e-5 (relative); every gradient leaf within
1e-3 of that leaf's largest magnitude in the reference, plus the
reference's own spread: the largest distance of its gradients from
themselves when every weight matrix is scaled by +-1 or +-2 ulps
(1 + k * 2**-23).  On the initializer's weights whisper's non-causal
encoder softmax is saturated (ROADMAP R9), and those scalings alone move
the reference's gradients by up to 1.1e-2 of their scale (the port lies
up to 5.8e-3 from it there); elsewhere the spread is below 4e-4.  Checked on the initializer's weights and with ``wq`` / ``wk``
at the width's fan-in (``_fan_in``).  With ``remat`` on and off the
port's loss is equal and its gradients within 1e-6.  The public bfloat16
losses of the two query/key-norm stacks (qwen3, gemma3) agree within 2e-2
(relative).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.configs.base import BlockCfg as RefBlockCfg
from repro.models import attention as ref_attn
from repro.models import layers as ref_layers
from repro.models import lm as ref_lm
from repro.models import moe as ref_moe
from repro.models.specs import init_tree as ref_init_tree
from repro_torch import configs
from repro_torch.models import layers, lm
from repro_torch.models.specs import flatten, params_from_jax, tree_map
from test_torch_lm_archs import _fan_in, reduced

torch.set_num_threads(1)

LOSS_TOL = 1e-5          # relative, float32
GRAD_TOL = 1e-3          # of each leaf's scale, float32
REMAT_TOL = 1e-6
ULPS = (1, -1, 2, -2)    # weight scalings of the reference's own spread
BF16_TOL = 2e-2          # relative, the public bfloat16 loss
B, S = 2, 64


@pytest.fixture
def ref_f32(monkeypatch):
    """The JAX package's ``grad_bf16`` with the port's float32 meaning."""
    for mod in (ref_lm, ref_moe):
        monkeypatch.setattr(mod, "grad_bf16", lambda x: x)


def _batch(cfg, seed: int = 1) -> dict:
    """Numpy inputs from a seed: tokens, or patch embeddings (at the
    table's scale) and labels, or bfloat16-valued frames and tokens."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, cfg.vocab, (B, S)).astype(np.int32)
    tokens[0, -5:] = 0                     # padding: masked labels
    if cfg.encdec:
        frames = jnp.asarray(rng.standard_normal((B, S, cfg.d_model)),
                             jnp.bfloat16).astype(jnp.float32)
        return {"frames": np.asarray(frames), "tokens": tokens[:, :32]}
    if not cfg.uses_tokens:
        embeds = rng.standard_normal((B, S, cfg.d_model)) * 0.02
        return {"embeds": embeds.astype(np.float32), "labels": tokens}
    return {"tokens": tokens}


def _ref_encdec_loss(p, cfg, batch):
    """The JAX package's ``_encdec_loss`` in float32 (its own casts the
    frames and the token embeddings to bfloat16)."""
    enc = batch["frames"]
    pos = jnp.arange(enc.shape[1])
    blk = RefBlockCfg("attn", "dense")
    for i in range(cfg.enc_layers):
        enc, _, _ = ref_lm._apply_block(p["encoder"][f"e{i}"], enc, cfg, blk,
                                        positions=pos, cache=None,
                                        cur_index=None, causal=False)
    enc = ref_layers.rms_norm(enc, p["enc_final_norm"], cfg.norm_eps)
    tokens = batch["tokens"]
    x = p["embed"][tokens]
    pos = jnp.arange(x.shape[1])
    for i in range(cfg.repeats):
        d = p["decoder"][f"d{i}"]
        x, _, _ = ref_lm._apply_block(d, x, cfg, blk, positions=pos,
                                      cache=None, cur_index=None)
        h = ref_layers.rms_norm(x, d["ln_cross"], cfg.norm_eps)
        q = jnp.einsum("bsd,dhk->bhsk", h, d["cross"]["wq"])
        ek = jnp.einsum("bsd,dhk->bhsk", enc, d["cross"]["wk"])
        ev = jnp.einsum("bsd,dhk->bhsk", enc, d["cross"]["wv"])
        o = ref_attn.flash_attention(q, ek, ev, causal=False)
        x = x + jnp.einsum("bhsk,hkd->bsd", o, d["cross"]["wo"])
    x = ref_layers.rms_norm(x, p["final_norm"], cfg.norm_eps)
    labels = jnp.pad(tokens[:, 1:], ((0, 0), (0, 1)))
    mask = (labels > 0).astype(jnp.float32)
    loss = ref_layers.chunked_softmax_xent(x, p["embed"], labels, mask,
                                           chunk=min(448, x.shape[1]))
    return loss, (loss, jnp.zeros((), jnp.float32))


def _ref_loss(p, cfg, batch):
    """The JAX package's ``forward_loss`` in float32, through its
    internals: (total, (xent, aux))."""
    if cfg.encdec:
        return _ref_encdec_loss(p, cfg, batch)
    if cfg.uses_tokens:
        tokens = batch["tokens"]
        x = p["embed"][tokens]
        labels = jnp.pad(tokens[:, 1:], ((0, 0), (0, 1)))
    else:
        x, labels = batch["embeds"], batch["labels"]
    if cfg.family == "hybrid":
        x = x * (cfg.d_model ** 0.5)
    x, _, aux = ref_lm._run_stack(p, x, cfg, positions=jnp.arange(S))
    x = ref_layers.rms_norm(x, p["final_norm"], cfg.norm_eps)
    mask = (labels > 0).astype(jnp.float32)
    table = p["embed"] if cfg.tie_embeddings else p["lm_head"].T
    loss = ref_layers.chunked_softmax_xent(x, table, labels, mask)
    return loss + 0.01 * aux, (loss, aux)


def _port_loss(params, cfg, batch, remat: bool):
    """The port's float32 loss, metrics and gradients (``.backward()``)."""
    leaves = tree_map(lambda t: t.detach().clone().requires_grad_(), params)
    loss, metrics = lm.forward_loss(
        leaves, cfg, {k: torch.tensor(v) for k, v in batch.items()},
        remat=remat, dtype=torch.float32)
    loss.backward()
    grads = {path: t.grad for path, t in flatten(leaves)}
    return loss.detach(), metrics, grads


def _rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / max(np.abs(want).max(), 1e-30))


def _ulps(tree, k: int):
    """Every weight matrix scaled by ``k`` ulps, 1 + k * 2**-23."""
    return jax.tree.map(lambda a: a * np.float32(1 + k * 2.0 ** -23)
                        if a.ndim >= 2 else a, tree)


def _check_arch(arch: str) -> None:
    cfg = reduced(configs.get_config(arch))
    ref_cfg = reduced(ref_configs.get_config(arch))
    ref_params = ref_init_tree(jax.random.PRNGKey(0),
                               ref_lm.build_specs(ref_cfg))
    batch = _batch(cfg)
    ref_batch = {k: jnp.asarray(v) for k, v in batch.items()}
    ref_vg = jax.jit(jax.value_and_grad(
        lambda p, b: _ref_loss(p, ref_cfg, b), has_aux=True))
    for weights in (ref_params, _fan_in(ref_params)):
        (ref_total, (ref_xent, ref_aux)), ref_grads = ref_vg(weights,
                                                             ref_batch)
        ref_grads = dict(flatten(jax.tree.map(np.asarray, ref_grads)))
        own = {}                     # the reference's own spread per leaf
        for k in ULPS:
            _, moved = ref_vg(_ulps(weights, k), ref_batch)
            for path, g in flatten(jax.tree.map(np.asarray, moved)):
                own[path] = max(own.get(path, 0.0),
                                _rel(g, ref_grads[path]))
        params = params_from_jax(jax.tree.map(np.asarray, weights), "cpu",
                                 specs=lm.build_specs(cfg))
        total, metrics, grads = _port_loss(params, cfg, batch, remat=True)
        assert _rel(total, ref_total) <= LOSS_TOL, arch
        assert _rel(metrics["xent"].detach(), ref_xent) <= LOSS_TOL, arch
        assert abs(float(metrics["aux"].detach()) - float(ref_aux)) \
            <= LOSS_TOL * max(abs(float(ref_aux)), 1.0), arch
        assert (float(ref_aux) > 0) == (cfg.n_experts > 0), arch
        for path, want in ref_grads.items():
            got = grads[path]
            if np.abs(want).max() == 0:       # unread (whisper's enc_pos)
                assert got is None or not bool(got.any()), path
                continue
            assert bool(torch.isfinite(got).all()), path
            assert _rel(got.numpy(), want) <= GRAD_TOL + own[path], \
                (arch, path)
    plain_total, _, plain_grads = _port_loss(params, cfg, batch, remat=False)
    assert torch.equal(plain_total, total), arch
    for path, g in plain_grads.items():
        if g is not None:
            assert _rel(g.numpy(), grads[path].numpy()) <= REMAT_TOL, path


@pytest.mark.parametrize("archs", [
    ("qwen3-1.7b", "gemma3-1b", "mixtral-8x7b"),
    ("mamba2-130m", "recurrentgemma-9b", "internvl2-26b", "whisper-tiny"),
], ids=["attention-moe", "recurrent-frontends"])
def test_forward_loss_and_grads_match_jax_f32(archs, ref_f32):
    """Every block kind, the encoder-decoder and the embeds frontend: the
    float32 loss within 1e-5 and every gradient leaf within 1e-3 of its
    scale, on the initializer's and on the fan-in weights; remat on and off
    agree within 1e-6."""
    for arch in archs:
        _check_arch(arch)


def test_bf16_forward_loss_matches_jax_on_qk_norm_stacks():
    """The public bfloat16 ``forward_loss`` of qwen3 and gemma3 (query/key
    norm) within 2e-2 (relative) of the JAX package's."""
    for arch in ("qwen3-1.7b", "gemma3-1b"):
        cfg = reduced(configs.get_config(arch))
        ref_cfg = reduced(ref_configs.get_config(arch))
        ref_params = ref_init_tree(jax.random.PRNGKey(0),
                                   ref_lm.build_specs(ref_cfg))
        batch = _batch(cfg)
        ref_total, ref_metrics = jax.jit(
            lambda p, b: ref_lm.forward_loss(p, ref_cfg, b))(
                ref_params, {"tokens": jnp.asarray(batch["tokens"])})
        params = params_from_jax(jax.tree.map(np.asarray, ref_params), "cpu")
        total, metrics = lm.forward_loss(
            params, cfg, {"tokens": torch.tensor(batch["tokens"])})
        assert total.dtype == torch.float32
        assert _rel(total, ref_total) <= BF16_TOL, arch
        assert _rel(metrics["xent"], ref_metrics["xent"]) <= BF16_TOL, arch


def test_grad_bf16_and_chunked_xent_match_jax():
    """``grad_bf16``: the forward is the identity; a bfloat16 input's
    gradient is the JAX package's bfloat16 cast of the incoming one, a
    float32 input's passes unchanged (the JAX package's is bfloat16 there,
    R10).  ``chunked_softmax_xent`` at chunk 16 < S = 64, its value and its
    gradients against the JAX package's."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 5)).astype(np.float32)
    g = rng.standard_normal((3, 5)).astype(np.float32)
    xb, gb = (jnp.asarray(a, jnp.bfloat16) for a in (x, g))
    _, vjp = jax.vjp(ref_layers.grad_bf16, xb)
    (want,) = vjp(gb)
    tb = torch.tensor(np.asarray(xb, np.float32), dtype=torch.bfloat16,
                      requires_grad=True)
    y = layers.grad_bf16(tb)
    assert torch.equal(y, tb)
    y.backward(torch.tensor(np.asarray(gb, np.float32), dtype=torch.bfloat16))
    assert tb.grad.dtype == torch.bfloat16
    assert np.array_equal(tb.grad.float().numpy(), np.asarray(want, np.float32))
    t = torch.tensor(x, requires_grad=True)
    layers.grad_bf16(t).backward(torch.tensor(g))
    assert torch.equal(t.grad, torch.tensor(g))
    _, vjp = jax.vjp(ref_layers.grad_bf16, jnp.asarray(x))
    assert vjp(jnp.asarray(g))[0].dtype == jnp.bfloat16      # R10

    xs = rng.standard_normal((2, 64, 16)).astype(np.float32)
    head = (rng.standard_normal((40, 16)) * 0.5).astype(np.float32)
    labels = rng.integers(0, 40, (2, 64)).astype(np.int32)
    mask = (labels > 0).astype(np.float32)
    ref_val, (ref_gx, ref_gh) = jax.value_and_grad(
        lambda a, h: ref_layers.chunked_softmax_xent(a, h, labels, mask,
                                                     chunk=16),
        argnums=(0, 1))(xs, head)
    tx = torch.tensor(xs, requires_grad=True)
    th = torch.tensor(head, requires_grad=True)
    val = layers.chunked_softmax_xent(tx, th, torch.tensor(labels),
                                      torch.tensor(mask), chunk=16)
    val.backward()
    assert _rel(val.detach(), ref_val) <= LOSS_TOL
    assert _rel(tx.grad.numpy(), ref_gx) <= GRAD_TOL
    assert _rel(th.grad.numpy(), ref_gh) <= GRAD_TOL
    with pytest.raises(ValueError, match="multiple"):
        layers.chunked_softmax_xent(tx, th, torch.tensor(labels),
                                    torch.tensor(mask), chunk=24)
