"""mamba2-130m at its published widths and depth (24 ``ssd`` layers,
d_model 768, state 128, vocab 50280), the port against the JAX package,
on the CPU.

Parameters come from the JAX package's ``init_tree(PRNGKey(0))`` and are
carried across with ``params_from_jax``; one prompt of 16 tokens from a
numpy seed, then 2 teacher-forced decode steps.  The stack has no
attention, so the reference initializer's query/key scale (ROADMAP R9)
does not touch it.

Tolerances.  In float32 (both packages' layer stacks, float32 caches)
the logits of the prefill and of each step agree within 1e-3 of their
scale, and the port's decode steps equal its own full pass over the same
prefix within 1e-3.  In bfloat16, through the public ``prefill`` /
``decode_step``, the two frameworks round at other places, so the port's
bfloat16 logits are held to the reference's float32 ones: no further
from them than the reference's own bfloat16 logits, plus 2e-2 of the
scale, at every step.  The second test holds ``init_cache``'s ``dtype``
to the K/V rings of published layouts.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as ref_configs
from repro.models import layers as ref_layers
from repro.models import lm as ref_lm
from repro.models.specs import init_tree as ref_init_tree
from repro_torch import configs
from repro_torch.models import lm
from repro_torch.models.specs import flatten, params_from_jax

torch.set_num_threads(1)

F32_TOL = 1e-3           # of the scale, float32
BF16_TOL = 2e-2          # of the logits' scale, bfloat16
PROMPT, STEPS = 16, 2


def _np(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _err(got, want) -> float:
    """Largest difference as a share of ``want``'s largest magnitude."""
    got, want = _np(got), _np(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def test_mamba2_published_width_matches_jax():
    """Prefill and decode at the published widths: float32 logits against
    the JAX package's and against the port's own full pass; bfloat16
    served logits within the reference's own bfloat16 distance of its
    float32 logits, plus 2e-2."""
    cfg = configs.get_config("mamba2-130m")
    ref_cfg = ref_configs.get_config("mamba2-130m")
    assert (cfg.d_model, cfg.n_layers, cfg.ssm_state) == (768, 24, 128)
    ref_params = ref_init_tree(jax.random.PRNGKey(0),
                               ref_lm.build_specs(ref_cfg))
    params = params_from_jax(jax.tree.map(np.asarray, ref_params), "cpu",
                             specs=lm.build_specs(cfg))
    tokens = np.random.default_rng(1).integers(1, cfg.vocab,
                                               (1, PROMPT + STEPS))
    table = np.asarray(ref_params["embed"])

    def ref_stack(p, x, c, start, cur):
        pos = jnp.arange(x.shape[1]) + start
        x, c, _ = ref_lm._run_stack(p, x, ref_cfg, positions=pos, caches=c,
                                    cur_index=cur)
        x = ref_layers.rms_norm(x, p["final_norm"], ref_cfg.norm_eps)
        return x[:, -1:] @ p["embed"].T, c

    ref_prefill = jax.jit(lambda p, x, c: ref_stack(p, x, c, 0, None))
    ref_decode = jax.jit(lambda p, x, c, i: ref_stack(p, x, c, i, i))
    seq = PROMPT + STEPS
    ref_caches = jax.tree.map(lambda a: a.astype(jnp.float32),
                              ref_lm.init_cache(ref_cfg, 1, seq))
    caches = lm.init_cache(cfg, 1, seq, "cpu", torch.float32)
    exact = []
    with torch.no_grad():
        for i in range(STEPS + 1):
            lo, hi = (0, PROMPT) if i == 0 else (PROMPT + i - 1, PROMPT + i)
            x = table[tokens[:, lo:hi]]
            if i == 0:
                want, ref_caches = ref_prefill(ref_params, x, ref_caches)
            else:
                want, ref_caches = ref_decode(ref_params, x, ref_caches,
                                              jnp.asarray(lo, jnp.int32))
            h, _ = lm._run_stack(params, torch.tensor(x), cfg,
                                 positions=torch.arange(lo, hi),
                                 caches=caches,
                                 cur_index=None if i == 0 else lo)
            got = lm._logits(params, cfg, h[:, -1:])
            assert _err(got, want) <= F32_TOL, i
            full, _ = lm.prefill(params, cfg,
                                 {"tokens": torch.tensor(tokens[:, :hi])},
                                 lm.init_cache(cfg, 1, seq, "cpu",
                                               torch.float32),
                                 dtype=torch.float32)
            assert _err(got, full) <= F32_TOL, i
            exact.append(want)

        ref_logits, ref_caches = jax.jit(
            lambda p, b, c: ref_lm.prefill(p, ref_cfg, b, c))(
                ref_params, {"tokens": jnp.asarray(tokens[:, :PROMPT])},
                ref_lm.init_cache(ref_cfg, 1, seq))
        compute = lm.cast_params(params)
        logits, caches = lm.prefill(
            compute, cfg, {"tokens": torch.tensor(tokens[:, :PROMPT])},
            lm.init_cache(cfg, 1, seq, "cpu"))
        served = [(logits, ref_logits)]
        ref_step = jax.jit(lambda p, t, c, i: ref_lm.decode_step(
            p, ref_cfg, t, c, i))
        for i in range(STEPS):
            pos = PROMPT + i
            ref_logits, ref_caches = ref_step(
                ref_params, jnp.asarray(tokens[:, pos:pos + 1]), ref_caches,
                jnp.asarray(pos, jnp.int32))
            logits, caches = lm.decode_step(
                compute, cfg, torch.tensor(tokens[:, pos:pos + 1]), caches,
                pos)
            served.append((logits, ref_logits))
    for i, ((got, ref), want) in enumerate(zip(served, exact)):
        assert bool(torch.isfinite(got.float()).all()), i
        assert _err(got, want) <= _err(ref, want) + BF16_TOL, i


def test_cache_dtype_sets_kv_rings_only():
    """``init_cache(..., dtype)`` at published layouts: K/V rings (the
    ``swa`` layers of recurrentgemma-9b, whisper-tiny's self and cross
    caches) take ``dtype``; the ``rglru`` and ``ssd`` states stay float32
    whatever it is."""
    for arch in ("recurrentgemma-9b", "whisper-tiny", "mamba2-130m"):
        cfg = configs.get_config(arch)
        for dtype in (torch.bfloat16, torch.float32):
            caches = lm.init_cache(cfg, 2, 16, "cpu", dtype)
            for path, leaf in flatten(caches):
                kv = path.rsplit("/", 1)[-1] in ("k", "v", "ck", "cv")
                assert leaf.dtype == (dtype if kv else torch.float32), path
