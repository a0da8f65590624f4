"""The port's token pipeline, train step and fault-tolerant loop against
the JAX package's, and the training example on the CPU.

- ``TokenPipeline``: a batch is a pure function of (seed, step), equal
  over pipelines and after a restart; its statistics over 64 x 512 tokens
  match the JAX package's (which draws other bits: ``jax.random`` cannot
  be replayed) within 5 standard errors of the sampled quantity.
- ``make_train_step`` in float32 (``dtype=torch.float32``) on a reduced
  qwen3 config against the JAX package's AdamW update of its own float32
  gradients (its internals, as in ``tests/test_torch_train_loss.py``): the
  loss within 1e-5, the gradient norm within 1e-5 and the first moment
  ``m = 0.1 * g`` within 1e-3 of its scale.  The first AdamW step moves a
  parameter by ``lr * (sign(g) + weight_decay * p)`` wherever ``|g|``
  dwarfs ``eps``, whatever ``|g|`` is: an element whose gradient is near
  zero and differs in sign between the two packages moves the other way,
  so the new parameters are held within ``2 * lr`` of the reference's, and
  within 1e-6 where the signs agree and ``|g| > 1e-6``.
  ``microbatches=2`` against 1 on the same batch: the loss and gradient
  norm within 1e-5 in float32, and the gradient norm within 2e-2 in
  bfloat16; a batch of 5 at ``microbatches=2`` raises ``ValueError``.
  The prefill and decode step factories serve the same model.
- ``TrainLoop``: the loss drops (``tests/test_substrates.py``'s check), a
  preempted run resumes at its step with the uninterrupted run's losses,
  the straggler watchdog fires, and a checkpoint of ``(params,
  OptState)`` written by either package's loop restores in the other's.
"""
import runpy
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.configs.base import BlockCfg as RefBlockCfg
from repro.configs.base import ModelConfig as RefModelConfig
from repro.data import DataConfig as RefDataConfig
from repro.data import TokenPipeline as RefTokenPipeline
from repro.models import lm as ref_lm
from repro.models import moe as ref_moe
from repro.models.specs import init_tree as ref_init_tree
from repro.optim import adamw as ref_adamw
from repro.train.loop import LoopConfig as RefLoopConfig
from repro.train.loop import TrainLoop as RefTrainLoop
from repro_torch import configs
from repro_torch.checkpoint import latest_step
from repro_torch.configs.base import BlockCfg, ModelConfig
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.models import lm
from repro_torch.models.specs import flatten, params_from_jax
from repro_torch.optim import AdamWConfig, adamw
from repro_torch.train.loop import LoopConfig, TrainLoop
from repro_torch.train.step import (make_decode_step, make_prefill_step,
                                    make_train_step)
from test_torch_lm_archs import reduced
from test_torch_train_loss import _ref_loss

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
F32_TOL = 1e-5
GRAD_TOL = 1e-3
BF16_TOL = 2e-2


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def test_token_pipeline_deterministic_resumable_and_matched():
    cfg = DataConfig(vocab=4096, seq_len=512, global_batch=64, seed=3)
    p1, p2 = TokenPipeline(cfg), TokenPipeline(cfg)
    for step in (0, 5, 117):
        assert torch.equal(p1.batch_at(step)["tokens"],
                           p2.batch_at(step)["tokens"])
    assert not torch.equal(p1.batch_at(1)["tokens"], p1.batch_at(2)["tokens"])
    it = iter(p1)
    assert all(torch.equal(next(it)["tokens"], p2.batch_at(s)["tokens"])
               for s in range(3))
    got = p1.batch_at(7)["tokens"].numpy()
    want = np.asarray(RefTokenPipeline(RefDataConfig(
        vocab=4096, seq_len=512, global_batch=64, seed=3)).batch_at(7)
        ["tokens"])
    assert got.shape == want.shape and got.dtype == want.dtype == np.int32
    assert got.min() >= 1 and got.max() <= 4095

    def stats(t):
        follows = t[:, 1:] == (t[:, :-1] * 31 + 7) % 4095 + 1
        return {"first column mean": t[:, 0].astype(float),
                "token 1 share": (t == 1).astype(float).ravel(),
                "below V/8 share": (t < 512).astype(float).ravel(),
                "bigram share": follows.astype(float).ravel()}

    for name, a in stats(got).items():
        b = stats(want)[name]
        se = np.sqrt(a.var() / a.size + b.var() / b.size)
        assert abs(a.mean() - b.mean()) <= 5 * se, (name, a.mean(), b.mean())


def _qwen3():
    cfg = reduced(configs.get_config("qwen3-1.7b"))
    ref_cfg = reduced(ref_configs.get_config("qwen3-1.7b"))
    ref_params = ref_init_tree(jax.random.PRNGKey(0),
                               ref_lm.build_specs(ref_cfg))
    params = params_from_jax(jax.tree.map(np.asarray, ref_params), "cpu",
                             specs=lm.build_specs(cfg))
    return cfg, ref_cfg, params, ref_params


def test_train_step_matches_jax_f32_and_microbatches(monkeypatch):
    for mod in (ref_lm, ref_moe):            # float32 meaning (R10)
        monkeypatch.setattr(mod, "grad_bf16", lambda x: x)
    cfg, ref_cfg, params, ref_params = _qwen3()
    tokens = np.random.default_rng(5).integers(1, cfg.vocab,
                                               (4, 64)).astype(np.int32)
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    opt_cfg, ref_opt_cfg = AdamWConfig(**kw), ref_adamw.AdamWConfig(**kw)
    (ref_loss, _), ref_grads = jax.value_and_grad(
        lambda p: _ref_loss(p, ref_cfg, {"tokens": jnp.asarray(tokens)}),
        has_aux=True)(ref_params)
    ref_new, ref_opt, ref_m = ref_adamw.apply_updates(
        ref_opt_cfg, ref_params, ref_grads, ref_adamw.init(ref_params))
    batch = {"tokens": torch.tensor(tokens)}
    step = make_train_step(cfg, opt_cfg, dtype=torch.float32)
    new, opt, m = step(params, adamw.init(params), batch)
    assert _rel(m["loss"], ref_loss) <= F32_TOL
    assert _rel(m["grad_norm"], ref_m["grad_norm"]) <= F32_TOL
    assert int(opt.step) == 1 and float(m["lr"]) == pytest.approx(
        float(ref_m["lr"]))
    ref_new = dict(flatten(jax.tree.map(np.asarray, ref_new)))
    ref_mom = dict(flatten(jax.tree.map(np.asarray, ref_opt.m)))
    ref_g = dict(flatten(jax.tree.map(np.asarray, ref_grads)))
    mom = dict(flatten(opt.m))
    for path, p in flatten(new):
        assert _rel(mom[path], ref_mom[path]) <= GRAD_TOL, path
        diff = np.abs(p.numpy() - ref_new[path])
        assert diff.max() <= 2 * opt_cfg.lr * (1 + 1e-4), path
        agree = (np.sign(mom[path].numpy()) == np.sign(ref_mom[path])) \
            & (np.abs(ref_g[path]) > 1e-6)
        assert diff[agree].max(initial=0) <= 1e-6, path
    assert not torch.equal(new["embed"], params["embed"])     # inputs kept

    two = make_train_step(cfg, opt_cfg, microbatches=2, dtype=torch.float32)
    _, opt2, m2 = two(params, adamw.init(params), batch)
    assert _rel(m2["loss"], m["loss"]) <= F32_TOL
    assert _rel(m2["grad_norm"], m["grad_norm"]) <= F32_TOL
    for (path, a), (_, b) in zip(flatten(opt2.m), flatten(opt.m)):
        assert _rel(a, b) <= GRAD_TOL, path
    caches = lm.init_cache(cfg, 4, 96, "cpu")
    logits, caches = make_prefill_step(cfg, None)(params, batch, caches)
    want, _ = lm.prefill(params, cfg, batch, lm.init_cache(cfg, 4, 96, "cpu"))
    assert torch.equal(logits, want)
    nxt = {"tokens": logits.argmax(-1), "cur_index": torch.tensor(64)}
    logits, _ = make_decode_step(cfg, None)(params, nxt, caches)
    assert logits.shape == (4, 1, cfg.vocab)
    _, _, mb1 = make_train_step(cfg, opt_cfg)(params, adamw.init(params),
                                              batch)
    _, _, mb2 = make_train_step(cfg, opt_cfg, microbatches=2)(
        params, adamw.init(params), batch)
    assert set(mb2) == {"loss", "grad_norm", "lr"}
    assert _rel(mb2["grad_norm"], mb1["grad_norm"]) <= BF16_TOL
    # a batch that the microbatches do not divide raises, as the JAX
    # package's reshape does: no step trains on a prefix of the batch
    five = {"tokens": batch["tokens"][:, :16].repeat(2, 1)[:5]}
    with pytest.raises(ValueError, match="does not divide"):
        make_train_step(cfg, opt_cfg, microbatches=2)(
            params, adamw.init(params), five)


def _state(params, opt) -> dict:
    """``(params, OptState)`` as path -> tensor, keyed as a checkpoint."""
    out = {f"0/{k}": t for k, t in flatten(params)}
    out["1/.step"] = opt.step
    for field in ("m", "v"):
        out.update({f"1/.{field}/{k}": t
                    for k, t in flatten(getattr(opt, field))})
    return out


def _tiny(pkg_block, pkg_model, **kw):
    base = dict(name="t", family="dense", d_model=32, n_heads=2,
                n_kv_heads=2, head_dim=16, d_ff=64, vocab=128,
                pattern=(pkg_block("attn"),), repeats=2)
    base.update(kw)
    return pkg_model(**base)


def test_train_loop_trains_preempts_resumes_and_crosses_packages(tmp_path):
    cfg = _tiny(BlockCfg, ModelConfig, vocab=256)
    loop = TrainLoop(cfg, LoopConfig(total_steps=40, ckpt_every=50,
                                     ckpt_dir=str(tmp_path / "drop"),
                                     log_every=0),
                     opt_cfg=AdamWConfig(lr=3e-3, warmup_steps=5,
                                         total_steps=40),
                     global_batch=4, seq_len=64, device="cpu")
    losses = [m["loss"] for m in loop.run()["metrics"]]
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.1

    cfg = _tiny(BlockCfg, ModelConfig)

    def mk(d):
        return TrainLoop(cfg, LoopConfig(total_steps=12, ckpt_every=4,
                                         ckpt_dir=str(tmp_path / d),
                                         log_every=0),
                         global_batch=2, seq_len=32, device="cpu")

    whole = mk("whole").run()
    loop1 = mk("cut")
    real = loop1.batch_fn

    def killing_batch(step):
        if step == 6:
            loop1.request_preemption()
        return real(step)

    loop1.batch_fn = killing_batch
    res1 = loop1.run()
    assert res1["last_step"] == 7 and latest_step(tmp_path / "cut") == 7
    loop2 = mk("cut")
    params, opt, start = loop2.restore_or_init()
    assert start == 7
    saved = _state(res1["params"], res1["opt"])
    for path, t in _state(params, opt).items():
        assert torch.equal(t, saved[path]), path
    res2 = loop2.run()
    assert res2["last_step"] == 12 and res2["metrics"][0]["step"] == 7
    for got, want in zip(res2["metrics"], whole["metrics"][7:]):
        assert got["step"] == want["step"]
        assert got["loss"] == pytest.approx(want["loss"], rel=1e-6)

    slow = mk("slow")
    slow._simulate_slow_step = 9
    assert 9 in slow.run()["stragglers"]

    # the JAX package's loop restores the port's checkpoint of step 12 ...
    ref_cfg = _tiny(RefBlockCfg, RefModelConfig)
    ref_loop = RefTrainLoop(ref_cfg, RefLoopConfig(
        total_steps=14, ckpt_every=2, ckpt_dir=str(tmp_path / "cut"),
        log_every=0), global_batch=2, seq_len=32)
    ref_params, ref_opt, ref_start = ref_loop.restore_or_init()
    assert ref_start == 12
    want = _state(res2["params"], res2["opt"])
    got = jax.tree_util.tree_flatten_with_path((ref_params, ref_opt))[0]
    assert len(got) == len(want)
    for path, leaf in got:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        assert np.array_equal(np.asarray(leaf), want[key].numpy()), key
    # ... trains on from it and writes step 14, which the port's restores
    ref_res = ref_loop.run()
    assert ref_res["last_step"] == 14
    params, opt, start = mk("cut").restore_or_init()
    assert start == 14 and int(opt.step) == 14
    got = _state(params, opt)
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            (ref_res["params"], ref_res["opt"]))[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        assert np.array_equal(got.pop(key).numpy(), np.asarray(leaf)), key
    assert not got


def test_train_example_runs_on_cpu(monkeypatch, capsys, tmp_path):
    """``examples/torch_train_lm.py --device cpu --tiny`` for 6 steps: the
    in-flash shard count equals numpy's, the loss is finite, the XOR delta
    of the whole tree round-trips bit for bit."""
    monkeypatch.setattr(sys, "argv", [
        "torch_train_lm.py", "--device", "cpu", "--tiny", "--steps", "6",
        "--ckpt-dir", str(tmp_path)])
    runpy.run_path(str(ROOT / "examples" / "torch_train_lm.py"),
                   run_name="__main__")
    out = capsys.readouterr().out
    assert "kept 122002/131072 corpus shards" in out
    assert "bit-exact=True" in out and "step 2 -> 6" in out
