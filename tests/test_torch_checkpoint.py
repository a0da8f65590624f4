"""The port's checkpoints and XOR deltas against the JAX package's.

Both packages write ``step_XXXXXXXX/arrays.npz`` keyed by the ``/``-joined
leaf path, so each restores what the other wrote.  The XOR delta views
every leaf as flat 32-bit words and folds the two word tensors through
the backend's ``reduce((base, new), "xor")``, with no stacking: its words
must equal the JAX package's word for word (the JAX side runs its Pallas
kernel in interpret mode), and base XOR delta must give the new tree back
bit for bit.

A bfloat16 leaf is written as the JAX package writes it (``|V2`` records
of its bits, the npz entry equal in key, dtype and bytes); the port
restores the JAX package's bfloat16 checkpoints, and a ``TrainLoop`` with
bfloat16 AdamW moments checkpoints, is preempted and resumes bit-exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as ref_ckpt
from repro import configs as ref_configs
from repro.models import lm as ref_lm
from repro.models.specs import init_tree as ref_init_tree
from repro_torch import checkpoint as ckpt
from repro_torch import configs
from repro_torch.api.backends import Backend
from repro_torch.models import lm
from repro_torch.models.specs import (flatten, params_from_jax,
                                      params_to_numpy)
from repro_torch.optim import AdamWConfig
from repro_torch.train.loop import LoopConfig, TrainLoop

torch.set_num_threads(1)


def _tree(seed: int = 0) -> dict:
    """Mixed dtypes and sizes, one leaf whose bytes are not a multiple of
    4 (its last word is zero-padded)."""
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn(3, 5, generator=g),
            "opt": {"m": torch.randn(700, generator=g).double(),
                    "step": torch.tensor(7, dtype=torch.int32),
                    "mask": torch.randint(0, 2, (7,), generator=g,
                                          dtype=torch.uint8)}}


def _equal_bits(a: dict, b: dict) -> bool:
    fa, fb = dict(flatten(a)), dict(flatten(b))
    return fa.keys() == fb.keys() and all(
        fa[k].dtype == fb[k].dtype and fa[k].shape == fb[k].shape
        and torch.equal(fa[k].reshape(-1).view(torch.uint8),
                        fb[k].reshape(-1).view(torch.uint8)) for k in fa)


def test_save_restore_and_retention(tmp_path):
    tree = _tree()
    assert ckpt.latest_step(tmp_path / "none") is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore(tmp_path / "none", tree)
    for step in (1, 5, 9, 12):
        final = ckpt.save(tmp_path, step, _tree(step), keep=2)
        assert final.name == f"step_{step:08d}"
    assert sorted(p.name for p in tmp_path.iterdir()) == \
        ["step_00000009", "step_00000012"]
    assert ckpt.latest_step(tmp_path) == 12
    got, step = ckpt.restore(tmp_path, tree)
    assert step == 12 and _equal_bits(got, _tree(12))
    got, _ = ckpt.restore(tmp_path, tree, step=9)
    assert _equal_bits(got, _tree(9))
    with pytest.raises(ValueError, match="structure"):
        ckpt.restore(tmp_path, {"w": tree["w"]})


def test_checkpoints_cross_between_packages(tmp_path):
    """A JAX-written checkpoint of a reduced gemma3-style model restores
    into the port, and the port's checkpoint restores into the JAX
    package, leaf for leaf."""
    cfg = configs.get_config("gemma3-1b")
    small = dict(d_model=32, n_heads=2, n_kv_heads=1, head_dim=16, d_ff=64,
                 vocab=128, repeats=1, tail=())
    ref_cfg = ref_configs.get_config("gemma3-1b")
    cfg = dataclasses.replace(cfg, **small)
    ref_cfg = dataclasses.replace(ref_cfg, **small)
    ref_params = ref_init_tree(jax.random.PRNGKey(0),
                               ref_lm.build_specs(ref_cfg))
    ref_ckpt.save(tmp_path / "jax", 3, ref_params)
    like = params_from_jax(jax.tree.map(np.asarray, ref_params), "cpu",
                           specs=lm.build_specs(cfg))
    got, step = ckpt.restore(tmp_path / "jax", like)
    assert step == 3
    want = jax.tree.map(np.asarray, ref_params)
    for path, leaf in flatten(got):
        node = want
        for key in path.split("/"):
            node = node[key]
        np.testing.assert_array_equal(leaf.numpy(), node)

    ckpt.save(tmp_path / "port", 4, got)
    back, step = ref_ckpt.restore(tmp_path / "port", ref_params)
    assert step == 4
    jax.tree.map(np.testing.assert_array_equal,
                 jax.tree.map(np.asarray, back), want)
    assert (tmp_path / "port" / "step_00000004" / "manifest.json").read_text() \
        .count("PyTreeDef(") == 1
    jax.tree.map(np.testing.assert_array_equal, params_to_numpy(got), want)


def test_delta_words_equal_jax_and_round_trip(monkeypatch):
    """The port's delta words equal the JAX package's word for word, every
    XOR goes through ``Backend.reduce``, and base XOR delta gives the new
    tree back bit for bit."""
    base, new = _tree(1), _tree(1)
    new["w"][1, 2] += 1.0
    new["opt"]["m"][::7] *= -1.0
    new["opt"]["mask"][3] ^= 1
    calls = []
    real = Backend.reduce

    def counted(self, operands, op, invert=False, out=None):
        calls.append((tuple(tuple(t.shape) for t in operands), op))
        return real(self, operands, op, invert, out=out)

    monkeypatch.setattr(Backend, "reduce", counted)
    delta = ckpt.delta_encode(base, new)
    leaves = flatten(base)
    n_leaves = len(leaves)
    # each leaf's own words, ceil(bytes / 4) of them, two operands, "xor"
    leaf_words = sorted(((leaf.numel() * leaf.element_size() + 3) // 4,)
                        for _, leaf in leaves)
    assert sorted(calls) == [((w, w), "xor") for w in leaf_words]

    to_np = lambda t: t.numpy()                                # noqa: E731
    ref_delta = ref_ckpt.delta_encode(jax.tree.map(to_np, base,
                                                   is_leaf=torch.is_tensor),
                                      jax.tree.map(to_np, new,
                                                   is_leaf=torch.is_tensor))
    for path, words in flatten(delta):
        node = ref_delta
        for key in path.split("/"):
            node = node[key]
        assert words.dtype == torch.int32
        np.testing.assert_array_equal(words.numpy().view(np.uint32),
                                      np.asarray(node))
    assert ckpt.delta_sparsity(delta) == pytest.approx(
        ref_ckpt.delta_sparsity(ref_delta))
    assert 0 < ckpt.delta_sparsity(delta) < 1

    back = ckpt.delta_apply(base, delta)
    assert sorted(calls[n_leaves:]) == [((w, w), "xor") for w in leaf_words]
    assert _equal_bits(back, new)
    assert _equal_bits(ckpt.delta_apply(base, ckpt.delta_encode(base, base)),
                       base)


def _npz_entries(path) -> dict:
    with np.load(path) as data:
        return {k: (data[k].dtype.str, data[k].shape, data[k].tobytes())
                for k in data.files}


def test_bfloat16_checkpoints_match_jax_and_resume(tmp_path):
    """bfloat16 leaves: the npz entries equal the JAX package's; the port
    restores the JAX package's bfloat16 checkpoint (which the JAX package
    itself cannot read back, ROADMAP R11); a ``TrainLoop`` with bfloat16
    moments is preempted after a checkpoint and resumes bit-exact, its
    losses the uninterrupted run's."""
    rng = np.random.default_rng(3)
    host = {"m": rng.standard_normal((4, 6)).astype(np.float32),
            "w": rng.standard_normal(5).astype(np.float32)}
    ref_tree = {"m": jnp.asarray(host["m"], jnp.bfloat16),
                "w": jnp.asarray(host["w"])}
    tree = {"m": torch.tensor(host["m"]).to(torch.bfloat16),
            "w": torch.tensor(host["w"])}
    ref_ckpt.save(tmp_path / "jax", 1, ref_tree)
    ckpt.save(tmp_path / "port", 1, tree)
    got = _npz_entries(tmp_path / "port" / "step_00000001" / "arrays.npz")
    want = _npz_entries(tmp_path / "jax" / "step_00000001" / "arrays.npz")
    assert got == want and got["m"][0] == "|V2"
    back, step = ckpt.restore(tmp_path / "jax", tree)
    assert step == 1 and _equal_bits(back, tree)
    assert back["m"].dtype == torch.bfloat16

    cfg = dataclasses.replace(
        configs.get_config("gemma3-1b"), d_model=32, n_heads=2, n_kv_heads=1,
        head_dim=16, d_ff=64, vocab=128, repeats=1, tail=())
    opt_cfg = AdamWConfig(lr=3e-3, warmup_steps=1, total_steps=6,
                          state_dtype="bfloat16")

    def loop(d):
        return TrainLoop(cfg, LoopConfig(total_steps=6, ckpt_every=2,
                                         ckpt_dir=str(tmp_path / d),
                                         log_every=0),
                         opt_cfg=opt_cfg, global_batch=2, seq_len=32,
                         device="cpu")

    whole = loop("whole").run()
    first = loop("cut")
    data_at = first.batch_fn

    def preempting(step):
        if step == 2:
            first.request_preemption()
        return data_at(step)

    first.batch_fn = preempting
    res1 = first.run()
    assert res1["last_step"] == 3 and res1["opt"].m["embed"].dtype \
        == torch.bfloat16
    second = loop("cut")
    params, opt, start = second.restore_or_init()
    assert start == 3
    assert _equal_bits({"p": params, "m": opt.m, "v": opt.v, "s": opt.step},
                       {"p": res1["params"], "m": res1["opt"].m,
                        "v": res1["opt"].v, "s": res1["opt"].step})
    res2 = second.run()
    assert [m["loss"] for m in res2["metrics"]] \
        == [m["loss"] for m in whole["metrics"][3:]]
    assert _equal_bits(res2["params"], whole["params"])
