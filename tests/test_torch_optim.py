"""The port's optimizer, gradient compression and sharding rules against
the JAX package's.

- ``adamw``: ``apply_updates`` on identical trees, gradients and states
  (numpy from a seed), in float32 and with ``state_dtype="bfloat16"``;
  ``schedule`` at warmup, mid-run and the end; ``global_norm``.  Float32
  within 1e-6 (relative to each leaf's scale): the two frameworks round
  the same float32 formula; the bfloat16 moments within one bfloat16 ulp.
- ``compression``: the int8 payloads and scales equal the JAX package's,
  and error feedback beats none over repeated rounds (as
  ``tests/test_substrates.py`` checks it); ``compressed_all_reduce`` under
  a world-size-1 ``gloo`` group.
- ``resolve_spec`` / ``partition_specs_tree``: every parameter of every
  registry config on (16, 16) ``data``/``model`` and (2, 16, 16)
  ``pod``/``data``/``model`` meshes, the port's tuples equal to the JAX
  package's ``PartitionSpec``s (resolved against a stand-in mesh that has
  only ``axis_names`` and ``devices.shape``); and on those meshes the
  batch plans of ``train/step.py``, ``batch_struct`` and
  ``pick_microbatches``, for every config and shape cell.
"""
import socket
import types

import jax
import jax.numpy as jnp
import numpy as np
import torch
import torch.distributed as dist

from repro import configs as ref_configs
from repro.models import lm as ref_lm
from repro.optim import adamw as ref_adamw
from repro.parallel import compression as ref_comp
from repro.parallel import sharding as ref_shd
from repro.train import step as ref_step
from repro_torch import configs
from repro_torch.launch.mesh import Mesh
from repro_torch.models import lm
from repro_torch.models.specs import flatten, partition_specs_tree
from repro_torch.optim import adamw
from repro_torch.parallel import compression, sharding
from repro_torch.train import step

torch.set_num_threads(1)

F32_TOL = 1e-6


def _tree(rng, scale: float = 1.0) -> dict:
    """A small nested tree of float32 numpy leaves."""
    return {"embed": (rng.standard_normal((12, 8)) * scale).astype(np.float32),
            "pattern": {"b0": {"w": (rng.standard_normal((3, 8, 8))
                                     * scale).astype(np.float32),
                               "ln": (rng.standard_normal(8)
                                      * scale).astype(np.float32)}},
            "tail": {}}


def _torch(tree):
    return jax.tree.map(lambda a: torch.tensor(np.asarray(a, np.float32)),
                        tree)


def _close(got: dict, want, tol: float) -> None:
    want = dict(flatten(jax.tree.map(lambda a: np.asarray(a, np.float32),
                                     want)))
    for path, t in flatten(got):
        w = want[path]
        err = np.abs(t.float().numpy() - w).max() / max(np.abs(w).max(),
                                                         1e-30)
        assert err <= tol, (path, err)


def test_adamw_schedule_and_global_norm_match_jax():
    """Three AdamW steps from the same state, float32 and bfloat16
    moments; the schedule at warmup, mid-run and the end."""
    rng = np.random.default_rng(0)
    params, grads = _tree(rng), _tree(rng, 3.0)
    for state_dtype, tol in (("float32", F32_TOL), ("bfloat16", 2 ** -8)):
        cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=5,
                                state_dtype=state_dtype)
        ref_cfg = ref_adamw.AdamWConfig(lr=1e-2, warmup_steps=2,
                                        total_steps=5, state_dtype=state_dtype)
        p, opt = _torch(params), adamw.init(_torch(params), state_dtype)
        rp, ropt = params, ref_adamw.init(params, state_dtype)
        assert opt.m["embed"].dtype == {"float32": torch.float32,
                                        "bfloat16": torch.bfloat16}[state_dtype]
        for i in range(3):
            g = jax.tree.map(lambda a: a * (i + 1), grads)
            p, opt, m = adamw.apply_updates(cfg, p, _torch(g), opt)
            rp, ropt, rm = ref_adamw.apply_updates(ref_cfg, rp, g, ropt)
            _close(p, rp, F32_TOL)
            _close(opt.m, ropt.m, tol)
            _close(opt.v, ropt.v, tol)
            assert int(opt.step) == int(ropt.step) == i + 1
            assert abs(float(m["grad_norm"]) / float(rm["grad_norm"]) - 1) \
                <= F32_TOL
            assert abs(float(m["lr"]) - float(rm["lr"])) <= F32_TOL * 1e-2
    cfg = adamw.AdamWConfig(lr=3e-4, warmup_steps=10, total_steps=110)
    ref_cfg = ref_adamw.AdamWConfig(lr=3e-4, warmup_steps=10, total_steps=110)
    for step in (0, 5, 10, 60, 110, 200):
        got = float(adamw.schedule(cfg, torch.tensor(step)))
        want = float(ref_adamw.schedule(ref_cfg, jnp.asarray(step)))
        assert abs(got - want) <= 1e-6 * cfg.lr, step
    assert float(adamw.schedule(cfg, torch.tensor(60))) < cfg.lr
    assert abs(float(adamw.global_norm(_torch(grads)))
               / float(ref_adamw.global_norm(grads)) - 1) <= F32_TOL


def test_compression_payloads_and_error_feedback_match_jax():
    """int8 payloads and scales equal the JAX package's; with error
    feedback the mean of the dequantized rounds tracks the true gradient
    better than without (``tests/test_substrates.py``'s check)."""
    rng = np.random.default_rng(1)
    grads = _tree(rng, 1e-3)
    payload, res = compression.compress_with_feedback(_torch(grads), None)
    ref_payload, ref_res = ref_comp.compress_with_feedback(grads, None)
    ref_pairs = dict(flatten(ref_payload))          # (q, scale) leaves
    for path, (q, scale) in flatten(payload):
        rq, rs = ref_pairs[path]
        assert q.dtype == torch.int8
        assert np.array_equal(q.numpy(), np.asarray(rq)), path
        assert float(scale) == float(rs), path
    _close(res, ref_res, 1e-6)
    _close(compression.decompress(payload), ref_comp.decompress(ref_payload),
           1e-6)

    g = torch.tensor(rng.standard_normal(4096).astype(np.float32)) * 1e-3
    res, acc_fb, acc_plain = None, torch.zeros(4096), torch.zeros(4096)
    for _ in range(20):
        p, res = compression.compress_with_feedback({"g": g}, res)
        acc_fb += compression.decompress(p)["g"]
        acc_plain += compression.dequantize_int8(
            *compression.quantize_int8(g))
    err_fb = float((acc_fb / 20 - g).abs().mean())
    err_plain = float((acc_plain / 20 - g).abs().mean())
    assert err_fb < err_plain * 0.5, (err_fb, err_plain)


def test_compressed_all_reduce_world_size_one():
    """``compressed_all_reduce`` under a world-size-1 ``gloo`` group: the
    mean is the dequantized payload, the residuals those of
    ``compress_with_feedback``."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        grads = _torch(_tree(np.random.default_rng(2), 1e-2))
        mean, res = compression.compressed_all_reduce(grads, None)
        payload, want_res = compression.compress_with_feedback(grads, None)
        want = compression.decompress(payload)
        for (path, got), (_, w) in zip(flatten(mean), flatten(want)):
            assert torch.equal(got, w), path
        for (path, got), (_, w) in zip(flatten(res), flatten(want_res)):
            assert torch.equal(got, w), path
    finally:
        dist.destroy_process_group()


def _stand_in(axis_names, shape):
    """What the JAX package's resolver reads of a mesh."""
    return types.SimpleNamespace(axis_names=axis_names,
                                 devices=np.empty(shape, dtype=object),
                                 empty=False)


def test_partition_specs_match_jax_for_every_config():
    """Every parameter of every registry config on the single-pod and the
    two-pod production meshes; the batch plans of every shape cell."""
    meshes = [(("data", "model"), (16, 16)),
              (("pod", "data", "model"), (2, 16, 16))]
    assert sharding.rules_for_mesh(Mesh(*meshes[1])) \
        == ref_shd.rules_for_mesh(_stand_in(*meshes[1]))
    for name in configs.ARCH_NAMES:
        cfg, ref_cfg = configs.get_config(name), ref_configs.get_config(name)
        specs, ref_specs = lm.build_specs(cfg), ref_lm.build_specs(ref_cfg)
        for axes, sizes in meshes:
            mesh, ref_mesh = Mesh(axes, sizes), _stand_in(axes, sizes)
            got = dict(flatten(partition_specs_tree(specs, mesh),
                               is_leaf=lambda x: isinstance(x, tuple)))
            want = dict(flatten(jax.tree.map(
                lambda s: tuple(ref_shd.resolve_spec(s.shape, s.axes,
                                                     ref_mesh)),
                ref_specs, is_leaf=lambda x: hasattr(x, "axes")),
                is_leaf=lambda x: isinstance(x, tuple)))
            assert got == want, (name, axes)
            for cell in configs.shapes_for(cfg):
                shape, ref_shape = configs.SHAPES[cell], \
                    ref_configs.SHAPES[cell]
                assert step.pick_microbatches(cfg, shape, mesh) \
                    == ref_step.pick_microbatches(ref_cfg, ref_shape,
                                                  ref_mesh), (name, cell)
                plan = step.batch_struct(cfg, shape)
                ref_plan = ref_step.batch_struct(ref_cfg, ref_shape)
                assert {k: (tuple(v[0]), str(v[1]).split(".")[-1])
                        for k, v in plan.items()} \
                    == {k: (tuple(v.shape), str(v.dtype))
                        for k, v in ref_plan.items()}, (name, cell)
    assert sharding.constrain("x", ("batch",)) == "x"
