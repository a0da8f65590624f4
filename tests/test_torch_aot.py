"""The port's AOT half against the JAX package's: bundles, model FLOPs and
the dry run's cost counter.

- ``aot_bundle``: for every (arch x shape) cell of ``configs.SHAPES`` /
  ``shapes_for`` on the 16 x 16 and 2 x 16 x 16 production meshes, the
  arguments' shapes and dtypes (the port's ``meta`` tensors, the JAX
  package's ``ShapeDtypeStruct``s) and the input and output partition
  specs equal the JAX package's bundle, built on a stand-in mesh (only
  ``axis_names`` and ``devices.shape``) with ``NamedSharding`` replaced by
  a holder of its spec, and never compiled.
- ``model_flops`` equals the JAX package's in every cell.
- The counter (``launch.cost_analysis``) on a reduced dense train step:
  its product FLOPs equal ``torch.utils.flop_counter.FlopCounterMode``'s
  on the same step on CPU tensors, its own count on ``meta`` tensors, and
  the analytic sum of 2·M·N·K over the step's products (forward, the
  backward's two products per product, remat's second forward, which
  ``torch.utils.checkpoint`` stops once the saved tensors are back: each
  pattern unit's last product is not recomputed).
- Its product FLOPs grow linearly with the repeats of the pattern, and
  so do the rest once the stacked leaves' gradient sums (R² x P element
  adds, below) are taken out; a loop of matmuls counts 2·m³ per trip (the
  JAX package's walker test, ``tests/test_properties.py``, as eager
  execution runs every trip).
"""
import types

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro import configs as ref_configs
from repro.parallel import sharding as ref_shd
from repro.train import step as ref_step
from repro_torch import configs
from repro_torch.configs import BlockCfg, ModelConfig
from repro_torch.launch import dryrun
from repro_torch.launch.cost_analysis import count_cost
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import lm
from repro_torch.models.specs import abstract_tree, count_params, init_tree
from repro_torch.optim import adamw
from repro_torch.train.step import aot_bundle, make_train_step

torch.set_num_threads(1)

MESHES = ((("data", "model"), (16, 16)),
          (("pod", "data", "model"), (2, 16, 16)))


class _Spec:
    """What the JAX package's ``NamedSharding(mesh, spec)`` names."""

    def __init__(self, mesh, spec):
        self.spec = tuple(spec)


def _stand_in(axis_names, shape):
    return types.SimpleNamespace(axis_names=axis_names,
                                 devices=np.empty(shape, dtype=object),
                                 empty=False)


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and not hasattr(x, "_fields") and all(
        e is None or isinstance(e, str)
        or (isinstance(e, tuple) and all(isinstance(a, str) for a in e))
        for e in x)


def _flat(tree, prefix: str = "") -> dict:
    """path -> leaf over dicts, tuples and NamedTuples (``None`` and spec
    tuples are leaves); tensors and ``ShapeDtypeStruct``s as (shape,
    dtype name), specs as tuples."""
    if isinstance(tree, _Spec):
        return {prefix: tree.spec}
    if tree is None or _is_spec(tree):
        return {prefix: tree}
    if isinstance(tree, dict):
        items = [(str(k), v) for k, v in tree.items()]
    elif isinstance(tree, tuple):
        items = ([(f".{f}", getattr(tree, f)) for f in tree._fields]
                 if hasattr(tree, "_fields") else
                 [(str(i), v) for i, v in enumerate(tree)])
    else:
        return {prefix: (tuple(tree.shape),
                         str(tree.dtype).removeprefix("torch."))}
    out = {}
    for key, child in items:
        out.update(_flat(child, f"{prefix}/{key}" if prefix else key))
    return out


def test_aot_bundles_match_jax_in_every_cell(monkeypatch):
    monkeypatch.setattr(ref_shd, "NamedSharding", _Spec)
    monkeypatch.setattr(ref_step, "NamedSharding", _Spec)
    cells = 0
    for name in configs.ARCH_NAMES:
        cfg, ref_cfg = configs.get_config(name), ref_configs.get_config(name)
        for multi, (axes, sizes) in enumerate(MESHES):
            mesh = make_production_mesh(multi_pod=bool(multi))
            assert (mesh.axis_names, mesh.shape) == (axes, sizes)
            ref_mesh = _stand_in(axes, sizes)
            for cell in configs.shapes_for(cfg):
                got = aot_bundle(cfg, configs.SHAPES[cell], mesh)
                want = ref_step.aot_bundle(ref_cfg, ref_configs.SHAPES[cell],
                                           ref_mesh)
                for key in ("args", "in_shardings", "out_shardings"):
                    assert _flat(got[key]) == _flat(want[key]), \
                        (name, cell, axes, key)
                assert all(t.is_meta for t in _leaves(got["args"]))
                cells += 1
    assert cells == 2 * sum(len(configs.shapes_for(c))
                            for c in configs.REGISTRY.values())


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    return [t for c in tree for t in _leaves(c)]


def test_model_flops_match_jax_in_every_cell(monkeypatch):
    # the JAX package's dry run forces 512 host devices into XLA_FLAGS on
    # import; the monkeypatch puts the variable back afterwards
    monkeypatch.setenv("XLA_FLAGS", "")
    from repro.launch import dryrun as ref_dryrun

    for arch, cell in dryrun.all_cells():
        got = dryrun.model_flops(configs.get_config(arch),
                                 configs.SHAPES[cell])
        want = ref_dryrun.model_flops(ref_configs.get_config(arch),
                                      ref_configs.SHAPES[cell])
        assert got == want, (arch, cell)
    assert dryrun.all_cells() == ref_dryrun.all_cells()


def _dense(**kw) -> ModelConfig:
    base = dict(name="t", family="dense", d_model=32, n_heads=4,
                n_kv_heads=2, head_dim=8, d_ff=64, vocab=128,
                pattern=(BlockCfg("attn"),), repeats=2)
    base.update(kw)
    return ModelConfig(**base)


def _meta_step_cost(cfg, batch: int, seq: int):
    params = abstract_tree(lm.build_specs(cfg))
    tokens = torch.empty(batch, seq, dtype=torch.int32, device="meta")
    return count_cost(make_train_step(cfg, adamw.AdamWConfig()), params,
                      adamw.abstract_state(params), {"tokens": tokens})[1]


def test_counter_products_are_the_analytic_sum_and_flop_counter_modes():
    cfg, b, s = _dense(), 2, 16
    step = make_train_step(cfg, adamw.AdamWConfig())
    params = init_tree(0, lm.build_specs(cfg), "cpu")
    tokens = torch.tensor(np.random.default_rng(0).integers(
        1, cfg.vocab, (b, s)), dtype=torch.int32)
    _, cost = count_cost(step, params, adamw.init(params),
                         {"tokens": tokens})
    with FlopCounterMode(display=False) as fc:
        step(params, adamw.init(params), {"tokens": tokens})
    meta = _meta_step_cost(cfg, b, s)

    t, d, hd, f = b * s, cfg.d_model, cfg.head_dim, cfg.d_ff
    layer = (2 * t * d * hd * (2 * cfg.n_heads + 2 * cfg.n_kv_heads)
             + 2 * 2 * b * cfg.n_heads * s * s * hd      # scores, values
             + 3 * 2 * t * d * f)                         # gate, up, down
    head = 2 * t * d * cfg.vocab
    forward = cfg.repeats * layer + head
    # forward + backward (two products each) + remat's second forward,
    # less each unit's down projection, which checkpointing never redoes
    analytic = 4 * forward - cfg.repeats * 2 * t * f * d
    assert cost.product_flops == analytic
    assert cost.product_flops == fc.get_total_flops()
    assert (meta.product_flops, meta.flops, meta.bytes,
            meta.peak_live_bytes) == (cost.product_flops, cost.flops,
                                      cost.bytes, cost.peak_live_bytes)
    assert 0 < cost.product_flops < cost.flops and cost.bytes > 0


def test_counter_flops_grow_linearly_with_repeats_and_trips():
    """Products grow linearly with the repeats.  So does every other FLOP
    but one term: each repeat's gradient reaches its stacked leaves through
    ``select``'s backward as a full stacked-size tensor, and autograd adds
    the repeats' tensors, R adds of R x P elements (P the parameters of
    one unit).  Less R² x P, the count is linear."""
    repeats = (1, 2, 3, 5)
    costs = [_meta_step_cost(_dense(repeats=r), 2, 16) for r in repeats]
    unit = count_params(lm.build_specs(_dense(repeats=1))["pattern"])
    for field, quad in (("product_flops", 0), ("flops", unit)):
        f = [getattr(c, field) - quad * r * r for c, r in zip(costs, repeats)]
        per_unit = f[1] - f[0]
        assert per_unit > 0, field
        assert (f[2] - f[1], f[3] - f[2]) == (per_unit, 2 * per_unit), field

    for trips, m in ((1, 128), (5, 256), (12, 128)):
        a = torch.empty(m, m, device="meta")
        xs = torch.empty(trips, m, m, device="meta")

        def loop(a, xs):
            for i in range(xs.shape[0]):
                a = a @ xs[i]
            return a

        assert count_cost(loop, a, xs)[1].flops == 2.0 * m ** 3 * trips
