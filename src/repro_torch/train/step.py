"""Train / prefill / decode step factories and the AOT bundles.

The JAX package's ``train/step.py``.  A train step takes the gradients of
``forward_loss`` with ``torch.autograd.grad`` (nothing is left in
``.grad``) and applies one AdamW update; with ``microbatches > 1`` it
accumulates the microbatches' gradients inside the step, so the global
batch is honoured without the activation memory of all of it at once.

The AOT half: the JAX package lowers a step on ``ShapeDtypeStruct``s with
``NamedSharding``s.  Here :func:`aot_bundle` gives the step function, its
arguments as ``meta`` tensors (shapes and dtypes, no storage) and the
partition-spec trees of its inputs and outputs on a mesh descriptor;
``launch/dryrun.py`` runs the function on those tensors under a counter
of FLOPs, bytes and live memory (``launch/cost_analysis.py``).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeCfg
from repro_torch.launch.mesh import Mesh
from repro_torch.models import lm
from repro_torch.models.specs import (abstract_tree, count_params, flatten,
                                     map_with_path, shardings_tree, tree_map)
from repro_torch.optim import adamw
from repro_torch.parallel import sharding as shd

__all__ = ["batch_struct", "batch_shardings",
           "make_train_step", "make_prefill_step", "make_decode_step",
           "data_parallel_size", "pick_microbatches", "aot_bundle"]


# ----------------------------- input specs -----------------------------

def batch_struct(cfg: ModelConfig,
                 shape: ShapeCfg) -> Dict[str, Tuple[tuple, torch.dtype]]:
    """``name -> (shape, dtype)`` of one step's inputs (no allocation)."""
    b, s = shape.global_batch, shape.seq_len
    frames = ((b, s, cfg.d_model), torch.bfloat16)
    if shape.step == "train":
        if cfg.encdec:
            return {"frames": frames,
                    "tokens": ((b, cfg.dec_seq), torch.int32)}
        if not cfg.uses_tokens:
            return {"embeds": frames, "labels": ((b, s), torch.int32)}
        return {"tokens": ((b, s), torch.int32)}
    if shape.step == "prefill":
        if cfg.encdec:
            return {"frames": frames}
        if not cfg.uses_tokens:
            return {"embeds": frames}
        return {"tokens": ((b, s), torch.int32)}
    # decode: one new token against a seq_len cache
    return {"tokens": ((b, 1), torch.int32), "cur_index": ((), torch.int32)}


def batch_shardings(cfg: ModelConfig, shape: ShapeCfg, mesh: Mesh) -> dict:
    """Each input's partition spec on ``mesh``: the leading dimension over
    the ``batch`` rule's axes, ``cur_index`` replicated."""
    out = {}
    for name, (dims, _) in batch_struct(cfg, shape).items():
        if name == "cur_index":
            out[name] = ()
            continue
        axes = ("batch",) + (None,) * (len(dims) - 1)
        out[name] = shd.named_sharding(dims, axes, mesh)
    return out


# ----------------------------- train step -----------------------------

def _grads(loss: torch.Tensor, tree: dict) -> dict:
    """d loss / d every leaf of ``tree``, zeros for a leaf the loss does not
    read (whisper's ``enc_pos``), as ``jax.grad`` gives."""
    pairs = flatten(tree)
    got = torch.autograd.grad(loss, [t for _, t in pairs], allow_unused=True)
    by_path = {path: torch.zeros_like(t) if g is None else g
               for (path, t), g in zip(pairs, got)}
    return map_with_path(lambda path, _: by_path[path], tree)


def make_train_step(cfg: ModelConfig,
                    opt_cfg: "adamw.AdamWConfig | None" = None,
                    microbatches: int = 1,
                    accum_dtype: torch.dtype = torch.float32,
                    dtype: torch.dtype = torch.bfloat16):
    """Returns ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``, the inputs left as they are.

    With ``microbatches > 1`` the compute copies (``dtype``) are made once
    per step, outside the accumulation: the gradients are taken with
    respect to them, each microbatch's ``g / microbatches`` is accumulated
    in ``accum_dtype``, and the loss is the microbatches' mean (the metrics
    hold only it and the optimizer's).  ``dtype=torch.float32`` runs the
    same step on the master weights."""
    opt_cfg = opt_cfg or adamw.AdamWConfig()

    def loss_fn(params, batch):
        return lm.forward_loss(params, cfg, batch, remat=True, dtype=dtype)

    def train_step(params, opt_state, batch):
        if microbatches > 1:
            for k, v in batch.items():
                if v.shape[0] % microbatches:
                    raise ValueError(
                        f"microbatches={microbatches} does not divide the "
                        f"batch: {k} has {v.shape[0]} rows")
            params_c = tree_map(
                lambda p: p.detach().to(dtype).requires_grad_(), params)
            acc = tree_map(lambda p: torch.zeros(p.shape, dtype=accum_dtype,
                                                 device=p.device), params)
            loss = torch.zeros((), dtype=torch.float32,
                               device=flatten(params)[0][1].device)
            parts = {k: v.split(v.shape[0] // microbatches)
                     for k, v in batch.items()}
            for i in range(microbatches):
                mb_loss, _ = loss_fn(params_c, {k: v[i]
                                                for k, v in parts.items()})
                grads = _grads(mb_loss, params_c)
                acc = tree_map(
                    lambda a, g: a + g.to(accum_dtype) / microbatches,
                    acc, grads)
                loss = loss + mb_loss.detach()
            loss, metrics, grads = loss / microbatches, {}, acc
        else:
            params_g = tree_map(lambda p: p.detach().requires_grad_(), params)
            loss, metrics = loss_fn(params_g, batch)
            grads = _grads(loss, params_g)
            loss = loss.detach()
            metrics = {k: v.detach() for k, v in metrics.items()}
        new_params, new_opt, opt_metrics = adamw.apply_updates(
            opt_cfg, params, grads, opt_state)
        return new_params, new_opt, {"loss": loss, **metrics, **opt_metrics}

    return train_step


def make_prefill_step(cfg: ModelConfig, shape: ShapeCfg):
    def prefill_step(params, batch, caches):
        if cfg.encdec:
            return lm.encdec_prefill(params, cfg, batch, caches)
        return lm.prefill(params, cfg, batch, caches)
    return prefill_step


def make_decode_step(cfg: ModelConfig, shape: ShapeCfg):
    def serve_step(params, batch, caches):
        return lm.decode_step(params, cfg, batch["tokens"], caches,
                              batch["cur_index"])
    return serve_step


# ----------------------------- batch sizing -----------------------------

def data_parallel_size(mesh: Mesh) -> int:
    sizes = mesh.sizes
    return sizes.get("data", 1) * sizes.get("pod", 1)


def pick_microbatches(cfg: ModelConfig, shape: ShapeCfg, mesh: Mesh,
                      target_per_device: "int | None" = None) -> int:
    """Gradient-accumulation depth: keep each device's microbatch at or
    below ``target_per_device`` sequences."""
    if target_per_device is None:
        # wide residual streams and frontend-embedding inputs carry 2-3x the
        # activation bytes per token: halve the microbatch for those
        wide = cfg.d_model >= 6144 or cfg.frontend != "none" or cfg.encdec
        target_per_device = 2 if wide else 4
        if cfg.n_experts > 0:
            # MoE dispatch buffers scale with tokens per pass: stream them
            target_per_device = 1
    dp = data_parallel_size(mesh)
    per_dev = max(1, shape.global_batch // dp)
    mb = max(1, per_dev // target_per_device)
    while shape.global_batch % (mb * dp) and mb > 1:
        mb -= 1
    return mb


# ----------------------------- AOT bundles -----------------------------

def aot_bundle(cfg: ModelConfig, shape: ShapeCfg, mesh: Mesh,
               opt_cfg: "adamw.AdamWConfig | None" = None,
               microbatches: "int | None" = None) -> Dict[str, Any]:
    """Everything one (arch x shape x mesh) cell runs ahead of time:
    ``fn``, its ``args`` as ``meta`` tensors, and the partition-spec trees
    ``in_shardings`` / ``out_shardings`` (``None`` for an output left to
    the step), with the JAX package's choices: bfloat16 optimizer state
    by default, :func:`pick_microbatches`, a bfloat16 accumulator from 8
    microbatches on, bfloat16 weights for inference, and ``embed``
    replicated for inference when the TP-sharded weights fit in 3 GiB."""
    if opt_cfg is None:
        # the production posture: bfloat16 optimizer state
        opt_cfg = adamw.AdamWConfig(state_dtype="bfloat16")
    specs = lm.build_specs(cfg)
    param_structs = abstract_tree(specs)
    param_shardings = shardings_tree(specs, mesh)
    batch_structs = {name: torch.empty(dims, dtype=dt, device="meta")
                     for name, (dims, dt) in batch_struct(cfg, shape).items()}
    batch_shards = batch_shardings(cfg, shape, mesh)

    if shape.step == "train":
        if microbatches is None:
            microbatches = pick_microbatches(cfg, shape, mesh)
        accum_dtype = torch.bfloat16 if microbatches >= 8 else torch.float32
        step = make_train_step(cfg, opt_cfg, microbatches=microbatches,
                               accum_dtype=accum_dtype)
        opt_structs = adamw.abstract_state(param_structs, opt_cfg.state_dtype)
        opt_shardings = adamw.OptState(step=(), m=param_shardings,
                                       v=param_shardings)
        return dict(
            fn=step,
            args=(param_structs, opt_structs, batch_structs),
            in_shardings=(param_shardings, opt_shardings, batch_shards),
            out_shardings=(param_shardings, opt_shardings, None),
            microbatches=microbatches,
        )

    # inference serves bfloat16 weights (no optimizer master copy)
    param_structs = tree_map(
        lambda t: t.to(torch.bfloat16) if t.dtype == torch.float32 else t,
        param_structs)
    # Serving avoids FSDP when the TP-sharded weights fit per device:
    # per-token-step weight all-gathers would dominate decode otherwise.
    per_dev_bytes = 2 * count_params(specs) / mesh.sizes.get("model", 1)
    if per_dev_bytes <= 3 * 2 ** 30:
        rules = dict(shd.rules_for_mesh(mesh))
        rules["embed"] = ()            # replicate over data: no gathers
        param_shardings = shardings_tree(specs, mesh, rules)
    b = shape.global_batch
    cache_structs = lm.abstract_cache(cfg, b, shape.seq_len)
    cache_shardings = tree_map(
        lambda t: shd.named_sharding(t[0], t[2], mesh),
        lm.cache_layout(cfg, b, shape.seq_len), is_leaf=lm._is_layout_leaf)
    in_shardings = (param_shardings, batch_shards, cache_shardings)
    if shape.step == "prefill":
        return dict(
            fn=make_prefill_step(cfg, shape),
            args=(param_structs, batch_structs, cache_structs),
            in_shardings=in_shardings,
            out_shardings=(cache_shardings if cfg.encdec
                           else (None, cache_shardings)),
        )
    return dict(
        fn=make_decode_step(cfg, shape),
        args=(param_structs, batch_structs, cache_structs),
        in_shardings=in_shardings,
        out_shardings=(None, cache_shardings),
    )
