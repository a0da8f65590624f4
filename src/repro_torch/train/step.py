"""Train / prefill / decode step factories.

The JAX package's ``train/step.py`` without its AOT half (``jax.jit``
lowering, ``batch_shardings`` and ``aot_bundle``; ROADMAP queue 1 item
7.4).  A train step takes the gradients of ``forward_loss`` with
``torch.autograd.grad`` (nothing is left in ``.grad``) and applies one
AdamW update; with ``microbatches > 1`` it accumulates the microbatches'
gradients inside the step, so the global batch is honoured without the
activation memory of all of it at once.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeCfg
from repro_torch.launch.mesh import Mesh
from repro_torch.models import lm
from repro_torch.models.specs import flatten, map_with_path, tree_map
from repro_torch.optim import adamw

__all__ = ["batch_struct", "make_train_step", "make_prefill_step",
           "make_decode_step", "data_parallel_size", "pick_microbatches"]


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
                              int(batch["cur_index"]))
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
