"""AdamW with global-norm clipping and a warmup + cosine schedule.

The JAX package's ``optim/adamw.py`` on tensor trees (nested dicts of
tensors, as the port's parameters are).  The update math runs in float32
whatever ``state_dtype`` the moments are kept in.  ``torch.optim.AdamW``
is not used: its clipping, schedule, bias correction and decoupled weight
decay differ from these.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.models.specs import flatten, tree_map

__all__ = ["AdamWConfig", "OptState", "init", "abstract_state", "schedule",
           "global_norm", "apply_updates"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    # "bfloat16" halves the moments' memory (the update math still runs in
    # float32); "float32" for small models.
    state_dtype: str = "float32"


class OptState(NamedTuple):
    step: torch.Tensor        # int32 scalar: updates applied so far
    m: Any
    v: Any


def _dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def init(params, state_dtype: str = "float32") -> OptState:
    """Zero moments shaped as ``params``, on their devices."""
    dt = _dtype(state_dtype)

    def zeros(p):
        return torch.zeros(p.shape, dtype=dt, device=p.device)

    device = flatten(params)[0][1].device
    return OptState(step=torch.zeros((), dtype=torch.int32, device=device),
                    m=tree_map(zeros, params), v=tree_map(zeros, params))


def abstract_state(param_structs, state_dtype: str = "float32") -> OptState:
    """The AOT view of :func:`init`: ``meta`` tensors of the moments'
    shapes in ``state_dtype`` and an int32 step, allocating nothing."""
    dt = _dtype(state_dtype)

    def meta(p):
        return torch.empty(p.shape, dtype=dt, device="meta")

    return OptState(step=torch.empty((), dtype=torch.int32, device="meta"),
                    m=tree_map(meta, param_structs),
                    v=tree_map(meta, param_structs))


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_ratio`` (float32)."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def global_norm(tree) -> torch.Tensor:
    """The float32 L2 norm over every leaf of ``tree``."""
    return torch.sqrt(sum(torch.sum(torch.square(leaf.float()))
                          for _, leaf in flatten(tree)))


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params, grads, state: OptState):
    """One AdamW step.  Returns (new_params, new_state, {"grad_norm",
    "lr"}); the inputs are left as they are."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    step = state.step + 1
    lr = schedule(cfg, step)
    b1t = 1 - cfg.b1 ** step.float()
    b2t = 1 - cfg.b2 ** step.float()
    state_dt = _dtype(cfg.state_dtype)

    def upd(p, g, m, v):
        g = g.float() * scale
        m32 = cfg.b1 * m.float() + (1 - cfg.b1) * g
        v32 = cfg.b2 * v.float() + (1 - cfg.b2) * g * g
        step_ = (m32 / b1t) / (torch.sqrt(v32 / b2t) + cfg.eps) \
            + cfg.weight_decay * p.float()
        return (p.float() - lr * step_).to(p.dtype), m32.to(state_dt), \
            v32.to(state_dt)

    out = tree_map(upd, params, grads, state.m, state.v)   # (p, m, v) leaves
    return (tree_map(lambda o: o[0], out),
            OptState(step, tree_map(lambda o: o[1], out),
                     tree_map(lambda o: o[2], out)),
            {"grad_norm": gnorm, "lr": lr})
