"""Fault-tolerant training loop.

The JAX package's ``train/loop.py`` on the port:

- **checkpoint/restart**: atomic checkpoints of ``(params, OptState)``
  every ``ckpt_every`` steps, at the end and on preemption; on start the
  loop resumes from the newest (the on-disk layout is the JAX package's,
  so either package's loop resumes the other's);
- **preemption**: SIGTERM (with ``install_preemption_handler``) or
  ``request_preemption`` sets a flag; the loop checkpoints and stops at
  the next step boundary;
- **straggler watchdog**: an EWMA of the step time flags steps slower than
  ``straggler_factor`` x the running mean (recorded in the metrics; the
  ``_simulate_slow_step`` hook injects one in tests);
- **deterministic data**: a batch is a pure function of its step, so a
  restart resumes mid-stream exactly.
"""
from __future__ import annotations

import dataclasses
import os
import signal
import tempfile
import time
from typing import Any, Callable

import torch

from repro_torch.api.session import resolve_device
from repro_torch.checkpoint import ckpt as ckpt_lib
from repro_torch.data.tokens import DataConfig, TokenPipeline
from repro_torch.models import lm
from repro_torch.models.specs import init_tree
from repro_torch.optim import adamw
from repro_torch.train.step import make_train_step

__all__ = ["LoopConfig", "TrainLoop"]


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 200
    ckpt_every: int = 50
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    log_every: int = 10
    straggler_factor: float = 3.0
    microbatches: int = 1
    seed: int = 0


class TrainLoop:
    """Trains ``cfg`` on ``device`` (``None`` = the card; raises without
    one).  Batches come from ``batch_fn(step)``, by default the synthetic
    :class:`TokenPipeline` of ``global_batch`` x ``seq_len`` tokens."""

    def __init__(self, cfg, loop_cfg: LoopConfig,
                 opt_cfg: "adamw.AdamWConfig | None" = None,
                 data: "TokenPipeline | None" = None,
                 batch_fn: "Callable[[int], dict] | None" = None,
                 global_batch: int = 8, seq_len: int = 256,
                 device: "torch.device | str | None" = None):
        self.cfg = cfg
        self.loop_cfg = loop_cfg
        self.device = resolve_device(device)
        self.opt_cfg = opt_cfg or adamw.AdamWConfig(
            total_steps=loop_cfg.total_steps)
        self.data = data or TokenPipeline(DataConfig(
            vocab=cfg.vocab, seq_len=seq_len, global_batch=global_batch,
            seed=loop_cfg.seed), device=self.device)
        self.batch_fn = batch_fn or self.data.batch_at
        self.step_fn = make_train_step(cfg, self.opt_cfg,
                                       microbatches=loop_cfg.microbatches)
        self._preempted = False
        self.metrics_log: list[dict[str, Any]] = []
        self.straggler_events: list[int] = []
        self._simulate_slow_step: "int | None" = None  # test hook

    # -- state ----------------------------------------------------------------
    def init_state(self):
        """Parameters from ``init_tree(seed)`` on the loop's device and zero
        AdamW moments in the config's ``state_dtype``.  (The JAX package's
        loop makes float32 zeros, which its first update casts; the update
        math runs in float32 either way, so the steps are the same, and a
        restore reads bfloat16 moments into bfloat16 leaves.)"""
        params = init_tree(self.loop_cfg.seed, lm.build_specs(self.cfg),
                           self.device)
        return params, adamw.init(params, self.opt_cfg.state_dtype)

    def restore_or_init(self):
        """``(params, opt, step)``: the newest checkpoint's, else fresh."""
        params, opt = self.init_state()
        step = ckpt_lib.latest_step(self.loop_cfg.ckpt_dir)
        if step is not None:
            (params, opt), _ = ckpt_lib.restore(
                self.loop_cfg.ckpt_dir, (params, opt), step)
            return params, opt, step
        return params, opt, 0

    # -- preemption -----------------------------------------------------------
    def install_preemption_handler(self):
        signal.signal(signal.SIGTERM,
                      lambda *_: setattr(self, "_preempted", True))

    def request_preemption(self):
        self._preempted = True

    # -- main loop ------------------------------------------------------------
    def run(self) -> dict:
        """Train from the newest checkpoint (or step 0) to ``total_steps``
        or a preemption.  Returns ``{"params", "opt", "last_step",
        "metrics", "stragglers"}``."""
        lc = self.loop_cfg
        params, opt, start = self.restore_or_init()
        ewma = None
        done = start
        for step in range(start, lc.total_steps):
            t0 = time.perf_counter()
            batch = self.batch_fn(step)
            params, opt, metrics = self.step_fn(params, opt, batch)
            metrics = {k: float(v) for k, v in metrics.items()}
            if self._simulate_slow_step == step:
                time.sleep((ewma or 0.1) * (lc.straggler_factor + 1))
            dt = time.perf_counter() - t0
            # straggler watchdog (EWMA of step time)
            if ewma is not None and dt > lc.straggler_factor * ewma:
                self.straggler_events.append(step)
                metrics["straggler"] = 1.0
            ewma = dt if ewma is None else 0.9 * ewma + 0.1 * dt
            metrics.update(step=step, step_time_s=dt)
            self.metrics_log.append(metrics)
            if lc.log_every and step % lc.log_every == 0:
                print(f"step {step}: loss={metrics['loss']:.4f} "
                      f"({dt * 1e3:.0f} ms)", flush=True)
            done = step + 1
            if (done % lc.ckpt_every == 0 or done == lc.total_steps
                    or self._preempted):
                ckpt_lib.save(lc.ckpt_dir, done, (params, opt))
            if self._preempted:
                print(f"preempted at step {done}; checkpoint saved",
                      flush=True)
                break
        return {"params": params, "opt": opt, "last_step": done,
                "metrics": self.metrics_log,
                "stragglers": self.straggler_events}
