"""Deterministic, resumable synthetic token pipeline.

The JAX package's ``data/tokens.py``: every batch is a pure function of
``(seed, step)``, so a restarted job resumes mid-stream with no batch
repeated or dropped, and skipping ahead costs nothing.  The JAX package
derives a batch from ``fold_in(seed, step)``, whose bits torch cannot
replay; here a CPU ``torch.Generator`` keyed by ``(seed, step)`` draws the
same distributions (as ``reliability/faults.py`` matches its reference),
so a batch is identical on the CPU and on the card.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.specs import keyed_generator

__all__ = ["DataConfig", "TokenPipeline"]

#: probability that a token is the bigram successor of the one before it
FOLLOW_P = 0.7


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0


class TokenPipeline:
    """A synthetic corpus with a Zipf-like marginal (``Exp(1) * V / 8``,
    clipped to ``[1, V - 1]``) and a learnable bigram: each token after the
    first is, with probability 0.7, ``(prev * 31 + 7) % (V - 1) + 1`` of the
    token drawn before it.  ``device`` is where batches are put."""

    def __init__(self, cfg: DataConfig,
                 device: "torch.device | str" = "cpu"):
        self.cfg = cfg
        self.device = torch.device(device)

    def batch_at(self, step: int) -> dict:
        """``{"tokens": (global_batch, seq_len) int32}`` of step ``step``."""
        cfg = self.cfg
        gen = keyed_generator(cfg.seed, step, "cpu")
        shape = (cfg.global_batch, cfg.seq_len)
        u = torch.empty(shape, dtype=torch.float32).exponential_(generator=gen)
        toks = torch.clamp(u * cfg.vocab / 8.0, 1, cfg.vocab - 1).long()
        follow = (toks[:, :-1] * 31 + 7) % (cfg.vocab - 1) + 1
        gate = torch.rand(follow.shape, generator=gen) < FOLLOW_P
        toks[:, 1:] = torch.where(gate, follow, toks[:, 1:])
        return {"tokens": toks.int().to(self.device)}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
