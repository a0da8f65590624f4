"""Batched LM serving engine: prefill + greedy/temperature decode.

The JAX package's ``serve/lm_engine.py`` on the port's models
(:mod:`repro_torch.models.lm`): every config whose prompts are token ids
(attention, RG-LRU, SSD and MoE stacks).  Configs with a modality frontend
prefill from embeddings and the encoder-decoder from frames; they run
through :func:`~repro_torch.models.lm.prefill` /
:func:`~repro_torch.models.lm.encdec_prefill` and ``decode_step``, and
``generate`` rejects them, as the JAX package's does.  ``generate`` stops
decoding once the final token is emitted, so ``decode_calls`` counts
exactly ``max_new_tokens - 1`` steps per call (the JAX package's
dead-final-decode fix).

The bf16 compute copies of the weights are made once, when the engine is
built; the JAX package casts inside every jitted step instead.  Greedy
decoding is the default; temperature sampling draws from the engine's
``torch.Generator`` (seeded from ``ServeConfig.seed``), which advances
from one call to the next.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.api.session import resolve_device
from repro_torch.models import lm
from repro_torch.models.specs import flatten, init_tree

__all__ = ["ServeConfig", "Engine"]


@dataclasses.dataclass
class ServeConfig:
    max_seq: int = 512
    temperature: float = 0.0      # 0 => greedy
    seed: int = 0


class Engine:
    """Serves one model: ``params`` is its tree of f32 master weights."""

    def __init__(self, cfg, params: dict, serve_cfg: ServeConfig | None = None):
        self.cfg = cfg
        self.params = params
        self.scfg = serve_cfg or ServeConfig()
        self.device = flatten(params)[0][1].device
        #: decode_step invocations across generate() calls: max_new_tokens
        #: - 1 per call, never max_new_tokens
        self.decode_calls = 0
        self._compute = lm.cast_params(params)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(self.scfg.seed)

    @classmethod
    def from_seed(cls, cfg, seed: int = 0,
                  device: "torch.device | str | None" = None, **kw):
        """An engine over weights drawn from ``seed`` on ``device`` (``None``
        = the card; raises without one)."""
        params = init_tree(seed, lm.build_specs(cfg), resolve_device(device))
        return cls(cfg, params, **kw)

    def generate(self, prompts, max_new_tokens: int = 32) -> torch.Tensor:
        """prompts: (B, S0) token ids -> (B, S0 + max_new_tokens) int64."""
        if self.cfg.encdec or not self.cfg.uses_tokens:
            raise ValueError(f"{self.cfg.name} does not take token prompts")
        prompts = torch.as_tensor(prompts, device=self.device).long()
        b, s0 = prompts.shape
        caches = lm.init_cache(self.cfg, b, self.scfg.max_seq, self.device)
        logits, caches = lm.prefill(self._compute, self.cfg,
                                    {"tokens": prompts}, caches)
        out = [prompts]
        tok = self._pick(logits[:, -1])
        for i in range(max_new_tokens):
            out.append(tok)
            if i + 1 == max_new_tokens:
                break      # the last token completes the request
            self.decode_calls += 1
            logits, caches = lm.decode_step(self._compute, self.cfg, tok,
                                            caches, s0 + i)
            tok = self._pick(logits[:, -1])
        return torch.cat(out, dim=1)

    def _pick(self, logits: torch.Tensor) -> torch.Tensor:
        """(B, V) logits -> (B, 1) next tokens."""
        if self.scfg.temperature > 0:
            probs = torch.softmax(logits.float() / self.scfg.temperature, -1)
            return torch.multinomial(probs, 1, generator=self.generator)
        return torch.argmax(logits, dim=-1, keepdim=True)
