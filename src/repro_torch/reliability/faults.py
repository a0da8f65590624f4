"""Seeded, replayable wear/retention fault injection (Cai-style curves).

The model perturbs a wordline's Vth row *at program time* with a uniform
common-mode term: every state — erased included — shifts down by
``mean_shift_v * s`` (plus any retention term) and widens by a *bounded*
uniform spread ``±spread_v * s``, where ``s`` is the normalized P/E wear
severity from :func:`repro_torch.core.vth_model.pe_wear_scale`.  Common-mode
plus bounded noise is the regime dynamic sensing targets: one scalar
reference offset recovers the data exactly.  Optional stuck cells and dead
blocks model the unrecoverable tail that forces block retirement.

Every perturbation draws from a ``torch.Generator`` on the row's device,
seeded from ``(seed, plane, block, wl)``, so it replays regardless of
program order.  The JAX package keys ``jax.random`` the same way; the two
give different bits from one seed and agree in distribution.
"""
from __future__ import annotations

import dataclasses
import math
from typing import FrozenSet, Tuple

import torch

from repro_torch.core.vth_model import pe_wear_scale

__all__ = ["FaultConfig", "FaultModel", "STUCK_VTH"]

#: Vth a stuck-at cell is pinned to — above every read reference, so the cell
#: always senses as "not conducting" no matter the offset (unrecoverable).
STUCK_VTH = 6.0

_MASK64 = (1 << 64) - 1


def _mix64(x: int) -> int:
    """splitmix64 finalizer: a well-spread 64-bit hash of ``x``."""
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Knobs for the injected wear model."""

    pe: int = 10_000            # simulated baseline P/E cycles for new writes
    seed: int = 0               # PRNG root; same seed => same faults
    mean_shift_v: float = 0.38  # common-mode downshift at s == 1 (10k P/E)
    spread_v: float = 0.10      # bounded uniform widening (+/-) at s == 1
    retention_hours: float = 0.0   # static retention age applied at program
    retention_v: float = 0.12   # retention downshift per log-decade (~1000 h)
    stuck_bit_pct: float = 0.0  # percent of cells pinned at STUCK_VTH
    dead_blocks: Tuple[Tuple[int, int], ...] = ()  # (plane, block) failures

    @staticmethod
    def parse(spec) -> "FaultConfig | None":
        """Coerce a ``ComputeSession(faults=...)`` / ``REPRO_FAULTS`` spec.

        Accepts ``None``/``False`` (off), ``True`` (defaults), an int P/E
        count, a ``FaultConfig``, a dict of fields, or a string — either a
        bare P/E count (``"10000"``) or ``"pe=5000,seed=3,spread_v=0.1"``.
        """
        if spec is None or spec is False or spec == "":
            return None
        if spec is True:
            return FaultConfig()
        if isinstance(spec, FaultConfig):
            return spec
        if isinstance(spec, int):
            return FaultConfig(pe=spec)
        if isinstance(spec, dict):
            return FaultConfig(**spec)
        if isinstance(spec, str):
            s = spec.strip()
            if s.lower() in ("0", "off", "none", "false"):
                return None
            if "=" not in s:
                return FaultConfig(pe=int(s))
            fields = {f.name for f in dataclasses.fields(FaultConfig)}
            kw = {}
            for part in s.split(","):
                k, _, v = part.partition("=")
                k = k.strip()
                if k not in fields:
                    raise ValueError(f"unknown fault knob {k!r} in {spec!r}")
                kw[k] = int(v) if k in ("pe", "seed") else float(v)
            return FaultConfig(**kw)
        raise TypeError(f"cannot parse fault spec {spec!r}")


class FaultModel:
    """Installed on a :class:`FlashDevice`; perturbs rows at program time."""

    def __init__(self, cfg: FaultConfig):
        self.cfg = cfg
        self._dead: FrozenSet[Tuple[int, int]] = frozenset(
            tuple(b) for b in cfg.dead_blocks)
        self.aged_hours: float = float(cfg.retention_hours)

    # -- keying ---------------------------------------------------------------
    def generator(self, plane: int, block: int, wl: int,
                  device: "torch.device | str") -> torch.Generator:
        """The generator of one wordline's perturbation, on ``device``."""
        key = _mix64(self.cfg.seed)
        for part in (plane, block, wl):
            key = _mix64(key ^ (int(part) & _MASK64))
        gen = torch.Generator(device=device)
        gen.manual_seed(key & ((1 << 63) - 1))
        return gen

    # -- physics --------------------------------------------------------------
    def wear(self, n_pe_extra: int = 0) -> float:
        """Normalized severity for a write at baseline + per-block P/E."""
        return pe_wear_scale(self.cfg.pe + int(n_pe_extra))

    def retention_shift(self, hours: float) -> float:
        """Uniform downshift after ``hours`` of retention (log-time)."""
        if hours <= 0:
            return 0.0
        return self.cfg.retention_v * math.log1p(hours / 1.0) / math.log(1e3)

    def is_dead(self, plane: int, block: int) -> bool:
        return (plane, block) in self._dead

    def perturb(self, vth: torch.Tensor, *, plane: int, block: int,
                wl: int, n_pe: int = 0) -> torch.Tensor:
        """Apply the wear model to one wordline's freshly programmed row."""
        cfg = self.cfg
        gen = self.generator(plane, block, wl, vth.device)

        def uniform() -> torch.Tensor:
            return torch.rand(vth.shape, generator=gen, device=vth.device,
                              dtype=vth.dtype)

        if self.is_dead(plane, block):
            # block failure: the row reads back as garbage at any reference
            return uniform() * (STUCK_VTH + 1.0) - 1.0
        s = self.wear(n_pe)
        out = vth
        if s > 0:
            out = out - cfg.mean_shift_v * s + (uniform() * 2.0 - 1.0) * (
                cfg.spread_v * s)
        out = out - self.retention_shift(self.aged_hours)
        if cfg.stuck_bit_pct > 0:
            stuck = uniform() < cfg.stuck_bit_pct / 100.0
            out = torch.where(stuck, torch.full_like(out, STUCK_VTH), out)
        return out
