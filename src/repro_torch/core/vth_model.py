"""Threshold-voltage (Vth) device model for MLC 3D NAND (paper §2.2, §5.3-5.4).

* Fresh pages: program-verify clamps every programmed state Ln into a hard
  window [lo_n, hi_n]; erase-verify clamps L0 below hi_0 with a wide
  half-normal lower tail.  The windows are disjoint, so fresh blocks read
  with zero RBER for the in-range ops (Table 2).
* P/E cycling adds post-verify drift: a sub-log sigma widening plus small
  mean shifts.
* Retention shifts programmed states down, L3 hardest.

Sampling draws from an explicit ``torch.Generator`` on the output's device.
Its numbers differ from ``jax.random``'s for the same seed, so the port
matches the JAX model in distribution (verify-window bounds, per-state
moments), not in bits.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from repro_torch.core import encoding


@dataclasses.dataclass(frozen=True)
class ChipModel:
    """Technology/part-number parameters.  Voltages in volts."""

    part_number: str
    description: str                       # e.g. "64-Layer FG"
    # Programmed-state verify windows (L1..L3) and the Gaussian clipped
    # into them.
    prog_lo: Tuple[float, float, float] = (0.7, 2.5, 4.3)
    prog_hi: Tuple[float, float, float] = (1.3, 3.1, 4.9)
    prog_mu: Tuple[float, float, float] = (1.0, 2.8, 4.6)
    prog_sigma: Tuple[float, float, float] = (0.13, 0.13, 0.14)
    # Erase state: hard upper bound (erase verify) + half-normal spread below.
    erase_hi: float = -0.5
    erase_sigma: float = 2.6
    # Factory-calibrated default read references (valley centres).
    vref_default: Tuple[float, float, float] = (0.1, 1.9, 3.7)  # VREF0/1/2
    # Read-offset DAC: step size and +/- code range (paper §4.3).
    dac_step_v: float = 0.04
    dac_range_codes: int = 95              # => +/- 3.8 V
    # Cycling drift: sigma_d = wear * s_n * (NPE/1500)^alpha   (NPE > 0)
    drift_s: Tuple[float, float, float, float] = (0.165, 0.175, 0.170, 0.175)
    drift_alpha: float = 0.11
    # Cycling mean shift (V): erased state creeps up with trapped charge.
    cyc_mu_shift: Tuple[float, float, float, float] = (0.035, 0.012, 0.008, -0.010)
    # Retention: mean downshift per ln(1 + t/24h), L3 worst; plus widening.
    ret_mu_shift: Tuple[float, float, float, float] = (0.010, -0.012, -0.022, -0.040)
    ret_sigma: Tuple[float, float, float, float] = (0.020, 0.018, 0.022, 0.034)
    # Part-to-part wear multiplier (Table 2 spread across part numbers).
    wear_scale: float = 1.0

    @property
    def dac_range_v(self) -> float:
        return self.dac_step_v * self.dac_range_codes

    def quantize_ref(self, target_v: float, which: int) -> float:
        """Quantize an absolute reference target to the DAC grid, clamping the
        offset from the factory default to the user-accessible range."""
        default = self.vref_default[which]
        code = round((target_v - default) / self.dac_step_v)
        code = max(-self.dac_range_codes, min(self.dac_range_codes, code))
        return default + code * self.dac_step_v


# The five parts of Table 2.
CHIP_MODELS = {
    "MT29F256G08EBHAFJ4": ChipModel("MT29F256G08EBHAFJ4", "64-Layer FG", wear_scale=1.08),
    "MT29F512G08EEHAFJ4": ChipModel("MT29F512G08EEHAFJ4", "64-Layer FG", wear_scale=1.02),
    "MT29F1T08EELEEJ4":   ChipModel("MT29F1T08EELEEJ4", "176-Layer CT", wear_scale=0.95),
    "MT29F1T08EELKEJ4":   ChipModel("MT29F1T08EELKEJ4", "176-Layer CT", wear_scale=0.93),
    "MT29F4T08GMLCEJ4":   ChipModel("MT29F4T08GMLCEJ4", "176-Layer CT", wear_scale=1.00),
}
DEFAULT_CHIP = "MT29F1T08EELEEJ4"


def get_chip_model(name: str | None = None) -> ChipModel:
    return CHIP_MODELS[name or DEFAULT_CHIP]


def _table(values, device) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.float32, device=device)


def standard_normal(gen: torch.Generator, shape, device) -> torch.Tensor:
    """float32 N(0, 1) draws from ``gen`` (which must live on ``device``)."""
    return torch.randn(shape, generator=gen, dtype=torch.float32, device=device)


def sample_fresh_vth(gen: torch.Generator, states: torch.Tensor,
                     chip: ChipModel) -> torch.Tensor:
    """Post-verify Vth for each cell given its MLC state (fresh page)."""
    dev = states.device
    z = standard_normal(gen, states.shape, dev)
    s = states.long()
    mu = _table((0.0,) + chip.prog_mu, dev)[s]
    sig = _table((0.0,) + chip.prog_sigma, dev)[s]
    lo = _table((0.0,) + chip.prog_lo, dev)[s]
    hi = _table((0.0,) + chip.prog_hi, dev)[s]
    prog = torch.minimum(torch.maximum(mu + sig * z, lo), hi)
    erased = chip.erase_hi - z.abs() * chip.erase_sigma
    return torch.where(s == encoding.L0, erased, prog)


def drift_terms(chip: ChipModel, n_pe: float, retention_hours: float,
                device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-state (mean_shift, sigma) of post-verify drift, float32."""
    n_pe = float(n_pe)
    t = float(retention_hours)
    cyc = (n_pe / 1500.0) ** chip.drift_alpha if n_pe > 0 else 0.0
    ret = torch.log1p(torch.tensor(t / 24.0, dtype=torch.float32, device=device))
    ret_acc = 1.0 + n_pe / 4000.0          # retention accelerates on worn oxide
    s = _table(chip.drift_s, device)
    sigma = chip.wear_scale * torch.sqrt(
        (s * cyc) ** 2 + (_table(chip.ret_sigma, device) * ret * ret_acc) ** 2)
    mu = (_table(chip.cyc_mu_shift, device) * math.log1p(n_pe / 1000.0)
          + _table(chip.ret_mu_shift, device) * ret * ret_acc)
    return mu, sigma


def apply_wear(gen: torch.Generator, vth: torch.Tensor, states: torch.Tensor,
               chip: ChipModel, n_pe: float,
               retention_hours: float) -> torch.Tensor:
    """Add cycling/retention drift on top of fresh (verified) Vth."""
    if n_pe <= 0 and retention_hours <= 0:
        return vth
    mu, sigma = drift_terms(chip, n_pe, retention_hours, vth.device)
    s = states.long()
    z = standard_normal(gen, vth.shape, vth.device)
    return vth + mu[s] + sigma[s] * z


def program_page(gen: torch.Generator, lsb_bits: torch.Tensor,
                 msb_bits: torch.Tensor, chip: ChipModel, n_pe: float = 0.0,
                 retention_hours: float = 0.0) -> tuple[torch.Tensor, torch.Tensor]:
    """Program shared LSB/MSB pages -> (vth, states)."""
    states = encoding.encode_mlc(lsb_bits, msb_bits)
    vth = sample_fresh_vth(gen, states, chip)
    vth = apply_wear(gen, vth, states, chip, n_pe, retention_hours)
    return vth, states

