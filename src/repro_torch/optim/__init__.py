"""Optimizers (PyTorch port of :mod:`repro.optim`)."""
from repro_torch.optim import adamw
from repro_torch.optim.adamw import AdamWConfig, OptState

__all__ = ["adamw", "AdamWConfig", "OptState"]
