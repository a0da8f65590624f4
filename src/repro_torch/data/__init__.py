"""Data pipelines on the simulated SSD (PyTorch port of :mod:`repro.data`;
only the bitmap filter is ported)."""
from repro_torch.data.bitmap_pipeline import BitmapFilter

__all__ = ["BitmapFilter"]
