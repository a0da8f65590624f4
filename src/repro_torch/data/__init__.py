"""Data pipelines (PyTorch port of :mod:`repro.data`): the bitmap filter
on the simulated SSD and the synthetic token pipeline."""
from repro_torch.data.bitmap_pipeline import BitmapFilter
from repro_torch.data.tokens import DataConfig, TokenPipeline

__all__ = ["TokenPipeline", "DataConfig", "BitmapFilter"]
