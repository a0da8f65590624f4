"""Serving layer: the bitmap-query engine with cross-request coalescing."""
from repro_torch.serve.engine import QueryEngine, QueryTicket, SLOConfig

__all__ = ["QueryEngine", "QueryTicket", "SLOConfig"]
