"""Serving layer: the bitmap-query engine with cross-request coalescing,
and the batched LM decode engine (``lm_engine``)."""
from repro_torch.serve.engine import QueryEngine, QueryTicket, SLOConfig
from repro_torch.serve.lm_engine import Engine, ServeConfig

__all__ = ["QueryEngine", "QueryTicket", "SLOConfig", "Engine", "ServeConfig"]
