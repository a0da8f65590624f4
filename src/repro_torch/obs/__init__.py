"""Observability: typed metrics and (tracing-off) span hooks."""
