"""Observability: device-timeline tracing, typed metrics and a text report.

- ``trace``   — span-based :class:`Tracer` reconstructing the simulated
  device timeline (one virtual lane per die / channel / host link, the
  longest lane equal to the ledger's ``makespan_us()`` by construction)
  plus host wall-clock spans, with Chrome trace-event JSON export.
- ``metrics`` — :class:`Counter` / :class:`Gauge` / :class:`Histogram` and
  the :class:`MetricsRegistry` behind ``ComputeSession.stats()``.
- ``report``  — human-readable text timeline (per-category, per-lane,
  per-wave tables).

Turn it on with ``ComputeSession(trace=True)`` and export with
``session.trace.export("out.json")`` / print ``session.trace.report()``.
"""
from repro_torch.obs.metrics import (Counter, Gauge, Histogram, Metric,
                                     MetricsRegistry)
from repro_torch.obs.report import timeline_report
from repro_torch.obs.trace import Span, Tracer, traced

__all__ = ["Counter", "Gauge", "Histogram", "Metric", "MetricsRegistry",
           "Span", "Tracer", "timeline_report", "traced"]
