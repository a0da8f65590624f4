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

Wall-span categories (each span carries ``sid`` and ``parent``; per
category :attr:`Tracer.totals` keeps count, time and self time):

- ``simplify`` (``simplify``): the session canonicalizing expressions.
- ``lower`` (``lower``): lowering a batch of DAGs into a plan.
- ``verify`` (``verify-plan``): the static verifier (``cached``: verdict
  memoized).
- ``account`` (``account-waves``): the ledger's per-wave bookkeeping and
  its overlap check.
- ``compile`` (``build-executable``): building a cached wave runner.
- ``dispatch`` (``dispatch-waves``): a plan's dispatch, holding
  ``gather`` (``vth-gather``: each unit's slot-table lookups, the rows
  the sense kernels read in place; ``tables_built`` counts the tables it
  built) and ``launch`` (``run-waves``: the runner's launches; its
  units' ``encoding`` and each unit's reference count, ``refs``).
- ``serve_poll`` (``poll``) and ``serve_step`` (``batch N``): the serving
  engine's batch-formation check and one coalesced batch; ``serve``
  (``request N``): a request's life from admission to its result, marked
  after the fact and never a parent.
- ``drain_submit`` (``drain-submit``) and ``drain_wait``
  (``drain-result``): a device->host result's submit and its receipt.
- ``program`` (``write-group``): an aligned write, holding
  ``program_draw`` (``vth-draw``: the per-wordline Vth draw) and
  ``program_store`` (``arena-write``: page records and the arena write);
  ``program`` and ``program_draw`` carry the ``encoding`` and its
  ``pages_per_wordline``.
- ``predicate`` (``between``): ``ComputeSession.between`` building a
  range predicate's DAG; args ``digits``, ``lo`` and ``hi``.
- ``ftl``: copyback realignment and NOT-ready copies; ``reliability``:
  recovery.

Serving spans carry their request ids (``rids``, or ``rid`` on drains and
requests).  Instants: ``executable-evicted``, ``tiled-megakernel-split``,
``checkword-mismatch``.
"""
from repro_torch.obs.metrics import (Counter, Gauge, Histogram, Metric,
                                     MetricsRegistry)
from repro_torch.obs.report import timeline_report
from repro_torch.obs.trace import Span, Tracer, traced

__all__ = ["Counter", "Gauge", "Histogram", "Metric", "MetricsRegistry",
           "Span", "Tracer", "timeline_report", "traced"]
