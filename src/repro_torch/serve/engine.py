"""Bitmap-query serving engine with cross-request wave coalescing.

MCFlash's value proposition is bulk bitwise *throughput*, and bitmap-index
predicates share column bitmaps constantly — so the natural serving unit is
not one request but one **shared sense wave**.  :class:`QueryEngine` is the
front door that realizes that:

- :meth:`~QueryEngine.submit` admits a request — one lazy
  :class:`~repro_torch.api.graph.BitVector` DAG plus an optional popcount — into a
  bounded admission queue and returns a :class:`QueryTicket` immediately.
- :meth:`~QueryEngine.step` forms one batch under the :class:`SLOConfig`
  scheduling policy and dispatches it through
  :meth:`ComputeSession.materialize_batch_async`: the whole batch lowers in
  ONE pass with a shared memo, so structurally identical sub-DAGs dedupe
  across requests and same-``(ReadPlan, die, encoding)`` senses coalesce
  into shared batched kernel calls and shared schedule waves — the batch
  dispatches *fewer* waves than the sum of its requests' solo plans.
- Results stream back per-request through the session's bounded
  :class:`~repro_torch.api.hostio.HostDrainQueue`; each ticket holds its own
  rid-tagged :class:`~repro_torch.api.hostio.DrainHandle` and resolves
  independently (``ticket.done`` probes actual transfer completion).

**SLO-aware scheduling.**  Batch formation is score-based and starvation-
free: a request's score is its priority plus ``aging_weight`` per batch it
has already waited, and any request that has waited ``max_wait_batches``
batches preempts the score order entirely (it MUST ship in the next batch).
``max_delay_us`` bounds batch-formation delay on the wall clock —
:meth:`~QueryEngine.poll` dispatches a partial batch rather than hold the
oldest request past the bound — and admission past ``max_queue_depth``
auto-dispatches to bound queue memory.

**Observability.**  Every die/channel span the tracer emits for a serve
batch carries the owning request ids (``args["rids"]``), and so do the
batch's wall-clock spans: its ``serve_step`` span, the executor's
``lower`` and ``dispatch`` spans inside it, and each ticket's drain spans
(``args["rid"]``).  A :meth:`~QueryEngine.poll` with requests queued is a
``serve_poll`` span.  Each completed request stamps a wall-clock
``serve``-category span (admit -> result resolved, tagged ``rid`` and
``batch``), and the engine's typed metrics registry exposes
``requests_admitted`` / ``requests_completed`` / ``batches_dispatched`` /
``queue_depth`` alongside the session's ``coalesced_sense_groups`` /
``waves_shared`` counters — per-request p99 falls directly out of the
exported Chrome trace.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np

from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import traced

__all__ = ["QueryEngine", "QueryTicket", "SLOConfig"]


@dataclasses.dataclass(frozen=True)
class SLOConfig:
    """Scheduling knobs of the serving engine's batch-formation policy."""
    #: most requests one coalesced batch dispatches
    max_batch_requests: int = 8
    #: anti-starvation bound: a request that has waited this many batch
    #: formations preempts every score — it ships in the next batch
    max_wait_batches: int = 4
    #: batch-formation delay bound: :meth:`QueryEngine.poll` dispatches a
    #: partial batch once the oldest pending request is this old (wall us)
    max_delay_us: float = 2_000.0
    #: score gained per batch a request has waited (age-based priority lift)
    aging_weight: float = 1.0
    #: admission bound: submitting past this queue depth auto-dispatches
    max_queue_depth: int = 64

    def __post_init__(self):
        if self.max_batch_requests < 1:
            raise ValueError(f"max_batch_requests must be >= 1, "
                             f"got {self.max_batch_requests}")
        if self.max_wait_batches < 1:
            raise ValueError(f"max_wait_batches must be >= 1, "
                             f"got {self.max_wait_batches}")
        if self.max_queue_depth < self.max_batch_requests:
            raise ValueError("max_queue_depth must hold at least one batch")


class QueryTicket:
    """One admitted bitmap query: resolves to packed uint32 words (a numpy
    array; or an ``int`` count with ``popcount=True``) once its batch has
    dispatched and its device->host transfer lands."""

    __slots__ = ("rid", "popcount", "priority", "submitted_us", "batch",
                 "waited_batches", "_expr", "_handle", "_result", "_engine")

    def __init__(self, engine: "QueryEngine", rid: int, expr, popcount: bool,
                 priority: float, submitted_us: float) -> None:
        self.rid = rid
        self.popcount = popcount
        self.priority = priority
        self.submitted_us = submitted_us
        self.batch: Optional[int] = None       # batch index it dispatched in
        self.waited_batches = 0
        self._expr = expr
        self._handle = None                    # DrainHandle once dispatched
        self._result = None
        self._engine = engine

    @property
    def dispatched(self) -> bool:
        return self._handle is not None

    @property
    def done(self) -> bool:
        """Non-blocking readiness probe: True once the result bytes are
        host-resident (or already resolved) — the SLO scheduler uses this
        to complete requests without stalling the wave loop."""
        if self._result is not None:
            return True
        return self._handle is not None and self._handle.done

    def result(self):
        """Block for this request's result.  Dispatches the pending queue
        first if this ticket is still waiting in admission."""
        if self._result is None:
            while self._handle is None:
                self._engine.step()
            out = self._handle.result()
            self._result = int(np.asarray(out).reshape(-1)[0]) \
                if self.popcount else out
            self._engine._completed(self)
        return self._result


class QueryEngine:
    """Admission queue + SLO batch former + coalesced wave dispatcher over
    ONE :class:`~repro_torch.api.session.ComputeSession`."""

    def __init__(self, session, slo: Optional[SLOConfig] = None) -> None:
        self.session = session
        self.slo = slo or SLOConfig()
        self._queue: List[QueryTicket] = []    # admission order
        self._next_rid = 0
        self._batches = 0
        self._epoch = time.perf_counter()
        #: serving-layer typed metrics (the session keeps its own registry
        #: with the coalescing counters; stats() merges both views)
        self.metrics = MetricsRegistry()
        self.metrics.counter("requests_admitted", "queries accepted")
        self.metrics.counter("requests_completed", "results resolved")
        self.metrics.counter("batches_dispatched", "coalesced dispatches")
        self.metrics.counter("preempted_dispatches",
                             "anti-starvation preemptions (aged-out ships)")
        self.metrics.counter("delay_bound_dispatches",
                             "partial batches forced by max_delay_us")
        self.metrics.gauge("queue_depth", "pending admission-queue requests")
        self.metrics.histogram("batch_requests", "requests per batch")
        self.metrics.histogram("request_latency_us",
                               "admit -> result wall latency")
        tracer = session.trace
        if tracer is not None:
            # flags the exported trace as a serving run: check_trace then
            # requires rids on every wave span and >= 1 request span
            tracer.meta["serve_requests"] = True

    # -- clock ---------------------------------------------------------------
    def _now_us(self) -> float:
        tracer = self.session.trace
        if tracer is not None:
            return tracer.now_us()
        return (time.perf_counter() - self._epoch) * 1e6

    # -- admission -----------------------------------------------------------
    def submit(self, expr, *, popcount: bool = False,
               priority: float = 0.0) -> QueryTicket:
        """Admit one bitmap query (a lazy BitVector DAG on this engine's
        session); returns its ticket immediately.  Admission past
        ``max_queue_depth`` dispatches a batch inline (bounded queue)."""
        ticket = QueryTicket(self, self._next_rid, expr, popcount, priority,
                             self._now_us())
        self._next_rid += 1
        self._queue.append(ticket)
        self.metrics.counter("requests_admitted").add(1)
        self.metrics.gauge("queue_depth").set(len(self._queue))
        if len(self._queue) >= self.slo.max_queue_depth:
            self.step()
        return ticket

    # -- batch formation -----------------------------------------------------
    def _form_batch(self) -> List[QueryTicket]:
        """Pick the next batch under the SLO policy: aged-out requests
        (waited >= max_wait_batches) ship unconditionally, then the highest
        ``priority + aging_weight * waited`` scores fill the remaining
        slots; FIFO (rid order) breaks ties so equal scores never reorder."""
        cap = self.slo.max_batch_requests
        forced = [t for t in self._queue
                  if t.waited_batches >= self.slo.max_wait_batches]
        if forced:
            self.metrics.counter("preempted_dispatches").add(1)
        batch = forced[:cap]
        if len(batch) < cap:
            rest = sorted(
                (t for t in self._queue if t not in batch),
                key=lambda t: (-(t.priority
                                 + self.slo.aging_weight * t.waited_batches),
                               t.rid))
            batch.extend(rest[:cap - len(batch)])
        batch.sort(key=lambda t: t.rid)        # deterministic dispatch order
        return batch

    def step(self) -> int:
        """Form and dispatch ONE coalesced batch; returns the number of
        requests dispatched (0 when the queue is idle).  Every batch is one
        shared lowering + one shared wave schedule on the session."""
        if not self._queue:
            return 0
        batch = self._form_batch()
        queued = {t.rid for t in batch}
        self._queue = [t for t in self._queue if t.rid not in queued]
        for t in self._queue:
            t.waited_batches += 1
        bi = self._batches
        self._batches += 1
        rids = [t.rid for t in batch]
        with traced(self.session.trace, "serve_step", "batch") as span:
            if span is not None:
                span.name = f"batch {bi}"
                span.args.update(batch=bi, rids=rids)
            handles = self.session.materialize_batch_async(
                [t._expr for t in batch],
                popcount=[t.popcount for t in batch], rids=rids)
        for t, h in zip(batch, handles):
            t._handle = h
            t.batch = bi
            t._expr = None                     # the DAG is lowered; drop it
        self.metrics.counter("batches_dispatched").add(1)
        self.metrics.histogram("batch_requests").observe(len(batch))
        self.metrics.gauge("queue_depth").set(len(self._queue))
        return len(batch)

    def poll(self) -> int:
        """Dispatch a (possibly partial) batch only when the SLO demands
        it: the queue holds a full batch, or the oldest pending request has
        aged past ``max_delay_us``.  The arrival loop calls this after each
        submit; an empty return means the batch former is still waiting."""
        if not self._queue:
            return 0
        with traced(self.session.trace, "serve_poll", "poll"):
            if len(self._queue) >= self.slo.max_batch_requests:
                return self.step()
            oldest = min(t.submitted_us for t in self._queue)
            if self._now_us() - oldest >= self.slo.max_delay_us:
                self.metrics.counter("delay_bound_dispatches").add(1)
                return self.step()
            return 0

    # -- completion ----------------------------------------------------------
    def _completed(self, ticket: QueryTicket) -> None:
        latency = self._now_us() - ticket.submitted_us
        self.metrics.counter("requests_completed").add(1)
        self.metrics.histogram("request_latency_us").observe(latency)
        tracer = self.session.trace
        if tracer is not None:
            # request-lifecycle span (admit -> result resolved): the
            # per-request latency attribution the p99 breakdown reads
            tracer.mark_span("serve", f"request {ticket.rid}",
                             ticket.submitted_us, latency, rid=ticket.rid,
                             batch=ticket.batch, popcount=ticket.popcount,
                             waited_batches=ticket.waited_batches)

    def drain(self, tickets: "Optional[List[QueryTicket]]" = None) -> List:
        """Dispatch everything still queued, then resolve ``tickets`` (in
        the given order).  With ``tickets=None`` only flushes the queue."""
        while self._queue:
            self.step()
        self.session.host_queue.drain()
        return [t.result() for t in (tickets or [])]

    def stats(self) -> Dict:
        """Serving counters merged with the session's coalescing view."""
        sess = self.session
        return {
            "requests_admitted": int(self.metrics["requests_admitted"].value),
            "requests_completed": int(
                self.metrics["requests_completed"].value),
            "batches_dispatched": int(
                self.metrics["batches_dispatched"].value),
            "preempted_dispatches": int(
                self.metrics["preempted_dispatches"].value),
            "delay_bound_dispatches": int(
                self.metrics["delay_bound_dispatches"].value),
            "queue_depth": int(self.metrics["queue_depth"].value),
            "coalesced_sense_groups": sess.coalesced_sense_groups,
            "waves_shared": sess.waves_shared,
            "sense_waves": sess.sense_waves,
            "host_drain_submits": sess.host_drain_submits,
        }
