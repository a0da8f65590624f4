"""Span-based tracer: simulated device timeline + host wall-clock spans.

The ledger's schedule-step model (:class:`repro_torch.api.Ledger`) reduces a whole
execution to three scalars — ``die_step_us`` / ``channel_step_us`` /
``host_busy_us`` — whose outer max is the makespan.  This tracer keeps the
*timeline behind those scalars*: every ``add_die_batch`` call is one parallel
dispatch step whose per-die spans all start at the die timeline's current
offset (the sum of earlier step maxima) and whose max end advances it, so

- one virtual lane per die, per channel, and one for the host link,
- spans on one lane never overlap (steps serialize by construction),
- the longest lane's end time equals ``makespan_us()`` **by construction**
  (die lanes end at ``die_step_us``, channel lanes at ``channel_step_us``,
  the host-link lane at ``host_busy_us``; the makespan is their max).

A second clock records *host wall-clock* spans (lowering, verification,
dispatch, slot-table lookups, drains, programming; the categories are listed in
:mod:`repro_torch.obs`) via the :meth:`Tracer.span` context manager, plus
instant events (runner evictions, fused-chain splits).  Wall spans nest on
the one host thread: each gets a span id (``sid``) and the id of the span
open around it when it began (``parent``), and every close adds to
:attr:`Tracer.totals`, per category, whether or not the span is stored.
Both clocks export into one Chrome trace-event JSON (``chrome://tracing`` /
Perfetto loadable) as separate processes, and into the human-readable text
report in :mod:`repro_torch.obs.report`.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import time
from typing import Dict, List, Mapping, Optional

__all__ = ["Span", "Tracer", "traced",
           "DEVICE_PID", "WALL_PID", "CHANNEL_TID_BASE", "HOST_LINK_TID"]

#: Chrome-trace process ids: the virtual device timeline vs host wall clock
DEVICE_PID = 1
WALL_PID = 2
#: thread-id blocks inside the device process: dies at tid=die, channels and
#: the host link above them (keeps lanes grouped/ordered in the viewer)
CHANNEL_TID_BASE = 100_000
HOST_LINK_TID = 200_000


@dataclasses.dataclass
class Span:
    """One timeline slice: ``[start_us, start_us + dur_us)`` on ``lane``."""
    name: str
    category: str            # sense | program | erase | dma | host | lower...
    lane: str                # 'die 3' | 'channel 0' | 'host-link' | 'wall'
    start_us: float
    dur_us: float
    args: Dict[str, object] = dataclasses.field(default_factory=dict)
    #: wall spans: this span's id, and the id of the span open around it
    #: when it began (None at the top, and for marked request spans)
    sid: Optional[int] = None
    parent: Optional[int] = None

    @property
    def end_us(self) -> float:
        return self.start_us + self.dur_us


class _Open:
    """The context manager :meth:`Tracer.span` returns: it enters by opening
    a wall span on the tracer's stack and yields the :class:`Span`, whose
    ``name`` and ``args`` the block may still fill in; it exits by closing
    it."""

    __slots__ = ("_tracer", "_span")

    def __init__(self, tracer: "Tracer", span: Span) -> None:
        self._tracer, self._span = tracer, span

    def __enter__(self) -> Span:
        tr, sp = self._tracer, self._span
        sp.sid = tr._next_sid
        tr._next_sid += 1
        if tr._open:
            sp.parent = tr._open[-1][0].sid
        tr._open.append([sp, 0.0])
        sp.start_us = tr._now_us()
        return sp

    def __exit__(self, *exc) -> None:
        tr, sp = self._tracer, self._span
        sp.dur_us = tr._now_us() - sp.start_us
        _, child_us = tr._open.pop()
        if tr._open:
            tr._open[-1][1] += sp.dur_us
        tr._add_total(sp.category, sp.dur_us, sp.dur_us - child_us)
        tr._push(tr.wall_spans, sp)


class Tracer:
    """Collects device-timeline spans, wall-clock spans, and instant events.

    ``max_spans`` bounds memory on long-running (serving) sessions: past the
    cap new spans are counted in ``dropped`` instead of stored, so the
    timeline truncates.  :attr:`totals` never does: per wall-span category
    it holds ``{"count", "us", "self_us"}`` (self time: the duration less
    the time the span's direct children cover), added to on every close.
    The totals are monotonic counters that :meth:`clear` leaves alone; a
    reader takes differences.
    """

    def __init__(self, max_spans: int = 200_000) -> None:
        self.device_spans: List[Span] = []
        self.wall_spans: List[Span] = []
        self.instants: List[dict] = []
        #: extra ``otherData`` keys for the Chrome export — the ledger
        #: records its inter-resource timing mode (and overlap totals) here
        #: so trace checkers know whether cross-lane overlap is expected
        self.meta: Dict[str, object] = {}
        self.max_spans = max_spans
        self.dropped = 0
        #: category -> {"count", "us", "self_us"} over every wall span closed
        self.totals: Dict[str, Dict[str, float]] = {}
        self._die_steps = 0         # parallel die dispatch steps seen
        self._channel_steps = 0
        self._next_sid = 0
        #: open wall spans, outermost first: [span, us its children covered]
        self._open: List[list] = []
        self._epoch = time.perf_counter()

    # -- virtual device timeline (driven by the Ledger) ----------------------
    def _push(self, store: List[Span], span: Span) -> None:
        if len(self.device_spans) + len(self.wall_spans) >= self.max_spans:
            self.dropped += 1
            return
        store.append(span)

    def die_step(self, t0_us: float, per_die_us: Mapping[int, float],
                 category: str, label: Optional[str] = None,
                 args: Optional[dict] = None) -> None:
        """One parallel die dispatch step: every named die's span starts at
        the die timeline's current offset ``t0_us`` (they run concurrently);
        the step's max end is the next step's start."""
        step = self._die_steps
        self._die_steps += 1
        for die, us in per_die_us.items():
            self._push(self.device_spans, Span(
                label or category, category, f"die {die}", t0_us, us,
                {"step": step, **(args or {})}))

    def channel_step(self, t0_us: float, per_channel_us: Mapping[int, float],
                     label: Optional[str] = None,
                     args: Optional[dict] = None) -> None:
        """One parallel channel streaming step on the channel timeline."""
        step = self._channel_steps
        self._channel_steps += 1
        for ch, us in per_channel_us.items():
            self._push(self.device_spans, Span(
                label or "dma", "dma", f"channel {ch}", t0_us, us,
                {"step": step, **(args or {})}))

    def host_step(self, t0_us: float, us: float,
                  label: Optional[str] = None) -> None:
        """One controller->host link transfer on the host-link timeline."""
        self._push(self.device_spans,
                   Span(label or "host", "host", "host-link", t0_us, us))

    # -- host wall clock -----------------------------------------------------
    def _now_us(self) -> float:
        return (time.perf_counter() - self._epoch) * 1e6

    def now_us(self) -> float:
        """Current wall-clock offset (us since tracer creation) — the time
        base of :meth:`mark_span` and :meth:`span`."""
        return self._now_us()

    def _add_total(self, category: str, us: float, self_us: float) -> None:
        tot = self.totals.get(category)
        if tot is None:
            tot = self.totals[category] = {"count": 0, "us": 0.0,
                                           "self_us": 0.0}
        tot["count"] += 1
        tot["us"] += us
        tot["self_us"] += self_us

    def mark_span(self, category: str, name: str, start_us: float,
                  dur_us: float, **args) -> None:
        """Record a wall-clock span from explicit endpoints.

        The serving engine uses this for request-lifecycle spans (admit ->
        complete): the endpoints are known only after the fact, so the
        :meth:`span` context manager's bracketing doesn't fit.  It adds to
        :attr:`totals` like any span, and is never a parent."""
        dur = max(0.0, float(dur_us))
        self._add_total(category, dur, dur)
        sid = self._next_sid
        self._next_sid += 1
        self._push(self.wall_spans,
                   Span(name, category, "wall", float(start_us), dur,
                        dict(args), sid=sid))

    def span(self, category: str, name: str, **args) -> _Open:
        """Wall-clock span around a host-side phase (lowering, compile,
        dispatch, FTL realignment, ...); ``with`` yields the :class:`Span`,
        so the block can fill in ``name`` and ``args`` it computes only
        when a tracer is attached."""
        return _Open(self, Span(name, category, "wall", 0.0, 0.0, args))

    def instant(self, category: str, name: str, **args) -> None:
        """Point event on the wall clock (cache hit/miss/eviction, split)."""
        if len(self.instants) >= self.max_spans:
            self.dropped += 1
            return
        self.instants.append({"name": name, "category": category,
                              "ts_us": self._now_us(), "args": dict(args)})

    # -- lane queries --------------------------------------------------------
    def lanes(self) -> Dict[str, List[Span]]:
        """Device spans grouped per virtual lane, sorted by start time."""
        by_lane: Dict[str, List[Span]] = {}
        for s in self.device_spans:
            by_lane.setdefault(s.lane, []).append(s)
        for spans in by_lane.values():
            spans.sort(key=lambda s: (s.start_us, s.end_us))
        return by_lane

    def lane_end_us(self) -> Dict[str, float]:
        """Per-lane last span end time."""
        return {lane: max(s.end_us for s in spans)
                for lane, spans in self.lanes().items()}

    def makespan_us(self) -> float:
        """Longest virtual lane's end time — equals the ledger's
        ``makespan_us()`` when this tracer saw every ledger entry."""
        ends = self.lane_end_us()
        return max(ends.values()) if ends else 0.0

    # -- Chrome trace-event export -------------------------------------------
    def _lane_tid(self, lane: str) -> int:
        kind, _, idx = lane.partition(" ")
        if kind == "die":
            return int(idx)
        if kind == "channel":
            return CHANNEL_TID_BASE + int(idx)
        return HOST_LINK_TID

    def to_chrome(self) -> dict:
        """Chrome trace-event JSON object (load in chrome://tracing or
        https://ui.perfetto.dev): the virtual device timeline and the host
        wall clock export as two processes; ``ts``/``dur`` are microseconds
        (virtual us for the device process, wall us for the host process)."""
        events: List[dict] = [
            {"ph": "M", "pid": DEVICE_PID, "tid": 0, "name": "process_name",
             "args": {"name": "device (virtual us)"}},
            {"ph": "M", "pid": DEVICE_PID, "tid": 0,
             "name": "process_sort_index", "args": {"sort_index": 0}},
            {"ph": "M", "pid": WALL_PID, "tid": 0, "name": "process_name",
             "args": {"name": "host (wall clock)"}},
            {"ph": "M", "pid": WALL_PID, "tid": 0,
             "name": "process_sort_index", "args": {"sort_index": 1}},
            {"ph": "M", "pid": WALL_PID, "tid": 1, "name": "thread_name",
             "args": {"name": "host"}},
        ]
        for lane in sorted(self.lanes()):
            tid = self._lane_tid(lane)
            events.append({"ph": "M", "pid": DEVICE_PID, "tid": tid,
                           "name": "thread_name", "args": {"name": lane}})
            events.append({"ph": "M", "pid": DEVICE_PID, "tid": tid,
                           "name": "thread_sort_index",
                           "args": {"sort_index": tid}})
        for s in self.device_spans:
            events.append({"ph": "X", "pid": DEVICE_PID,
                           "tid": self._lane_tid(s.lane), "name": s.name,
                           "cat": s.category, "ts": s.start_us,
                           "dur": s.dur_us, "args": s.args})
        for s in self.wall_spans:
            events.append({"ph": "X", "pid": WALL_PID, "tid": 1,
                           "name": s.name, "cat": s.category,
                           "ts": s.start_us, "dur": s.dur_us,
                           "args": {**s.args, "sid": s.sid,
                                    "parent": s.parent}})
        for ev in self.instants:
            events.append({"ph": "i", "pid": WALL_PID, "tid": 1, "s": "p",
                           "name": ev["name"], "cat": ev["category"],
                           "ts": ev["ts_us"], "args": ev["args"]})
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "otherData": {"tracer": "repro_torch.obs",
                              "makespan_us": self.makespan_us(),
                              "dropped_spans": self.dropped,
                              **self.meta}}

    def export(self, path: str) -> str:
        """Write the Chrome trace-event JSON to ``path``; returns the path."""
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f, indent=1)
            f.write("\n")
        return path

    def report(self, ledger=None) -> str:
        """Human-readable text timeline (see :mod:`repro_torch.obs.report`)."""
        from repro_torch.obs.report import timeline_report
        return timeline_report(self, ledger)

    def clear(self) -> None:
        """Drop the stored timeline; :attr:`totals`, the span ids and any
        span still open are kept."""
        self.device_spans.clear()
        self.wall_spans.clear()
        self.instants.clear()
        self.meta.clear()
        self.dropped = 0
        self._die_steps = self._channel_steps = 0


#: what :func:`traced` returns with tracing off (yields None; reusable)
_OFF = contextlib.nullcontext()


def traced(tracer: Optional[Tracer], category: str, name: str, **args):
    """``tracer.span(...)`` that degrades to a no-op when tracing is off —
    instrumentation points stay one-liners.  ``with`` yields the span, or
    None with tracing off: a site computes a name or an argument only
    under ``if span is not None``."""
    if tracer is None:
        return _OFF
    return tracer.span(category, name, **args)
