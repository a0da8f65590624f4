"""Put the device's idle time down to the program's own spans.

The session tracer (``repro_torch.obs.Tracer``) times its wall spans on its
own clock; ``torch.profiler`` times the device's operations and the
harness's ranges on Kineto's.  Two anchors join them: the tracer's clock
read as the first and the last statement inside the harness's
``mcbench.window`` range, mapped linearly onto that range's start and end.

Each idle gap of the window (recomputed as :func:`devtrace.summarize` does)
then goes to the innermost program span open at that instant: the spans
nest properly on the one host thread.  Request spans (category ``serve``)
are marked after the fact and cover every layer, so they are left out.
Idle that no program span covers goes to the harness range it fell in,
else to ``mcbench.loop``.  Everything here works on plain tuples, so it
runs without a card, and reads a tracer without ``totals`` (an older
program) as one with none.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

from mcbench import devtrace

#: categories that are no program span: request lifetimes
SKIP = ("serve",)
#: the category of idle no program span covers
UNCOVERED = "-"

Span = Tuple[str, float, float]           # (category, start_us, end_us)


def clock_map(a_us: float, b_us: float, start_us: float,
              end_us: float) -> Callable[[float], float]:
    """The linear map sending the tracer's ``[a, b]`` onto the profiler's
    ``[start, end]``."""
    scale = (end_us - start_us) / (b_us - a_us) if b_us > a_us else 1.0
    return lambda t: start_us + (t - a_us) * scale


def collect(tracer, into: List[Span]) -> None:
    """Append the tracer's stored program spans to ``into``; called before
    the tracer's spans are cleared."""
    if tracer is None:
        return
    into.extend((s.category, s.start_us, s.start_us + s.dur_us)
                for s in tracer.wall_spans if s.category not in SKIP)


def totals(tracer) -> Dict[str, Dict[str, float]]:
    """A copy of the tracer's running totals ({} without any)."""
    return {k: dict(v) for k, v in getattr(tracer, "totals", {}).items()}


def since(before: dict, after: dict) -> Dict[str, Dict[str, float]]:
    """The totals added between two copies, per category."""
    out = {}
    for cat, tot in after.items():
        was = before.get(cat, {})
        diff = {k: v - was.get(k, 0) for k, v in tot.items()}
        if diff.get("count"):
            out[cat] = diff
    return out


def innermost(spans: Sequence[Span]) -> List[Span]:
    """Disjoint ``(category, start, end)`` segments, sorted: at each
    instant, the innermost span open.  A child is clipped to its parent,
    so rounding in the clock map cannot unnest them."""
    out: List[Span] = []
    stack: List[Tuple[str, float]] = []       # (category, end)
    t = None

    def close_until(s: float) -> None:
        nonlocal t
        while stack and stack[-1][1] <= s:
            cat, end = stack.pop()
            if end > t:
                out.append((cat, t, end))
                t = end

    for cat, s, e in sorted(spans, key=lambda x: (x[1], -x[2])):
        close_until(s)
        if stack:
            if s > t:
                out.append((stack[-1][0], t, s))
            e = min(e, stack[-1][1])
        t = s
        stack.append((cat, e))
    close_until(float("inf"))
    return out


def _overlay(pieces: Sequence[tuple], segs: Sequence[Span]) -> List[tuple]:
    """Cut each ``(start, end, *tags)`` piece (sorted, disjoint) by the
    segments (sorted, disjoint): ``(start, end, *tags, category)``, with
    ``None`` where no segment covers it."""
    out, j = [], 0
    for piece in pieces:
        ps, pe, tags = piece[0], piece[1], piece[2:]
        while j < len(segs) and segs[j][2] <= ps:
            j += 1
        t, k = ps, j
        while k < len(segs) and segs[k][1] < pe:
            cat, ss, se = segs[k]
            lo, hi = max(ss, t), min(se, pe)
            if hi > lo:
                if lo > t:
                    out.append((t, lo, *tags, None))
                out.append((lo, hi, *tags, cat))
                t = hi
            k += 1
        if pe > t:
            out.append((t, pe, *tags, None))
    return out


def window_gaps(dev: Sequence[devtrace.Interval],
                window: Tuple[float, float]) -> List[Tuple[float, float]]:
    """The idle gaps of the window: what no device op covers."""
    w0, w1 = window
    busy = devtrace.union([(max(s, w0), min(e, w1)) for _, s, e in dev
                           if e > w0 and s < w1])
    gaps, t = [], w0
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if w1 > t:
        gaps.append((t, w1))
    return gaps


def idle_by_span(dev: Sequence[devtrace.Interval],
                 host: Sequence[devtrace.Interval], spans: Sequence[Span],
                 anchors: Tuple[float, float]) -> Optional[dict]:
    """Idle seconds of the window per program category and, for idle no
    program span covers, per harness label (``by_span``); and per harness
    label, split by category (``by_label``, ``-`` for uncovered).  None
    without a window range or without anchors."""
    win = [(s, e) for n, s, e in host if n == devtrace.WINDOW]
    if not win or anchors is None:
        return None
    w0, w1 = win[0]
    to_prof = clock_map(anchors[0], anchors[1], w0, w1)
    segs = innermost([(c, to_prof(s), to_prof(e)) for c, s, e in spans
                      if c not in SKIP])
    # the harness's ranges never nest, so they are segments too
    labels = sorted((x for x in host if x[0] != devtrace.WINDOW),
                    key=lambda x: x[1])
    pieces = _overlay(window_gaps(dev, (w0, w1)), labels)
    by_span: Dict[str, float] = {}
    by_label: Dict[str, Dict[str, float]] = {}
    for s, e, label, cat in _overlay(pieces, segs):
        label = label or devtrace.UNLABELLED
        sec = (e - s) / 1e6
        key = cat or label
        by_span[key] = by_span.get(key, 0.0) + sec
        row = by_label.setdefault(label, {})
        row[cat or UNCOVERED] = row.get(cat or UNCOVERED, 0.0) + sec
    return {"by_span": by_span, "by_label": by_label}


def covered_share(by_label: Dict[str, Dict[str, float]], label: str
                  ) -> Optional[float]:
    """The share of a harness label's idle time that a program span
    covers."""
    row = by_label.get(label)
    if not row:
        return None
    total = sum(row.values())
    return 1.0 - row.get(UNCOVERED, 0.0) / total if total else None
