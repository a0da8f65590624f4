"""Human-readable text timeline report over a :class:`repro_torch.obs.Tracer`.

Renders the virtual device timeline the Chrome export holds — per-category
busy time, per-lane (die / channel / host-link) occupancy with utilization
against the makespan, and the per-wave schedule table (which dies ran what,
concurrently, for how long) — so a terminal user sees the schedule the
ledger's ``makespan_us()`` scalar summarises.
"""
from __future__ import annotations

from typing import Dict, List

__all__ = ["timeline_report"]


def _fmt_table(headers: List[str], rows: List[List[str]]) -> List[str]:
    widths = [max(len(h), *(len(r[i]) for r in rows)) if rows else len(h)
              for i, h in enumerate(headers)]
    def line(cells):
        return "  " + "  ".join(c.ljust(w) for c, w in zip(cells, widths))
    return [line(headers),
            line(["-" * w for w in widths])] + [line(r) for r in rows]


def timeline_report(tracer, ledger=None) -> str:
    """Per-category, per-lane, and per-wave breakdown of the traced device
    timeline.  ``ledger`` adds the serial-vs-parallel headline numbers."""
    lanes = tracer.lanes()
    makespan = tracer.makespan_us()
    out: List[str] = ["== device timeline =="]
    if ledger is not None:
        out.append(f"  makespan {ledger.makespan_us():.1f} us"
                   f"  (die-parallel {ledger.die_step_us:.1f}"
                   f" | channel {ledger.channel_step_us:.1f}"
                   f" | host-link {ledger.host_busy_us:.1f})"
                   f"  serial {ledger.serial_us():.1f} us"
                   f"  energy {ledger.energy_uj:.1f} uJ")
    else:
        out.append(f"  makespan {makespan:.1f} us")
    if tracer.dropped:
        out.append(f"  !! {tracer.dropped} spans dropped (max_spans cap)")

    # per-category busy time across all device lanes
    by_cat: Dict[str, List[float]] = {}
    for spans in lanes.values():
        for s in spans:
            by_cat.setdefault(s.category, []).append(s.dur_us)
    out.append("\n-- per category --")
    rows = [[cat, str(len(ds)), f"{sum(ds):.1f}"]
            for cat, ds in sorted(by_cat.items(),
                                  key=lambda kv: -sum(kv[1]))]
    out += _fmt_table(["category", "spans", "busy_us"], rows)

    # per-lane occupancy (dies first, then channels, then the host link)
    def lane_key(lane: str):
        kind, _, idx = lane.partition(" ")
        order = {"die": 0, "channel": 1}.get(kind, 2)
        return (order, int(idx) if idx.isdigit() else 0)

    out.append("\n-- per lane --")
    rows = []
    for lane in sorted(lanes, key=lane_key):
        spans = lanes[lane]
        busy = sum(s.dur_us for s in spans)
        end = max(s.end_us for s in spans)
        util = 100.0 * busy / makespan if makespan else 0.0
        rows.append([lane, str(len(spans)), f"{busy:.1f}", f"{end:.1f}",
                     f"{util:.0f}%"])
    out += _fmt_table(["lane", "spans", "busy_us", "end_us", "util"], rows)

    # per-wave schedule: die-step spans grouped by their step index
    steps: Dict[int, List] = {}
    for lane, spans in lanes.items():
        if not lane.startswith("die "):
            continue
        for s in spans:
            if "step" in s.args:
                steps.setdefault(s.args["step"], []).append(s)
    if steps:
        out.append("\n-- per wave (die dispatch steps) --")
        rows = []
        for step in sorted(steps):
            spans = steps[step]
            t0 = min(s.start_us for s in spans)
            dur = max(s.end_us for s in spans) - t0
            dies = ",".join(sorted({s.lane.split()[-1] for s in spans},
                                   key=int))
            label = max(spans, key=lambda s: s.dur_us).name
            rows.append([str(step), f"{t0:.1f}", f"{dur:.1f}",
                         f"{len(spans)}", dies[:24], label[:44]])
        out += _fmt_table(["wave", "start_us", "dur_us", "dies", "on", "what"],
                          rows)
    return "\n".join(out)
