"""Reduce a ``torch.profiler`` trace of the measured window to numbers.

The harness brackets the window with the host range ``mcbench.window`` and
each call into a layer of the program with a range named ``mcbench.<what>``
(they never nest).  :func:`summarize` works on plain ``(name, start_us,
end_us)`` tuples, so it runs without a card.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

Interval = Tuple[str, float, float]
WINDOW = "mcbench.window"
PREFIX = "mcbench."
#: the label of host time outside every harness range (the loop itself)
UNLABELLED = "mcbench.loop"
TOP = 10


def from_profiler(prof) -> Tuple[List[Interval], List[Interval]]:
    """(device ops, harness host ranges) of a finished profiler session."""
    from torch.autograd import DeviceType

    dev, host = [], []
    for e in prof.events():
        span = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.name.startswith(PREFIX):
            # a harness range; its mirror on the device's timeline (a user
            # annotation) is no device work
            if e.device_type == DeviceType.CPU:
                host.append(span)
        elif e.device_type == DeviceType.CUDA:
            dev.append(span)
    return dev, host


def is_host_copy(name: str) -> bool:
    return name.startswith("Memcpy") and ("DtoH" in name or "HtoD" in name)


def is_dtoh(name: str) -> bool:
    return name.startswith("Memcpy") and "DtoH" in name


def union(spans: Sequence[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _label_gaps(gaps: List[Tuple[float, float]],
                labels: List[Interval]) -> Dict[str, float]:
    """Idle microseconds per harness label (two pointers over sorted,
    disjoint lists); idle time no label covers goes to ``UNLABELLED``."""
    labels = sorted(labels, key=lambda x: x[1])
    idle: Dict[str, float] = {}
    j = 0
    for gs, ge in gaps:
        covered = 0.0
        while j < len(labels) and labels[j][2] <= gs:
            j += 1
        k = j
        while k < len(labels) and labels[k][1] < ge:
            name, ls, le = labels[k]
            part = min(ge, le) - max(gs, ls)
            if part > 0:
                idle[name] = idle.get(name, 0.0) + part
                covered += part
            k += 1
        rest = (ge - gs) - covered
        if rest > 0:
            idle[UNLABELLED] = idle.get(UNLABELLED, 0.0) + rest
    return idle


def summarize(dev: List[Interval], host: List[Interval]) -> Optional[dict]:
    """Device numbers of the window, or None when the trace holds no
    window range or no device op inside it (then nothing is measured)."""
    win = [(s, e) for n, s, e in host if n == WINDOW]
    if not win:
        return None
    w0, w1 = win[0]
    inside = [(n, max(s, w0), min(e, w1)) for n, s, e in dev
              if e > w0 and s < w1]
    if not inside:
        return None
    busy = union([(s, e) for _, s, e in inside])
    busy_us = sum(e - s for s, e in busy)
    gaps, t = [], w0
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if w1 > t:
        gaps.append((t, w1))
    by_name: Dict[str, float] = {}
    for n, s, e in inside:
        by_name[n] = by_name.get(n, 0.0) + (e - s)
    idle = _label_gaps(gaps, [x for x in host if x[0] != WINDOW])
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    top_idle = sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]
    return {
        "window_s": (w1 - w0) / 1e6,
        "busy_s": busy_us / 1e6,
        # device work (kernels, memsets, copies on the card), host copies out
        "work_s": sum(e - s for n, s, e in inside
                      if not is_host_copy(n)) / 1e6,
        "dtoh_s": sum(e - s for n, s, e in inside if is_dtoh(n)) / 1e6,
        "device_ops": [[n, us / 1e6] for n, us in top],
        "idle_gaps": [[n, us / 1e6] for n, us in top_idle],
    }
