"""The one traffic generator: it reads a mix's data file and draws the
queries (and, for an open loop, their due times) from the seed.

A mix file (``traffic/<mix>.json``) names a ``loop`` and a ``query`` kind,
plus the keys that loop and that kind read; any other key is refused.

- ``"loop": "closed"``: ``clients`` (default 1) clients, each with one query
  in flight and its own query stream; optional ``sample_answers``, the size
  of a seeded reservoir of answers to judge (default: every answer).
- ``"loop": "open"``: ``arrivals`` (``poisson`` at ``rate_per_s``, or
  ``on_off``, where the gaps are drawn at ``rate_per_s * period_s / on_s``
  and only the first ``on_s`` of each ``period_s`` runs the arrival clock).

The query kind is a module ``queries/<kind>.py`` (see
:mod:`mcbench.queries`); the keys it reads are its ``KEYS``.  Two kinds of
choice are written as data, so a mix can skew them without new code:

- a **size** (what sets a query's work), ``{"values": [...]}`` or
  ``{"range": [lo, hi]}`` (inclusive), with ``"draw": "even"`` (every value
  once in each block) or ``"draw": "zipf"`` (``s``, ``block``: a block of
  ``block`` entries whose counts follow Zipf weights ``1 / rank**s`` over the
  values in order, by largest remainder).  Every seed gets the same
  multiset of sizes, in another order: blocks are shuffled by the seed.
- a **position** (where a query reads, not how much), ``{"draw":
  "uniform"}`` or ``{"draw": "zipf", "s": ...}`` (rank 0, the first in the
  kind's stated order, the most likely), drawn per query from the seed.

An open loop's inter-arrival gaps are one stratified exponential set (the
same for every seed), shuffled by the seed.
"""
from __future__ import annotations

import itertools
import json
from pathlib import Path
from typing import Iterator, List, Optional, Tuple

import numpy as np

from mcbench import data, queries as kinds

HERE = Path(__file__).resolve().parent
Query = Tuple

LOOP_KEYS = {"closed": {"loop", "query", "clients", "sample_answers"},
             "open": {"loop", "query", "arrivals"}}
ARRIVAL_KEYS = {"poisson": {"rate_per_s"},
                "on_off": {"rate_per_s", "period_s", "on_s"}}
SIZE_KEYS = {"even": {"values", "range", "draw"},
             "zipf": {"values", "range", "draw", "s", "block"}}
POSITION_KEYS = {"uniform": {"draw"}, "zipf": {"draw", "s"}}


def load_mix(name: str) -> dict:
    return check_mix(json.loads((HERE / "traffic" / f"{name}.json")
                                .read_text()))


def check_mix(mix: dict) -> dict:
    """Refuse a mix that sets a key nothing reads, or a value the loops
    cannot run."""
    loop = mix.get("loop")
    if loop not in LOOP_KEYS:
        raise ValueError(f"loop {loop!r} is none of {sorted(LOOP_KEYS)}")
    kind = kinds.kind(mix["query"])
    allowed = LOOP_KEYS[loop] | set(kind.KEYS)
    if loop == "open":
        arr = mix.get("arrivals")
        if arr not in ARRIVAL_KEYS:
            raise ValueError(f"arrivals {arr!r} is none of "
                             f"{sorted(ARRIVAL_KEYS)}")
        missing = ARRIVAL_KEYS[arr] - set(mix)
        if missing:
            raise ValueError(f"{arr} arrivals need {sorted(missing)}")
        allowed = {"loop", "query", "arrivals"} | ARRIVAL_KEYS[arr] \
            | set(kind.KEYS)
    else:
        clients = mix.get("clients", 1)
        if not isinstance(clients, int) or clients < 1:
            raise ValueError(f"clients must be a whole number >= 1, "
                             f"got {clients!r}")
    unread = set(mix) - allowed
    if unread:
        raise ValueError(f"mix keys {sorted(unread)} are read by nothing "
                         f"(a {loop} loop of {mix['query']} reads "
                         f"{sorted(allowed)})")
    kind.check(mix)
    return mix


def sizes(spec: dict) -> list:
    """One block's multiset of a size choice, in the stated order."""
    draw = spec.get("draw", "even")
    if draw not in SIZE_KEYS or set(spec) - SIZE_KEYS[draw]:
        raise ValueError(f"size choice {spec} (draws: {sorted(SIZE_KEYS)})")
    if ("values" in spec) == ("range" in spec):
        raise ValueError(f"size choice {spec} needs values or range")
    if "values" in spec:
        vals = list(spec["values"])
    else:
        lo, hi = spec["range"]
        vals = list(range(int(lo), int(hi) + 1))
    if not vals:
        raise ValueError(f"size choice {spec} has no values")
    if draw == "even":
        return vals
    if not {"s", "block"} <= set(spec):
        raise ValueError(f"a zipf size choice needs s and block: {spec}")
    n = int(spec["block"])
    w = 1.0 / np.arange(1, len(vals) + 1) ** float(spec["s"])
    share = n * w / w.sum()
    counts = np.floor(share).astype(int)
    for i in np.argsort(-(share - counts), kind="stable")[: n - counts.sum()]:
        counts[i] += 1
    return [v for v, c in zip(vals, counts) for _ in range(int(c))]


def check_position(spec: dict) -> None:
    draw = spec.get("draw")
    if draw not in POSITION_KEYS or set(spec) != POSITION_KEYS[draw]:
        raise ValueError(f"position choice {spec} (draws: "
                         f"{sorted(POSITION_KEYS)})")


def position(rng: np.random.Generator, n: int, spec: dict) -> int:
    """One position in ``range(n)``, drawn as ``spec`` says."""
    if spec["draw"] == "uniform":
        return int(rng.integers(0, n))
    w = 1.0 / np.arange(1, n + 1) ** float(spec["s"])
    return int(rng.choice(n, p=w / w.sum()))


def _rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % data.SEED_MOD, *stream])


def queries(mix: dict, cfg: dict, seed: int,
            client: int = 0) -> Iterator[Query]:
    """One client's endless query sequence of a mix on a configuration:
    shuffled blocks of the kind's ``block``."""
    rng = _rng(seed, 1, client) if client else _rng(seed, 1)
    kind = kinds.kind(mix["query"])
    kind.block(mix, cfg, rng)                  # refuses a bad mix up front
    while True:
        items = kind.block(mix, cfg, rng)
        for i in rng.permutation(len(items)):
            yield items[i]


def arrivals(mix: dict, seed: int, seconds: float,
             rate_per_s: Optional[float] = None) -> List[float]:
    """Due times (s from the window's start) of an open loop's requests in
    a window of ``seconds``: ``round(rate * seconds)`` of them, the same
    count and gap set for every seed, all inside the window."""
    rate = float(rate_per_s if rate_per_s is not None else mix["rate_per_s"])
    if rate <= 0:
        raise ValueError(f"an open loop needs a rate above 0, got {rate}")
    n = max(1, round(rate * seconds))
    u = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-u)
    gaps = _rng(seed, 2).permutation(gaps)
    if mix["arrivals"] == "poisson":
        clock = seconds
    elif mix["arrivals"] == "on_off":
        period, on = float(mix["period_s"]), float(mix["on_s"])
        clock = seconds * on / period
    else:
        raise ValueError(f"unknown arrivals {mix['arrivals']!r}")
    # scale the set so its sum ends half a mean gap before the clock runs out
    gaps *= clock * (n - 0.5) / n / gaps.sum()
    t = np.cumsum(gaps) - gaps[0] / 2
    if mix["arrivals"] == "on_off":
        t = np.floor(t / on) * period + np.mod(t, on)
    return [float(x) for x in t]


def schedule(mix: dict, cfg: dict, seed: int, seconds: float,
             rate_per_s: Optional[float] = None) -> List[Tuple[float, Query]]:
    """An open loop's ``(due_s, query)`` list for one window."""
    due = arrivals(mix, seed, seconds, rate_per_s)
    return list(zip(due, itertools.islice(queries(mix, cfg, seed), len(due))))


def distinct_queries(mix: dict, cfg: dict) -> List[Query]:
    """Every query the mix can draw on a configuration (the warm-up set)."""
    return kinds.kind(mix["query"]).distinct(mix, cfg)
