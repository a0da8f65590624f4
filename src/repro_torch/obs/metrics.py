"""Typed metrics: Counter / Gauge / Histogram + a named registry.

Every layer of the stack used to grow ad-hoc integer attributes
(``ComputeSession.sense_batches``, ``PlanCache.hits``, ...) with no shared
reset / introspection story.  This module gives them one home:

- :class:`Counter`   — monotonically increasing count (``add``),
- :class:`Gauge`     — last-set value, with a ``set_max`` high-watermark
  helper (e.g. widest concurrent-die dispatch observed),
- :class:`Histogram` — streaming count/sum/min/max over observations
  (e.g. dies per schedule wave, operands per fused megakernel),
- :class:`MetricsRegistry` — get-or-create by name, ``as_dict()`` snapshot,
  and ``reset()`` so repeated-materialize benchmark loops stop accumulating
  counts across iterations.

The registry is dependency-free (no torch, no package imports) so it can sit
under every layer — session, caches, tracer — without layering cycles.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterator, Union

__all__ = ["Counter", "Gauge", "Histogram", "Metric", "MetricsRegistry"]

Number = Union[int, float]


@dataclasses.dataclass
class Metric:
    """Base of every typed metric: a name, a one-line description, a value."""
    name: str
    description: str = ""

    def reset(self) -> None:
        raise NotImplementedError

    @property
    def value(self) -> Number:
        raise NotImplementedError


@dataclasses.dataclass
class Counter(Metric):
    """Monotonically increasing count."""
    _value: Number = 0

    def add(self, n: Number = 1) -> None:
        assert n >= 0, f"Counter {self.name!r} can only increase (got {n})"
        self._value += n

    inc = add

    @property
    def value(self) -> Number:
        return self._value

    def reset(self) -> None:
        self._value = 0


@dataclasses.dataclass
class Gauge(Metric):
    """Last-set value; ``set_max`` keeps a high-watermark."""
    _value: Number = 0

    def set(self, v: Number) -> None:
        self._value = v

    def set_max(self, v: Number) -> None:
        self._value = max(self._value, v)

    @property
    def value(self) -> Number:
        return self._value

    def reset(self) -> None:
        self._value = 0


@dataclasses.dataclass
class Histogram(Metric):
    """Streaming summary (count / sum / min / max) of observations."""
    count: int = 0
    total: float = 0.0
    min: float = math.inf
    max: float = -math.inf

    def observe(self, v: Number) -> None:
        self.count += 1
        self.total += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    @property
    def value(self) -> dict:
        return self.summary()

    def summary(self) -> dict:
        return {"count": self.count, "sum": self.total, "mean": self.mean,
                "min": self.min if self.count else 0.0,
                "max": self.max if self.count else 0.0}

    def reset(self) -> None:
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf


class MetricsRegistry:
    """Named get-or-create store of typed metrics.

    ``counter/gauge/histogram`` return the existing metric when the name is
    already registered (type-checked), so instrumentation points can look
    metrics up by name without threading objects around.
    """

    def __init__(self) -> None:
        self._metrics: Dict[str, Metric] = {}

    def _get_or_create(self, cls, name: str, description: str) -> Metric:
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls(name, description)
        elif not isinstance(m, cls):
            raise TypeError(f"metric {name!r} is a {type(m).__name__}, "
                            f"not a {cls.__name__}")
        return m

    def counter(self, name: str, description: str = "") -> Counter:
        return self._get_or_create(Counter, name, description)

    def gauge(self, name: str, description: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, description)

    def histogram(self, name: str, description: str = "") -> Histogram:
        return self._get_or_create(Histogram, name, description)

    def __getitem__(self, name: str) -> Metric:
        return self._metrics[name]

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def __iter__(self) -> Iterator[Metric]:
        return iter(self._metrics.values())

    def __len__(self) -> int:
        return len(self._metrics)

    def value(self, name: str) -> Number:
        return self._metrics[name].value

    def as_dict(self) -> dict:
        """Snapshot of every metric's value, keyed by name."""
        return {name: m.value for name, m in self._metrics.items()}

    def reset(self) -> None:
        for m in self._metrics.values():
            m.reset()
