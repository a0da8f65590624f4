"""Keyed compilation caches with hit/miss counters.

- :class:`PlanCache` — ``plan_op`` compiles a Table-1 op into quantized DAC
  references for a chip model; the session layer plans once per
  ``(op, chip, inverse-read)`` key (and once per encoded-plan key) and
  replays the cached :class:`ReadPlan` for every later sense.
- :class:`ExecutableCache` — the executor caches the runner it builds for
  a lowered plan signature (DAG shape + page counts + backend), so a
  repeated materialize of the same expression shape skips the build.

The counters are typed :class:`~repro_torch.obs.metrics.Counter` metrics in
a per-cache registry, readable as plain ints.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Dict, Hashable, Optional, Tuple

from repro_torch.core import tlc
from repro_torch.core.mcflash import ReadPlan, plan_op
from repro_torch.core.vth_model import ChipModel
from repro_torch.obs.metrics import MetricsRegistry

PlanKey = Tuple[str, ChipModel, bool]


class PlanCache:
    """Caches compiled :class:`ReadPlan`s per (op, chip model, inverse-read)."""

    def __init__(self) -> None:
        self._plans: Dict[PlanKey, ReadPlan] = {}
        self.metrics = MetricsRegistry()
        self._hits = self.metrics.counter("hits", "plan cache hits")
        self._misses = self.metrics.counter("misses", "plans compiled")
        self._miss_counts: Dict[PlanKey, int] = {}

    @property
    def hits(self) -> int:
        return int(self._hits.value)

    @property
    def misses(self) -> int:
        return int(self._misses.value)

    def get(self, op: str, chip: ChipModel, use_inverse_read: bool = True) -> ReadPlan:
        key: PlanKey = (op, chip, bool(use_inverse_read))
        plan = self._plans.get(key)
        if plan is None:
            plan = plan_op(op, chip, use_inverse_read)
            self._plans[key] = plan
            self._misses.add()
            self._miss_counts[key] = self._miss_counts.get(key, 0) + 1
        else:
            self._hits.add()
        return plan

    def get_encoded(self, op: str, roles: Tuple[str, ...], chip,
                    encoding: str) -> ReadPlan:
        """Cached multi-level-encoding plan: ``op`` over co-located operands
        stored in ``roles`` under a TLC / reduced-MLC encoding.  Keys embed
        the encoding; roles sort into canonical order (every multi-operand
        op is commutative), so (a&b&c) and (c&b&a) share one plan."""
        if encoding not in tlc.ENCODINGS:
            raise ValueError(f"unknown encoding {encoding!r}; "
                             f"pick one of {tlc.ENCODINGS}")
        roles = tuple(sorted(roles))
        key = (encoding, op, roles, chip)
        plan = self._plans.get(key)
        if plan is None:
            plan = self._plans[key] = tlc.plan_encoded(op, roles, chip,
                                                       encoding)
            # the op label must name its encoding: cache keys and the
            # executor's plan signatures all embed it
            assert plan.op.startswith(f"{encoding}:"), plan.op
            self._misses.add()
            self._miss_counts[key] = self._miss_counts.get(key, 0) + 1
        else:
            self._hits.add()
        return plan

    def clear(self) -> None:
        self._plans.clear()
        self._miss_counts.clear()
        self.metrics.reset()

    def __len__(self) -> int:
        return len(self._plans)

    def stats(self) -> dict:
        return {"hits": self.hits, "misses": self.misses, "entries": len(self._plans)}


class ExecutableCache:
    """LRU cache of built runners (or any expensive artefact) per key.

    ``get(key, build)`` returns the cached artefact for ``key`` or calls
    ``build()`` once and stores it.  One instance lives on the
    :class:`~repro_torch.flash.device.FlashDevice` (``device.executables``)
    so every session on that device shares it; keys embed the backend.
    ``capacity`` bounds the entry count (``None`` disables eviction).
    """

    DEFAULT_CAPACITY = 128

    def __init__(self, capacity: Optional[int] = DEFAULT_CAPACITY) -> None:
        if capacity is not None and capacity < 1:
            raise ValueError(capacity)
        self.capacity = capacity
        self._entries: "OrderedDict[Hashable, object]" = OrderedDict()
        self.metrics = MetricsRegistry()
        self._hits = self.metrics.counter("hits", "executable replays")
        self._misses = self.metrics.counter("misses", "executables built")
        self._evictions = self.metrics.counter("evictions", "LRU evictions")

    @property
    def hits(self) -> int:
        return int(self._hits.value)

    @property
    def misses(self) -> int:
        return int(self._misses.value)

    @property
    def evictions(self) -> int:
        return int(self._evictions.value)

    def get(self, key: Hashable, build: Callable[[], object]) -> object:
        entry = self._entries.get(key)
        if entry is None:
            entry = self._entries[key] = build()
            self._misses.add()
            if self.capacity is not None:
                while len(self._entries) > self.capacity:
                    self._entries.popitem(last=False)
                    self._evictions.add()
        else:
            self._entries.move_to_end(key)
            self._hits.add()
        return entry

    def __contains__(self, key: Hashable) -> bool:
        return key in self._entries

    def clear(self) -> None:
        self._entries.clear()
        self.metrics.reset()

    def __len__(self) -> int:
        return len(self._entries)

    def stats(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "entries": len(self._entries), "evictions": self.evictions,
                "capacity": self.capacity}
