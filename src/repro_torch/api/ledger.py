"""Unified timing/energy ledger for the compute-session layer.

This is the one accounting object threaded through every execution path —
the functional device, the FTL placement layer, and :class:`ComputeSession`
— replacing the ad-hoc per-module accounting that used to live in
the flash device.

Busy time is tracked two ways:

- **per-resource totals** (``die_busy_us`` / ``channel_busy_us``) — the
  serial accounting the per-page loops used to produce; ``serial_us()`` is
  their sum (everything on one die, nothing overlapped);
- **per schedule step** — each ``add_die_batch`` / ``add_channel_batch``
  call is one *parallel dispatch step*: all dies (channels) named in the
  call run concurrently, so the step contributes ``max`` over its per-die
  busy times.  ``die_step_us`` sums the step maxima — the die-parallel die
  time the executor's topology-aware schedule actually achieves, always
  between the busiest single die and ``serial_us()``.

**Inter-resource timing** is governed by ``mode``:

- ``"independent"`` (default, the historical model) — die steps, channel
  steps, and the host link each run on their own free-running timeline
  starting at 0; ``makespan_us()`` is their outer max.  Optimistic: it
  assumes transfers never wait for the senses that produce their data.
- ``"sync"`` — fully serialized: every step (die, channel, host) starts
  only after *everything* booked before it has finished.  Channel/host
  transfer time sits squarely on the critical path — the non-overlapped
  baseline the overlap mode is measured against.
- ``"overlap"`` — double-buffered channel/host pipelining: a channel step
  starts when its producing die work has finished (never before — a
  transfer cannot outrun its senses), but *later* waves' die steps overlap
  in-flight transfers.  ``drain_depth`` bounds the pipeline: a new die step
  stalls until the transfer ``drain_depth`` steps back has drained
  (``drain_depth=2`` is classic double buffering).  The host link likewise
  starts a transfer once its channel data has arrived, concurrent with
  later die/channel work.

In the dependency-aware modes the per-resource *end offsets*
(``die_end_us`` / ``channel_end_us`` / ``host_end_us``) exceed the busy
sums by any stall time, ``makespan_us()`` is the max end offset, and every
step is appended to ``step_log`` (with its schedule wave, when the caller
tags one) so a plan verifier's ``overlap-consistency`` invariant can
audit that a wave's transfer overlaps only *later* waves' die work, never
its own producers.
``overlapped_channel_us`` totals the channel busy time hidden behind
subsequent die steps — the pipelining win the overlap benchmark gates on.

A per-category breakdown (sense / program / erase / transfer) supports the
session's ``stats()`` reporting, and ``max_parallel_dies`` records the
widest concurrent dispatch observed.

When a span tracer is attached (``ledger.tracer``), every
batched entry additionally emits timed *spans* on virtual per-die /
per-channel / host-link lanes, with start offsets derived from this same
schedule-step model — each step's spans start at its computed start time,
so the exported timeline's longest lane equals ``makespan_us()`` by
construction in every mode, and in overlap
mode the channel/host-link spans visibly run concurrent with the next
wave's die spans.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Tuple

__all__ = ["Ledger", "LEDGER_MODES"]

#: accepted inter-resource timing models (see the module docstring)
LEDGER_MODES = ("independent", "sync", "overlap")

#: step_log entries kept before the log truncates (counters stay exact;
#: the overlap-consistency audit sees a bounded window on serving sessions)
MAX_STEP_LOG = 4096


@dataclasses.dataclass
class Ledger:
    """Per-resource busy-time accounting + total energy."""
    die_busy_us: Dict[int, float] = dataclasses.field(default_factory=dict)
    channel_busy_us: Dict[int, float] = dataclasses.field(default_factory=dict)
    host_busy_us: float = 0.0
    energy_uj: float = 0.0
    commands: int = 0
    # Busy-time breakdown by command category ('sense', 'program', 'erase', ...).
    category_us: Dict[str, float] = dataclasses.field(default_factory=dict)
    # Schedule-step (die-parallel) accounting: every add_*_batch call is one
    # parallel dispatch step contributing max(per-resource us) to the makespan.
    die_step_us: float = 0.0
    channel_step_us: float = 0.0
    die_steps: int = 0
    max_parallel_dies: int = 0
    #: inter-resource timing model: "independent" | "sync" | "overlap"
    mode: str = "independent"
    #: overlap mode: in-flight transfers a die step may run ahead of
    drain_depth: int = 2
    #: timeline end offsets per resource (== the busy sums in independent
    #: mode; include stall time in the dependency-aware modes)
    die_end_us: float = 0.0
    channel_end_us: float = 0.0
    host_end_us: float = 0.0
    #: channel busy time hidden behind later die steps (overlap mode only)
    overlapped_channel_us: float = 0.0
    #: die steps that started while a channel transfer was still in flight
    overlapped_steps: int = 0
    #: (kind, epoch, wave, start_us, end_us) per step in the dependency-aware
    #: modes — the overlap-consistency invariant's input.  ``wave`` is the
    #: executor-tagged schedule wave (None for untagged device commands),
    #: ``epoch`` groups the steps of one lowered plan.
    step_log: List[Tuple[str, int, Optional[int], float, float]] = \
        dataclasses.field(default_factory=list, repr=False)
    step_epoch: int = 0
    #: optional span tracer receiving a timed span per entry
    tracer: Optional[object] = dataclasses.field(default=None, repr=False,
                                                 compare=False)
    _channel_ends: List[float] = dataclasses.field(default_factory=list,
                                                   repr=False)

    # -- mode plumbing -------------------------------------------------------
    def set_mode(self, mode: str, drain_depth: "int | None" = None) -> None:
        """Switch the inter-resource timing model (reset first when steps
        were already booked under another mode — offsets don't translate)."""
        if mode not in LEDGER_MODES:
            raise ValueError(f"unknown ledger mode {mode!r}; "
                             f"pick one of {LEDGER_MODES}")
        self.mode = mode
        if drain_depth is not None:
            assert drain_depth >= 1, drain_depth
            self.drain_depth = int(drain_depth)

    def begin_epoch(self) -> int:
        """Start a new step-log epoch (the executor calls this once per
        lowered plan, so wave tags are comparable only within one epoch)."""
        self.step_epoch += 1
        return self.step_epoch

    def _log(self, kind: str, wave: Optional[int], t0: float,
             t1: float) -> None:
        if self.mode != "independent" and len(self.step_log) < MAX_STEP_LOG:
            self.step_log.append((kind, self.step_epoch, wave, t0, t1))

    def _sync_meta(self) -> None:
        meta = getattr(self.tracer, "meta", None)
        if meta is not None:
            meta["overlap_mode"] = self.mode
            meta["drain_depth"] = self.drain_depth
            meta["overlapped_channel_us"] = round(self.overlapped_channel_us,
                                                  6)

    # -- step start offsets (the dependency model) ---------------------------
    def _die_start(self) -> float:
        if self.mode == "sync":
            return max(self.die_end_us, self.channel_end_us, self.host_end_us)
        if self.mode == "overlap" and len(self._channel_ends) >= self.drain_depth:
            # double-buffer backpressure: at most drain_depth transfers may
            # be in flight behind the sensing front
            return max(self.die_end_us,
                       self._channel_ends[-self.drain_depth])
        return self.die_end_us

    def _channel_start(self) -> float:
        if self.mode == "sync":
            return max(self.die_end_us, self.channel_end_us, self.host_end_us)
        if self.mode == "overlap":
            # never before the die work that produced the data
            return max(self.channel_end_us, self.die_end_us)
        return self.channel_end_us

    def _host_start(self) -> float:
        if self.mode == "sync":
            return max(self.die_end_us, self.channel_end_us, self.host_end_us)
        if self.mode == "overlap":
            # the host link streams data the channel has already delivered
            return max(self.host_end_us, self.channel_end_us)
        return self.host_end_us

    # -- booking -------------------------------------------------------------
    def add_die(self, die: int, us: float, uj: float = 0.0,
                category: str = "sense", label: "str | None" = None,
                wave: "int | None" = None) -> None:
        self.add_die_batch({die: us}, uj, commands=1, category=category,
                           label=label, wave=wave)

    def add_die_batch(self, per_die_us: Mapping[int, float], uj: float = 0.0,
                      commands: int = 1, category: str = "sense",
                      label: "str | None" = None,
                      wave: "int | None" = None,
                      rids: "Tuple[int, ...] | None" = None) -> None:
        """Account one parallel dispatch step in one call (no O(pages) loop):
        ``per_die_us`` is pre-aggregated busy time per die; the named dies
        run concurrently, so the step takes ``max`` of their busy times.
        ``label`` names the step's spans on an attached tracer; ``wave``
        tags the executor schedule wave for the overlap audit; ``rids``
        tags the owning serving-request ids for per-request attribution."""
        total = 0.0
        for die, us in per_die_us.items():
            self.die_busy_us[die] = self.die_busy_us.get(die, 0.0) + us
            total += us
        self.category_us[category] = self.category_us.get(category, 0.0) + total
        self.energy_uj += uj
        self.commands += commands
        if per_die_us:
            dur = max(per_die_us.values())
            t0 = self._die_start()
            # channel time hidden behind this die step (the pipelining win)
            overlap_us = max(0.0, min(t0 + dur, self.channel_end_us) - t0)
            if self.mode == "overlap" and overlap_us > 0.0:
                self.overlapped_channel_us += overlap_us
                self.overlapped_steps += 1
            if self.tracer is not None:
                args = {"commands": commands}
                if wave is not None:
                    args["wave"] = wave
                    args["epoch"] = self.step_epoch
                if rids:
                    args["rids"] = list(rids)
                if self.mode == "overlap" and overlap_us > 0.0:
                    args["overlap_us"] = round(overlap_us, 6)
                self.tracer.die_step(t0, per_die_us, category, label, args)
                self._sync_meta()
            self.die_end_us = t0 + dur
            self.die_step_us += dur
            self.die_steps += 1
            self.max_parallel_dies = max(self.max_parallel_dies, len(per_die_us))
            self._log("die", wave, t0, t0 + dur)

    def add_channel(self, ch: int, us: float,
                    label: "str | None" = None,
                    wave: "int | None" = None) -> None:
        self.add_channel_batch({ch: us}, label=label, wave=wave)

    def add_channel_batch(self, per_channel_us: Mapping[int, float],
                          label: "str | None" = None,
                          category: str = "dma",
                          wave: "int | None" = None,
                          rids: "Tuple[int, ...] | None" = None) -> None:
        """Batched NAND->controller transfer accounting, one parallel step per
        call (channels named together stream concurrently).  ``category``
        lets recovery re-senses book their transfers separately from the
        primary wave's DMA."""
        total = 0.0
        for ch, us in per_channel_us.items():
            self.channel_busy_us[ch] = self.channel_busy_us.get(ch, 0.0) + us
            total += us
        self.category_us[category] = self.category_us.get(category, 0.0) + total
        if per_channel_us:
            dur = max(per_channel_us.values())
            t0 = self._channel_start()
            if self.tracer is not None:
                args = {}
                if wave is not None:
                    args = {"wave": wave, "epoch": self.step_epoch}
                if rids:
                    args["rids"] = list(rids)
                self.tracer.channel_step(t0, per_channel_us, label,
                                         args or None)
                self._sync_meta()
            self.channel_end_us = t0 + dur
            self.channel_step_us += dur
            self._channel_ends.append(self.channel_end_us)
            if len(self._channel_ends) > max(self.drain_depth, 8):
                del self._channel_ends[0]
            self._log("channel", wave, t0, t0 + dur)

    def add_host(self, us: float, label: "str | None" = None) -> None:
        t0 = self._host_start()
        if self.tracer is not None:
            self.tracer.host_step(t0, us, label)
            self._sync_meta()
        self.host_end_us = t0 + us
        self.host_busy_us += us
        self.category_us["host"] = self.category_us.get("host", 0.0) + us
        self._log("host", None, t0, t0 + us)

    # -- derived scalars -----------------------------------------------------
    def serial_us(self) -> float:
        """Fully-serialized die time: the sum of every die's busy time (what
        a single-die device would take).  ``die_step_us <= serial_us()``
        always; ``makespan_us()`` may exceed it when channel/host transfer
        time dominates die time."""
        return sum(self.die_busy_us.values())

    def makespan_us(self) -> float:
        """Die-parallel makespan: per schedule step, concurrent dies overlap
        (max per step); steps serialize (sum over steps).  Across resources
        the ``mode`` governs: independent timelines take the outer max
        (their end offsets equal the busy sums); the dependency-aware modes
        take the latest end offset, which includes any stall time."""
        return max(self.die_end_us, self.channel_end_us, self.host_end_us)

    def reset(self) -> None:
        """Zero every accumulator — including the overlap/pipeline state
        (end offsets, overlap counters, step log, drain history) — keeping
        only the configured ``mode`` / ``drain_depth``.  Repeated-
        materialize benchmark loops call this between iterations instead of
        rebuilding sessions.  An attached tracer keeps its spans — clear it
        separately via ``tracer.clear()``."""
        self.die_busy_us.clear()
        self.channel_busy_us.clear()
        self.category_us.clear()
        self.host_busy_us = 0.0
        self.energy_uj = 0.0
        self.commands = 0
        self.die_step_us = 0.0
        self.channel_step_us = 0.0
        self.die_steps = 0
        self.max_parallel_dies = 0
        self.die_end_us = 0.0
        self.channel_end_us = 0.0
        self.host_end_us = 0.0
        self.overlapped_channel_us = 0.0
        self.overlapped_steps = 0
        self.step_log.clear()
        self.step_epoch = 0
        self._channel_ends.clear()

    def summary(self) -> dict:
        """Every scalar the makespan model derives from — including the
        per-resource busy sums (``die_parallel_us`` / ``channel_step_us``
        / ``host_busy_us``) and end offsets, so ``makespan_us`` is
        reconstructable from the summary dict alone in every mode."""
        return {
            "makespan_us": self.makespan_us(),
            "mode": self.mode,
            "die_parallel_us": self.die_step_us,
            "channel_step_us": self.channel_step_us,
            "host_busy_us": self.host_busy_us,
            "die_end_us": self.die_end_us,
            "channel_end_us": self.channel_end_us,
            "host_end_us": self.host_end_us,
            "overlapped_channel_us": self.overlapped_channel_us,
            "overlapped_steps": self.overlapped_steps,
            "drain_depth": self.drain_depth,
            "serial_us": self.serial_us(),
            "die_steps": self.die_steps,
            "energy_uj": self.energy_uj,
            "commands": self.commands,
            "max_parallel_dies": self.max_parallel_dies,
            "category_us": dict(self.category_us),
        }
