"""Device-resident Vth storage: per-die shards of (slots, page_bits) buffers.

:class:`VthArena` is one preallocated float32 buffer on a torch device plus
a free-slot allocator: programming a wordline writes one row in place, and
a sense reads its rows in place, through an int32 table of their slots
(``FlashDevice.slot_tables``) and the buffer's base pointer, read at
dispatch since growing a shard replaces its buffer.  :meth:`VthArena.gather`
copies rows out (``index_select``) for the readers that need a copy.

:class:`ShardedVthArena` keeps one lazily-created :class:`VthArena` per die
that holds data, addressed by ``(die, slot)`` refs, so the executor's
per-die sense groups each read their own shard.

``devices=`` maps shards onto a list of torch devices round-robin (die
``d`` on entry ``d % len(devices)``; entries may repeat).  Each CUDA entry
owns its own stream, so on one card the die-disjoint units of a wave run
on distinct streams and may overlap; on the CPU entries are ``"cpu"`` and
there are no streams.  Data crossing streams is ordered with events
(``ready`` / ``to_compute``) and ``wait_stream``, never by synchronizing
the card, and every tensor one stream makes and another consumes is
marked with ``record_stream`` so the caching allocator does not reuse it
early.

Each shard grows geometrically (rows double, never shrink) and recycles
freed slots LIFO, in the same order as the JAX package's arena, so the same
writes land on the same ``(die, slot)`` refs in both.  Unlike the JAX
arena, writes update the buffer in place, which saves a copy of it.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.tlc import ENCODINGS

__all__ = ["VthArena", "ShardedVthArena", "SlotRef"]

#: address of one arena row: (die, slot-within-die-shard)
SlotRef = Tuple[int, int]


class VthArena:
    """Preallocated (slots, page_bits) float32 Vth storage with a free list."""

    def __init__(self, page_bits: int, init_slots: int = 16, *,
                 device: "torch.device | str"):
        self.page_bits = int(page_bits)
        self.device = torch.device(device)
        self._buf = torch.zeros((max(int(init_slots), 1), self.page_bits),
                                dtype=torch.float32, device=self.device)
        self._free: List[int] = list(range(self._buf.shape[0] - 1, -1, -1))
        self.grows = 0                   # observable reallocation count
        self._row_encoding: Dict[int, str] = {}   # slot -> row layout

    # -- allocation -----------------------------------------------------------
    @property
    def capacity(self) -> int:
        return int(self._buf.shape[0])

    @property
    def used(self) -> int:
        return self.capacity - len(self._free)

    def _grow(self, min_slots: int) -> None:
        new_cap = max(self.capacity * 2, min_slots)
        extra = torch.zeros((new_cap - self.capacity, self.page_bits),
                            dtype=torch.float32, device=self.device)
        old_cap = self.capacity
        self._buf = torch.cat([self._buf, extra], dim=0)
        self._free.extend(range(new_cap - 1, old_cap - 1, -1))
        self.grows += 1

    def alloc(self, n: int = 1, encoding: str = "mlc") -> List[int]:
        """Reserve ``n`` row slots (growing the buffer if exhausted), tagged
        with the row layout's encoding."""
        if encoding not in ENCODINGS:
            raise ValueError(encoding)
        if len(self._free) < n:
            self._grow(self.capacity + n - len(self._free))
        slots = [self._free.pop() for _ in range(n)]
        for s in slots:
            self._row_encoding[s] = encoding
        return slots

    def free(self, slots: Sequence[int]) -> None:
        for s in slots:
            self._row_encoding.pop(int(s), None)
        self._free.extend(int(s) for s in slots)

    def encoding_of(self, slot: int) -> str:
        """Row layout of an allocated slot."""
        return self._row_encoding[int(slot)]

    def retag(self, slot: int, encoding: str) -> None:
        """Update an allocated slot's row layout."""
        if encoding not in ENCODINGS or int(slot) not in self._row_encoding:
            raise ValueError((slot, encoding))
        self._row_encoding[int(slot)] = encoding

    def used_by_encoding(self) -> Dict[str, int]:
        """Allocated-slot count per row layout."""
        out: Dict[str, int] = {}
        for enc in self._row_encoding.values():
            out[enc] = out.get(enc, 0) + 1
        return out

    # -- data movement --------------------------------------------------------
    @property
    def buf(self) -> torch.Tensor:
        """The whole device-resident buffer."""
        return self._buf

    def rows(self, slots: Sequence[int]) -> torch.Tensor:
        """Row-index vector for a slot list."""
        return torch.tensor(list(slots), dtype=torch.long, device=self.device)

    def write(self, slots: Sequence[int], rows: torch.Tensor) -> None:
        """Write (len(slots), page_bits) rows into their slots, in place."""
        rows = rows.to(device=self.device, dtype=torch.float32)
        self._buf[self.rows(slots)] = rows.reshape(len(slots), self.page_bits)

    def gather(self, slots: Sequence[int]) -> torch.Tensor:
        """(len(slots), page_bits) copy of the requested rows — one gather."""
        return self._buf.index_select(0, self.rows(slots))

    def load(self, rows: np.ndarray) -> None:
        """Overwrite the first ``len(rows)`` slots with host Vth rows."""
        n = int(rows.shape[0])
        if n > self.capacity or rows.shape[1:] != (self.page_bits,):
            raise ValueError(f"rows {rows.shape} do not fit a shard of "
                             f"{(self.capacity, self.page_bits)}")
        self._buf[:n] = torch.tensor(rows, dtype=torch.float32,
                                     device=self.device)


class ShardedVthArena:
    """Per-die Vth shards addressed by ``(die, slot)`` refs.

    Shards are created lazily on first allocation for a die (a 128-die SSD
    config must not eagerly allocate 128 buffers), each an independent
    :class:`VthArena` with its own free list.

    ``device`` is the compute device.  ``devices`` (a list of torch
    devices, or ``"auto"`` for one entry per visible card) maps the shards
    onto entries round-robin; each CUDA entry gets its own stream (its
    "slot").  Unmapped (``None``), every shard lives on ``device`` and
    everything runs on the current stream.
    """

    def __init__(self, page_bits: int, n_dies: int = 1, init_slots: int = 16,
                 *, device: "torch.device | str", devices=None):
        if n_dies < 1:
            raise ValueError(n_dies)
        self.page_bits = int(page_bits)
        self.n_dies = int(n_dies)
        self.init_slots = int(init_slots)
        self.device = torch.device(device)
        if isinstance(devices, str) and devices == "auto":
            if self.device.type != "cuda" or not torch.cuda.is_available():
                raise ValueError('devices="auto" maps shards onto the visible '
                                 'cards; on the CPU pass a list of "cpu"')
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        self.devices: Optional[List[torch.device]] = (
            [torch.device(d) for d in devices] if devices else None)
        self._streams: List[Optional["torch.cuda.Stream"]] = []
        for d in self.devices or ():
            if d.type != self.device.type:
                raise ValueError(f"shard device {d} is not a {self.device.type}"
                                 " device like the compute device")
            # one stream per entry: a repeated entry is another stream on the
            # same card, so die-disjoint units can overlap on it
            self._streams.append(torch.cuda.Stream(device=d)
                                 if d.type == "cuda" else None)
        self._shards: Dict[int, VthArena] = {}

    # -- shards ---------------------------------------------------------------
    def shard(self, die: int) -> VthArena:
        """The (lazily-created) per-die shard backing ``die``."""
        if not 0 <= die < self.n_dies:
            raise IndexError((die, self.n_dies))
        arena = self._shards.get(die)
        if arena is None:
            arena = self._shards[die] = VthArena(
                self.page_bits, self.init_slots,
                device=self.device_of(die) or self.device)
        return arena

    @property
    def n_shards(self) -> int:
        return len(self._shards)

    @property
    def capacity(self) -> int:
        return sum(s.capacity for s in self._shards.values())

    @property
    def grows(self) -> int:
        return sum(s.grows for s in self._shards.values())

    def shard_stats(self) -> Dict[int, dict]:
        return {die: {"capacity": s.capacity, "used": s.used, "grows": s.grows,
                      "encodings": s.used_by_encoding()}
                for die, s in sorted(self._shards.items())}

    def used_by_encoding(self) -> Dict[str, int]:
        """Allocated-row count per row layout across all shards."""
        out: Dict[str, int] = {}
        for s in self._shards.values():
            for enc, n in s.used_by_encoding().items():
                out[enc] = out.get(enc, 0) + n
        return out

    # -- allocation -----------------------------------------------------------
    def alloc(self, die: int, n: int = 1,
              encoding: str = "mlc") -> List[SlotRef]:
        """Reserve ``n`` row slots on ``die``'s shard, tagged with the row
        layout's encoding."""
        return [(die, s) for s in self.shard(die).alloc(n, encoding)]

    def encoding_of(self, ref: SlotRef) -> str:
        die, slot = ref
        return self.shard(int(die)).encoding_of(slot)

    def retag(self, ref: SlotRef, encoding: str) -> None:
        die, slot = ref
        self.shard(int(die)).retag(slot, encoding)

    def free(self, refs: Sequence[SlotRef]) -> None:
        for die, slots in self._by_die(refs).items():
            self.shard(die).free(slots)

    @staticmethod
    def _by_die(refs: Sequence[SlotRef]) -> Dict[int, List[int]]:
        out: Dict[int, List[int]] = {}
        for die, slot in refs:
            out.setdefault(int(die), []).append(int(slot))
        return out

    # -- data movement --------------------------------------------------------
    def write(self, refs: Sequence[SlotRef], rows: torch.Tensor) -> None:
        """Write rows into refs — one in-place update per touched shard."""
        refs = list(refs)
        rows = rows.reshape(len(refs), self.page_bits)
        by_die: Dict[int, List[int]] = {}     # die -> positions in `refs`
        for i, (die, _) in enumerate(refs):
            by_die.setdefault(int(die), []).append(i)
        for die, idxs in by_die.items():
            pos = torch.tensor(idxs, dtype=torch.long, device=rows.device)
            self.shard(die).write([refs[i][1] for i in idxs],
                                  rows.index_select(0, pos))

    # -- placement ------------------------------------------------------------
    def slot_of(self, die: int) -> Optional[int]:
        """The entry (and stream slot) pinning ``die``'s shard, or None
        when the shards are unmapped."""
        return int(die) % len(self.devices) if self.devices else None

    def device_of(self, die: int) -> Optional[torch.device]:
        """The torch device holding ``die``'s shard (None when unmapped)."""
        return self.devices[self.slot_of(die)] if self.devices else None

    def compute_device(self) -> Optional[torch.device]:
        """The device combines and results run on (None when unmapped)."""
        return self.device if self.devices else None

    def shard_devices(self) -> Optional[List[torch.device]]:
        """The device backing each created shard (None when unmapped)."""
        if not self.devices:
            return None
        return [self.device_of(d) for d in sorted(self._shards)]

    def stream(self, slot: Optional[int]) -> "Optional[torch.cuda.Stream]":
        """The stream of entry ``slot`` (None for the compute stream, a CPU
        entry, or unmapped shards)."""
        return None if slot is None or not self.devices else self._streams[slot]

    def on_slot(self, slot: Optional[int]):
        """Context that makes entry ``slot``'s stream current (a no-op
        without a stream)."""
        s = self.stream(slot)
        return contextlib.nullcontext() if s is None else torch.cuda.stream(s)

    def ready(self, slot: Optional[int]) -> "Optional[torch.cuda.Event]":
        """An event marking the work issued so far on entry ``slot``'s
        stream (None without a stream)."""
        s = self.stream(slot)
        if s is None:
            return None
        ev = torch.cuda.Event()
        ev.record(s)
        return ev

    def to_compute(self, x: torch.Tensor,
                   ready: "Optional[torch.cuda.Event]" = None) -> torch.Tensor:
        """Hand ``x`` to the compute device's current stream: the stream
        waits for ``ready`` (the event after the side-stream work that made
        ``x``), and ``x`` is marked as used there."""
        if ready is not None:
            here = torch.cuda.current_stream(x.device)
            here.wait_event(ready)
            x.record_stream(here)
            # "cuda" and "cuda:0" name one stream: it waits once
            there = torch.cuda.current_stream(self.device)
            if there != here:
                there.wait_event(ready)
        return x.to(self.device) if self.devices else x

    def colocate(self, x: torch.Tensor, slot: Optional[int]) -> torch.Tensor:
        """Hand ``x``, made on the current stream, to entry ``slot``'s
        stream and device (the placed runner ships the padding mask to a
        shard-local fused popcount this way)."""
        s = self.stream(slot)
        if s is not None:
            s.wait_stream(torch.cuda.current_stream(x.device))
            x.record_stream(s)
        if slot is None or not self.devices:
            return x
        return x.to(self.devices[slot])

    def lend(self, slot: Optional[int], tensors: Sequence[torch.Tensor]) -> None:
        """Let entry ``slot``'s stream read ``tensors`` (on its device) in
        place: the stream waits for the work the current stream has queued
        there (the rows' writes, the tables' copies), and each tensor is
        marked as used on it.  A no-op without a stream."""
        s = self.stream(slot)
        if s is None:
            return
        s.wait_stream(torch.cuda.current_stream(s.device))
        for x in tensors:
            x.record_stream(s)

    def gather(self, refs: Sequence[SlotRef]) -> torch.Tensor:
        """(len(refs), page_bits) copy of rows on the compute device and
        stream — one gather per touched shard, in request order.  The senses
        read in place; this copy serves rows that live on another card."""
        refs = list(refs)
        dies = {int(d) for d, _ in refs}
        if len(dies) == 1:
            return self.shard(dies.pop()).gather(
                [s for _, s in refs]).to(self.device)
        by_die: Dict[int, List[int]] = {}
        pos: List[Tuple[int, int]] = []       # (die, index within die gather)
        for die, slot in refs:
            lst = by_die.setdefault(int(die), [])
            pos.append((int(die), len(lst)))
            lst.append(int(slot))
        parts, offs, off = [], {}, 0
        for die in sorted(by_die):
            offs[die] = off
            parts.append(self.shard(die).gather(by_die[die]).to(self.device))
            off += len(by_die[die])
        stacked = torch.cat(parts, dim=0)
        perm = [offs[d] + i for d, i in pos]
        if perm == list(range(len(perm))):
            return stacked                    # die-sorted request: in order
        return stacked.index_select(
            0, torch.tensor(perm, dtype=torch.long, device=self.device))

    def load_shards(self, rows_by_die: Mapping[int, np.ndarray]) -> None:
        """Load per-die Vth rows exported from another arena's shards (for
        example ``np.asarray(ref_arena.shard(die).buf)`` of the JAX
        package's :class:`ShardedVthArena`) into the same ``(die, slot)``
        refs here.  After the same writes on both sides, both then sense
        identical cells."""
        for die, rows in rows_by_die.items():
            self.shard(int(die)).load(np.asarray(rows))
