"""Device-resident Vth storage: per-die shards of (slots, page_bits) buffers.

:class:`VthArena` is one preallocated float32 buffer on a torch device plus
a free-slot allocator: programming a wordline writes one row in place, and
a batched sense is one ``index_select`` of row indices.

:class:`ShardedVthArena` keeps one lazily-created :class:`VthArena` per die
that holds data, addressed by ``(die, slot)`` refs, so the executor's
per-die sense groups each gather from their own shard.  All shards live on
one torch device; pinning shards to several devices (the JAX package's
``devices=``) is not ported yet.

Each shard grows geometrically (rows double, never shrink) and recycles
freed slots LIFO, in the same order as the JAX package's arena, so the same
writes land on the same ``(die, slot)`` refs in both.  Unlike the JAX
arena, writes update the buffer in place, which saves a copy of it.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.tlc import ENCODINGS

__all__ = ["VthArena", "ShardedVthArena", "SlotRef"]

#: address of one arena row: (die, slot-within-die-shard)
SlotRef = Tuple[int, int]


class VthArena:
    """Preallocated (slots, page_bits) float32 Vth storage with a free list."""

    def __init__(self, page_bits: int, init_slots: int = 16,
                 device: "torch.device | str" = "cpu"):
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
    """

    def __init__(self, page_bits: int, n_dies: int = 1, init_slots: int = 16,
                 device: "torch.device | str" = "cpu"):
        if n_dies < 1:
            raise ValueError(n_dies)
        self.page_bits = int(page_bits)
        self.n_dies = int(n_dies)
        self.init_slots = int(init_slots)
        self.device = torch.device(device)
        self._shards: Dict[int, VthArena] = {}

    # -- shards ---------------------------------------------------------------
    def shard(self, die: int) -> VthArena:
        """The (lazily-created) per-die shard backing ``die``."""
        if not 0 <= die < self.n_dies:
            raise IndexError((die, self.n_dies))
        arena = self._shards.get(die)
        if arena is None:
            arena = self._shards[die] = VthArena(
                self.page_bits, self.init_slots, self.device)
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

    def gather(self, refs: Sequence[SlotRef]) -> torch.Tensor:
        """(len(refs), page_bits) rows — one gather per touched shard, in
        request order."""
        refs = list(refs)
        dies = {int(d) for d, _ in refs}
        if len(dies) == 1:
            return self.shard(dies.pop()).gather([s for _, s in refs])
        by_die: Dict[int, List[int]] = {}
        pos: List[Tuple[int, int]] = []       # (die, index within die gather)
        for die, slot in refs:
            lst = by_die.setdefault(int(die), [])
            pos.append((int(die), len(lst)))
            lst.append(int(slot))
        parts, offs, off = [], {}, 0
        for die in sorted(by_die):
            offs[die] = off
            parts.append(self.shard(die).gather(by_die[die]))
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
