"""The sense kernels' operand form: Vth rows read where they live.

A :class:`Rows` holds, per table, a float32 buffer of ``(slots, C)`` rows
(an arena shard's buffer, or a dense stack) and a device int32 slot table:
entry ``p`` of table ``i`` is row ``slots[i][p]`` of ``bufs[i]``.  The CUDA
sense kernels take the buffers' base pointers and the tables by value and
read each row in place, so nothing is copied out of the arena before a
sense.  :func:`identity` gives a dense stack the same form (one base, the
identity table), so every sense takes one kernel whatever its input.

``mlc_sense`` reads the tables' rows in order (:meth:`Rows.take` gives a
run of them, as the slices of the tables that hold it); the fused kernels
take one table per operand, all of one length.  The plain versions gather the rows
with ``index_select`` (:meth:`Rows.gather`) and run the dense reference.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch

__all__ = ["Rows", "identity"]


class Rows:
    """Per table, a (slots, C) float32 buffer and an int32 slot table on
    the buffer's device.  ``rows[s:e]`` takes tables ``s..e-1``."""

    __slots__ = ("bufs", "slots")

    def __init__(self, bufs: Sequence[torch.Tensor],
                 slots: Sequence[torch.Tensor]):
        if len(bufs) != len(slots) or not bufs:
            raise ValueError(f"{len(bufs)} buffers for {len(slots)} tables")
        self.bufs = tuple(bufs)
        self.slots = tuple(slots)

    @classmethod
    def cat(cls, parts: Sequence["Rows"]) -> "Rows":
        """The tables of ``parts``, in order."""
        return cls([b for p in parts for b in p.bufs],
                   [s for p in parts for s in p.slots])

    def __len__(self) -> int:
        return len(self.slots)

    def __getitem__(self, index: slice) -> "Rows":
        return Rows(self.bufs[index], self.slots[index])

    def take(self, start: int, stop: int) -> "Rows":
        """Rows ``start..stop-1`` over all tables in order: each table that
        holds some of them, sliced to those (a view of its slots)."""
        bufs, slots, row0 = [], [], 0
        for buf, table in zip(self.bufs, self.slots):
            n = int(table.shape[0])
            lo, hi = max(start - row0, 0), min(stop - row0, n)
            if lo < hi:
                bufs.append(buf)
                slots.append(table[lo:hi])
            row0 += n
        return Rows(bufs, slots)

    @property
    def device(self) -> torch.device:
        return self.bufs[0].device

    @property
    def cols(self) -> int:
        return int(self.bufs[0].shape[1])

    @property
    def n_rows(self) -> int:
        """Entries over all tables."""
        return sum(int(s.shape[0]) for s in self.slots)

    def gather(self) -> torch.Tensor:
        """(n_rows, C) copy of the rows, table after table: what the plain
        versions sense."""
        return torch.cat([b.index_select(0, s.long())
                          for b, s in zip(self.bufs, self.slots)])


#: identity tables per device; a longer one replaces the last, and the
#: older ones stay, since queued kernels may still read them
_IDENTITY: Dict[torch.device, List[torch.Tensor]] = {}


def _arange(n: int, device: torch.device) -> torch.Tensor:
    tables = _IDENTITY.setdefault(device, [])
    if not tables or tables[-1].shape[0] < n:
        size = max(1024, 1 << (n - 1).bit_length())
        tables.append(torch.arange(size, dtype=torch.int32, device=device))
        if device.type == "cuda":
            # once per size: the table is then ready for a kernel on any stream
            torch.cuda.synchronize(device)  # verify: allow(host-sync-in-hot-path)
    return tables[-1]


def identity(vth: torch.Tensor) -> Rows:
    """A dense stack as row tables: (R, C) is one table of its R rows;
    (N, R, C) is N tables, operand ``i`` reading rows ``i*R .. i*R+R-1`` of
    the flattened stack.  The tables are slices of one cached ``arange``."""
    if vth.dim() == 2:
        return Rows((vth,), (_arange(vth.shape[0], vth.device)[:vth.shape[0]],))
    n, r, c = vth.shape
    flat = vth.reshape(n * r, c)
    ar = _arange(n * r, vth.device)
    return Rows((flat,) * n, [ar[i * r:(i + 1) * r] for i in range(n)])
