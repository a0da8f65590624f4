"""Sense + pack: R float32 Vth rows -> (R, C // 32) packed int32 words.

CUDA kernel: ``csrc/mlc_sense.cu``.  It replaces the Pallas kernel
``src/repro/kernels/mlc_sense.py:mlc_sense`` (``_sense_kernel``).  Bound by
memory: each cell's 4 B of Vth is read once and 1/8 B written, so the least
time is ``R * C * (4 + 1/8) B`` over the card's memory rate.  One thread per
output word reads its 32 cells, which sit 128 columns apart, so neighbouring
threads read neighbouring floats and every load coalesces; the read
references travel by value, as the Pallas kernel's scalar prefetch did.

The rows are read where they live, through slot tables (:class:`Rows`: an
arena shard's buffer per table, up to ``cuda.MAX_TABLES`` tables a launch,
more in several launches); a dense (R, C) tensor is one base with the
identity table.  Rows need no padding.

On the CPU the wrapper runs :data:`reference`, the plain version, on the
rows gathered by their tables.

:func:`sense_popcount` (``mcf_sense_popcount``, same source) senses the
same rows to one count, in one pass: what the executor runs for a counted
root whose plan is one sense, in place of ``mlc_sense`` and a masked
``popcount_rows``.  It reads 4 B per counted cell and writes one int, so
its least time is ``n_bits * 4 B`` over the memory rate.  A count needs no
packing: each thread streams 16-byte loads of consecutive cells, a grid of
the blocks the card holds at once strides over 4096-cell units of the rows
in table order, and each block adds its sum to the total with one atomic.
Cells past ``n_bits`` are neither read nor counted, so no tail mask is
read.  Its plain version is :data:`reference_popcount`.

:func:`sense_drain` (``mcf_mlc_sense_drain``, same source) senses the same
rows to the same words and drains them to a host buffer as they are made:
what the executor runs for a drained root whose plan is one sense.  One C
call enqueues, per chunk of rows, one launch of the sense kernel (which,
in a chunk that holds bits past the result, ANDs them with the tail mask
as it writes them), an event, and the chunk's copy on a copy stream that
waits for the event; so a chunk's copy runs while the next is sensed, and
the host pays for one call, not one per chunk.  Its plain version is
:func:`drain_chunks` over :func:`mlc_sense`.

:func:`mlc_sense_multi` (``mcf_mlc_sense_multi``, same source) senses the
same rows under several read plans in one pass, to one word set a plan:
what the executor runs where its sense items read one page list under
more than one plan, or twice under one.  It replaces no TPU kernel (the
JAX package runs ``mlc_sense`` once a plan): each cell is loaded once
and sensed under every plan, so its least time is ``R * C * (4 + P/8) B``
over the memory rate.  Each thread loads four consecutive words' cells
with 16-byte loads and keeps them in registers while it senses and
stores each plan's words in turn.  It takes the MLC kinds
(:data:`MULTI_KINDS`), each plan with its own references and inversion.
Its plain version is :data:`reference_multi`.
"""
from __future__ import annotations

import ctypes
import functools
from itertools import accumulate
from typing import Callable, Optional, Sequence, Tuple, Union

import torch

from repro_torch.kernels import cuda, ref
from repro_torch.kernels.ref import MAX_REFS, TILE_COLS, WORD_BITS
from repro_torch.kernels.rows import Rows, identity

#: the plain PyTorch versions of these kernels
reference = ref.mlc_sense
reference_popcount = ref.sense_popcount
reference_multi = ref.mlc_sense_multi

#: read kinds :func:`mlc_sense_multi` takes (parity reads go through
#: :func:`mlc_sense`)
MULTI_KINDS = ("lsb", "msb", "sbr")


def mlc_sense(vth: Union[torch.Tensor, Rows], refs: Sequence[float], *,
              kind: str, invert: bool = False, n_refs: int = 0) -> torch.Tensor:
    """Sense R Vth rows with one read kind -> (R, C // 32) int32 words:
    a dense (R, C) tensor, or :class:`Rows` read through their tables in
    order.  ``n_refs`` is used by kind='parity' only."""
    c = vth.shape[1] if isinstance(vth, torch.Tensor) else vth.cols
    if c % TILE_COLS:
        raise ValueError(f"cols {c} must be a multiple of {TILE_COLS}")
    if vth.device.type == "cpu":
        dense = vth if isinstance(vth, torch.Tensor) else vth.gather()
        return reference(dense, list(refs), kind, invert=invert,
                         n_refs=n_refs or None)
    if isinstance(vth, torch.Tensor):
        vth = identity(cuda.check_cuda("vth", vth, torch.float32))
    words = c // WORD_BITS
    out = torch.empty((vth.n_rows, words), dtype=torch.int32,
                      device=vth.device)
    if out.shape[0]:
        kind_code, n_refs, refs_c = cuda.sense_args(refs, kind, n_refs)
        dst, cap = out.data_ptr(), cuda.MAX_TABLES
        for s in range(0, len(vth), cap):
            part = vth if len(vth) <= cap else vth[s:s + cap]
            ends = list(accumulate(int(t.shape[0]) for t in part.slots))
            if ends[-1]:
                bases, slots = cuda.table_args(part)
                cuda.launch("mlc_sense", "mcf_mlc_sense", bases, slots,
                            cuda.TableEnds(*ends), len(part), dst, ends[-1],
                            c, kind_code, n_refs, int(invert), refs_c)
            dst += ends[-1] * words * 4        # int32 words
    return out


@functools.lru_cache(maxsize=1024)
def _plan_args(plans: tuple) -> tuple:
    """Per launch of up to ``cuda.MAX_PLANS`` of ``plans``: the count and
    the C arrays of kind codes, inversions and references that
    ``mcf_mlc_sense_multi`` takes (built once per plan tuple: a cached
    runner senses the same plans at every call)."""
    out = []
    for p0 in range(0, len(plans), cuda.MAX_PLANS):
        chunk = plans[p0:p0 + cuda.MAX_PLANS]
        args = [cuda.sense_args(refs, kind, 0) for refs, kind, _ in chunk]
        n = len(chunk)
        out.append((n, (ctypes.c_int * n)(*(code for code, _, _ in args)),
                    (ctypes.c_int * n)(*(int(inv) for _, _, inv in chunk)),
                    (ctypes.c_float * (n * MAX_REFS))(
                        *(r for _, _, padded in args for r in padded))))
    return tuple(out)


def mlc_sense_multi(vth: Union[torch.Tensor, Rows],
                    plans: Sequence[Tuple[Sequence[float], str, bool]]
                    ) -> torch.Tensor:
    """Sense R Vth rows under P read plans ``(refs, kind, invert)``, each
    kind in :data:`MULTI_KINDS`, reading each row once -> (P, R, C // 32)
    int32: plane ``p`` the words :func:`mlc_sense` gives under plan ``p``.
    One launch a ``cuda.MAX_PLANS`` plans and ``cuda.MAX_TABLES`` tables."""
    plans = tuple((tuple(refs), kind, bool(invert))
                  for refs, kind, invert in plans)
    if not plans or any(kind not in MULTI_KINDS for _, kind, _ in plans):
        raise ValueError(f"read kinds must be among {MULTI_KINDS}, got "
                         f"{[kind for _, kind, _ in plans]}")
    c = vth.shape[1] if isinstance(vth, torch.Tensor) else vth.cols
    if c % TILE_COLS:
        raise ValueError(f"cols {c} must be a multiple of {TILE_COLS}")
    if vth.device.type == "cpu":
        dense = vth if isinstance(vth, torch.Tensor) else vth.gather()
        return reference_multi(dense, plans)
    if isinstance(vth, torch.Tensor):
        vth = identity(cuda.check_cuda("vth", vth, torch.float32))
    words = c // WORD_BITS
    plane = vth.n_rows * words
    out = torch.empty((len(plans), vth.n_rows, words), dtype=torch.int32,
                      device=vth.device)
    if plane == 0:
        return out
    for k, (n, kinds, inverts, refs_c) in enumerate(_plan_args(plans)):
        dst = out.data_ptr() + k * cuda.MAX_PLANS * plane * 4  # int32 words
        row0 = 0
        for s in range(0, len(vth), cuda.MAX_TABLES):
            part = (vth if len(vth) <= cuda.MAX_TABLES
                    else vth[s:s + cuda.MAX_TABLES])
            ends = list(accumulate(int(t.shape[0]) for t in part.slots))
            if ends[-1]:
                bases, slots = cuda.table_args(part)
                cuda.launch("mlc_sense_multi", "mcf_mlc_sense_multi", bases,
                            slots, cuda.TableEnds(*ends), len(part),
                            dst + row0 * words * 4, plane, ends[-1], c, n,
                            kinds, inverts, refs_c)
            row0 += ends[-1]
    return out


def sense_popcount(vth: Union[torch.Tensor, Rows], refs: Sequence[float], *,
                   kind: str, invert: bool = False, n_refs: int = 0,
                   n_bits: Optional[int] = None) -> torch.Tensor:
    """Sense R Vth rows with one read kind and count, in one pass -> 0-d
    int32: the cells among the first ``n_bits`` (row after row, in table
    order; all where None) that sense to 1, which is the popcount of
    :func:`mlc_sense`'s words under the tail mask of ``n_bits``."""
    dense = isinstance(vth, torch.Tensor)
    r, c = vth.shape if dense else (vth.n_rows, vth.cols)
    if c % TILE_COLS:
        raise ValueError(f"cols {c} must be a multiple of {TILE_COLS}")
    valid = r * c if n_bits is None else min(max(n_bits, 0), r * c)
    if vth.device.type == "cpu":
        return reference_popcount(vth if dense else vth.gather(), list(refs),
                                  kind, invert=invert, n_refs=n_refs or None,
                                  n_bits=valid)
    if dense:
        vth = identity(cuda.check_cuda("vth", vth, torch.float32))
    # one launch per MAX_TABLES tables that hold a counted cell: the first
    # zeroes the total, the others add to it
    parts, row0, cap = [], 0, cuda.MAX_TABLES
    for s in range(0, len(vth), cap):
        part = vth if len(vth) <= cap else vth[s:s + cap]
        ends = list(accumulate(int(t.shape[0]) for t in part.slots))
        if ends[-1] and valid > row0 * c:
            parts.append((part, ends, min(valid - row0 * c, ends[-1] * c)))
        row0 += ends[-1]
    if not parts:
        return torch.zeros((), dtype=torch.int32, device=vth.device)
    out = torch.empty((), dtype=torch.int32, device=vth.device)
    kind_code, n_refs, refs_c = cuda.sense_args(refs, kind, n_refs)
    for k, (part, ends, cells) in enumerate(parts):
        bases, slots = cuda.table_args(part)
        cuda.launch("sense_popcount", "mcf_sense_popcount", bases, slots,
                    cuda.TableEnds(*ends), len(part), out.data_ptr(),
                    ends[-1], c, cells, kind_code, n_refs, int(invert),
                    int(k == 0), refs_c)
    return out


def drain_chunks(sense: Callable[[Rows], torch.Tensor],
                 vth: Union[torch.Tensor, Rows], host: torch.Tensor,
                 chunk_rows: int, mask: Optional[torch.Tensor] = None,
                 mask_row: int = 0) -> int:
    """The plain version of :func:`sense_drain`: ``sense`` each chunk of
    ``chunk_rows`` rows in turn, AND the words of rows from ``mask_row`` on
    with ``mask`` (flat, the words' offsets), and copy the chunk into its
    slice of the flat ``host``.  Returns the chunks."""
    rows = identity(vth) if isinstance(vth, torch.Tensor) else vth
    n, chunks = rows.n_rows, 0
    for s in range(0, n, chunk_rows):
        e = min(s + chunk_rows, n)
        words = sense(rows.take(s, e))
        w = words.shape[1]
        if mask is not None and e > mask_row:
            m0 = max(s, mask_row)
            words[m0 - s:] &= mask[m0 * w:e * w].view(e - m0, w)
        host[s * w:e * w].copy_(words.reshape(-1))
        chunks += 1
    return chunks


def sense_drain(vth: Union[torch.Tensor, Rows], refs: Sequence[float], *,
                kind: str, host: torch.Tensor, chunk_rows: int,
                copy_stream: "Optional[torch.cuda.Stream]" = None,
                invert: bool = False, n_refs: int = 0,
                mask: Optional[torch.Tensor] = None,
                mask_row: int = 0) -> int:
    """Sense R Vth rows with one read kind into :func:`mlc_sense`'s words,
    drained into the flat int32 ``host`` buffer (pinned, on a card)
    ``chunk_rows`` rows at a time: each chunk's copy, on ``copy_stream``,
    starts as soon as the chunk is sensed.  The words of rows from
    ``mask_row`` on are ANDed with ``mask`` (flat, at the words' offsets)
    before their copy.  Returns the chunks; on a card the last copy is the
    last work it enqueues on ``copy_stream``."""
    c = vth.shape[1] if isinstance(vth, torch.Tensor) else vth.cols
    if c % TILE_COLS:
        raise ValueError(f"cols {c} must be a multiple of {TILE_COLS}")
    if chunk_rows < 1:
        raise ValueError(f"chunk_rows must be >= 1, got {chunk_rows}")
    if vth.device.type == "cpu":
        return drain_chunks(lambda rows: mlc_sense(
            rows, refs, kind=kind, invert=invert, n_refs=n_refs),
            vth, host, chunk_rows, mask, mask_row)
    if isinstance(vth, torch.Tensor):
        vth = identity(cuda.check_cuda("vth", vth, torch.float32))
    words = c // WORD_BITS
    if not (host.dtype == torch.int32 and host.is_contiguous()
            and host.is_pinned() and host.numel() == vth.n_rows * words):
        raise ValueError(f"host must be pinned contiguous int32 of "
                         f"{vth.n_rows * words} words")
    if mask is not None:
        mask = cuda.check_cuda("mask", mask, torch.int32)
    out = torch.empty((vth.n_rows, words), dtype=torch.int32,
                      device=vth.device)
    kind_code, n_refs, refs_c = cuda.sense_args(refs, kind, n_refs)
    total, row0, cap = 0, 0, cuda.MAX_TABLES
    for s in range(0, len(vth), cap):
        part = vth if len(vth) <= cap else vth[s:s + cap]
        ends = list(accumulate(int(t.shape[0]) for t in part.slots))
        if ends[-1]:
            bases, slots = cuda.table_args(part)
            off = row0 * words * 4                 # int32 words
            chunks = -(-ends[-1] // chunk_rows)    # one sense launch each
            cuda.launch("mlc_sense", "mcf_mlc_sense_drain", bases, slots,
                        cuda.TableEnds(*ends), len(part), out.data_ptr() + off,
                        host.data_ptr() + off, ends[-1], c, chunk_rows,
                        None if mask is None else mask.data_ptr() + off,
                        max(mask_row - row0, 0), kind_code, n_refs,
                        int(invert), refs_c, copy_stream.cuda_stream,
                        count=chunks)
            total += chunks
        row0 += ends[-1]
    # the words stay allocated until the copy stream has read them
    out.record_stream(copy_stream)
    return total
