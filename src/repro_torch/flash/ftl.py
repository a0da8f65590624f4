"""Flash translation layer: allocation, wear leveling, operand alignment.

Shared-page operand placement is a placement policy (paper §5.1), and the
bitwise op is dispatched as a read with a per-op SET_FEATURE offset set.
This module provides:

- wear-levelled block allocation (retired blocks are skipped),
- die-affinity placement (§6 layout): every vector gets a home die
  (round-robin across dies unless pinned with ``die=``) and stripes its
  pages across that die's planes only, so independent vectors spread across
  dies while a vector's co-pages share one,
- encoding-aware co-location (§7): MLC / reduced-MLC wordlines co-locate
  operand pairs on the shared LSB/MSB pages, TLC wordlines operand triples
  on LSB/CSB/MSB,
- runtime copyback realignment for scattered operands and NOT-ready
  derived placements (both inherit the source vector's home die).

Vector compute lives in :class:`repro_torch.api.session.ComputeSession`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import tlc
from repro_torch.core.rber import WearTracker
from repro_torch.core.tlc import PAGES_PER_WL, ROLES_OF
from repro_torch.flash.device import FlashDevice, WordlineKey
from repro_torch.kernels import ref as kernel_ref
from repro_torch.obs.trace import traced
from repro_torch.reliability import checkwords


@dataclasses.dataclass
class VectorMeta:
    name: str
    n_bits: int
    pages: List[WordlineKey]          # striped page placement
    role: str                          # 'lsb' | 'csb' | 'msb' (shared page)
    #: the co-located page holds zeros (scattered writes) — required for
    #: in-flash NOT; losing a pairing does NOT zero the stale co-page.
    zero_co_page: bool = False
    #: home die: all pages stripe across this die's planes (die affinity)
    die: int = 0
    #: row encoding the vector was programmed under (mlc | tlc | reduced-mlc)
    encoding: str = tlc.MLC
    #: sampled-parity checkword: the vector's bits at the shared sample
    #: positions, recorded at write time (the reliability layer's input)
    check: Optional[np.ndarray] = None


class FTL:
    def __init__(self, device: FlashDevice):
        self.device = device
        if getattr(device, "ftl", None) is None:
            device.ftl = self          # first FTL owns the device's allocator
        self.cfg = device.config
        self._next_wl: Dict[int, Tuple[int, int]] = {}   # plane -> (block, wl)
        #: per-block P/E + observed-RBER health; retired blocks are skipped
        self.wear = WearTracker()
        self.vectors: Dict[str, VectorMeta] = {}
        #: name -> ordered tuple of ALL names co-located on its wordlines
        self._group_of: Dict[str, Tuple[str, ...]] = {}
        self._next_die = 0                               # round-robin home die
        #: the session whose reliability manager checks this FTL's reads
        #: (set by ``ComputeSession``; the latest session wins)
        self._session = None

    @property
    def _tracer(self):
        return self.device.ledger.tracer

    @property
    def session(self):
        """The :class:`~repro_torch.api.session.ComputeSession` bound to this
        FTL (the latest one built over it), created on first use."""
        if self._session is None:
            from repro_torch.api.session import ComputeSession  # api layers above

            ComputeSession(ftl=self)           # binds itself as _session
        return self._session

    # -- allocation ----------------------------------------------------------
    def allocate_wordline(self, plane: int) -> WordlineKey:
        block, wl = self._next_wl.get(plane, (0, 0))
        while self.wear.is_retired((plane, block)):      # skip retired blocks
            block, wl = block + 1, 0
        key = (plane, block, wl)
        wl += 1
        if wl >= self.cfg.pages_per_block // 2:          # wordlines per block
            block, wl = block + 1, 0
        self._next_wl[plane] = (block, wl)
        return key

    def vectors_in_block(self, plane: int, block: int) -> List[str]:
        """Registered vectors with at least one page in (plane, block)."""
        return [m.name for m in self.vectors.values()
                if any(p == plane and b == block for p, b, _ in m.pages)]

    def retire_block(self, plane: int, block: int) -> None:
        """Mark a block bad: the allocator skips it from now on."""
        self.wear.retire((plane, block))

    # -- placement -----------------------------------------------------------
    def _home_die(self, die: "int | None" = None) -> int:
        """Pick (or validate) a vector's home die — round-robin by default."""
        if die is None:
            die = self._next_die % self.cfg.dies
            self._next_die += 1
        if not 0 <= die < self.cfg.dies:
            raise ValueError(f"die {die} outside 0..{self.cfg.dies - 1}")
        return die

    def _placement(self, n_pages: int, die: int) -> List[WordlineKey]:
        """Allocate ``n_pages`` wordlines striped across ``die``'s planes."""
        ppd = self.cfg.planes_per_die
        return [self.allocate_wordline(die * ppd + (i % ppd))
                for i in range(n_pages)]

    def die_of(self, name: str) -> int:
        """Home die of a registered vector."""
        return self.vectors[name].die

    def encoding_of(self, name: str) -> str:
        """Row encoding of a registered vector."""
        return self.vectors[name].encoding

    def partner_of(self, name: str) -> "str | None":
        """The one co-located partner of an MLC-style pair (None when the
        vector is scattered or lives in a larger TLC group)."""
        group = self._group_of.get(name, ())
        if len(group) != 2:
            return None
        return group[0] if group[1] == name else group[1]

    def group_of(self, name: str) -> Tuple[str, ...]:
        """All names co-located on ``name``'s wordlines (empty if scattered)."""
        return self._group_of.get(name, ())

    @staticmethod
    def derived_not_name(name: str) -> str:
        """Name of the NOT-ready derived placement the session may cache."""
        return f"__not__{name}"

    def _invalidate(self, name: str) -> None:
        """Rewriting a vector drops it from its co-location group and drops
        any derived placements built from its old contents."""
        group = self._group_of.pop(name, None)
        if group is not None:
            rest = tuple(n for n in group if n != name)
            for n in rest:
                if len(rest) >= 2:
                    self._group_of[n] = rest
                else:
                    self._group_of.pop(n, None)
        self.vectors.pop(self.derived_not_name(name), None)

    def _checkword(self, bits: torch.Tensor, n_bits: int) -> np.ndarray:
        """Sampled-parity checkword of a vector being written: only the
        sampled bits cross to the host.  The sample count follows the
        session's retry policy when recovery is on."""
        mgr = getattr(self._session, "reliability", None)
        n_samples = (mgr.policy.check_samples if mgr is not None
                     else checkwords.DEFAULT_SAMPLES)
        pos = checkwords.sample_positions(n_bits, n_samples)
        idx = torch.tensor(pos, dtype=torch.long, device=bits.device)
        # the host's own copy of the bits being written, not a flash read:
        # the controller keeps it, so no channel or host link carries it
        sampled = bits.reshape(-1)[idx].to(torch.uint8)
        return sampled.cpu().numpy()  # verify: allow(unledgered-transfer)

    def _paginate(self, bits: torch.Tensor) -> List[torch.Tensor]:
        pb = self.cfg.page_bits
        n = int(bits.shape[0])
        pad = (-n) % pb
        if pad:
            bits = torch.cat([bits, bits.new_zeros(pad)])
        return list(bits.reshape(-1, pb).unbind(0))

    def _program_roles(self, placement: List[WordlineKey],
                       pages_by_role: Dict[str, List[torch.Tensor]],
                       encoding: str) -> None:
        """Program a wordline batch from a role->pages mapping (missing roles
        are zero-filled), under one row encoding."""
        n = len(placement)
        zeros = None
        pages = {}
        for role in ROLES_OF[encoding]:
            got = pages_by_role.get(role)
            if got is None:
                if zeros is None:
                    some = next(iter(pages_by_role.values()))
                    zeros = [torch.zeros_like(p) for p in some]
                got = zeros
            assert len(got) == n
            pages[role] = got
        self.device.program_shared_batch(
            placement, pages["lsb"], pages["msb"],
            csb_pages=pages.get("csb"), encoding=encoding)

    def write_group_aligned(self, names: Sequence[str],
                            bits: Sequence[torch.Tensor],
                            die: "int | None" = None,
                            encoding: str = tlc.MLC) -> None:
        """Write k operands co-located on shared wordlines (k=2 for MLC /
        reduced-MLC, k in {2,3} for TLC), striped across one home die's
        planes.  Operands take the encoding's shared-page roles in canonical
        order; a TLC pair leaves a zero MSB page."""
        names, bits = list(names), list(bits)
        roles = ROLES_OF[encoding]
        if not 2 <= len(names) <= len(roles):
            raise ValueError(f"{encoding} wordlines co-locate 2..{len(roles)} "
                             "operands")
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate names {names}")
        with traced(self._tracer, "program", "write-group",
                    encoding=encoding) as span:
            paged = [self._paginate(b) for b in bits]
            if len({len(p) for p in paged}) != 1:
                raise ValueError("aligned operands must match in size")
            if span is not None:
                span.args["wordlines"] = len(paged[0])
                span.args["pages_per_wordline"] = len(roles)
            for n in names:
                self._invalidate(n)
            die = self._home_die(die)
            placement = self._placement(len(paged[0]), die)
            self._program_roles(placement, dict(zip(roles, paged)), encoding)
            for name, b, role in zip(names, bits, roles):
                n_bits = int(b.shape[0])
                self.vectors[name] = VectorMeta(
                    name, n_bits, placement, role, die=die, encoding=encoding,
                    check=self._checkword(b, n_bits))
                self._group_of[name] = tuple(names)

    def write_pair_aligned(self, name_a: str, bits_a: torch.Tensor,
                           name_b: str, bits_b: torch.Tensor,
                           die: "int | None" = None,
                           encoding: str = tlc.MLC) -> None:
        """Write operands A,B co-located on shared wordlines."""
        self.write_group_aligned([name_a, name_b], [bits_a, bits_b],
                                 die=die, encoding=encoding)

    def write_scattered(self, name: str, bits: torch.Tensor, role: str = "lsb",
                        die: "int | None" = None,
                        encoding: str = tlc.MLC) -> None:
        """Write a single vector without co-located partners (realigned
        before MCFlash compute) — all other shared pages zero."""
        if role not in ROLES_OF[encoding]:
            raise ValueError((role, encoding))
        self._invalidate(name)
        pages = self._paginate(bits)
        die = self._home_die(die)
        placement = self._placement(len(pages), die)
        self._program_roles(placement, {role: pages}, encoding)
        n_bits = int(bits.shape[0])
        self.vectors[name] = VectorMeta(name, n_bits, placement, role,
                                        zero_co_page=True, die=die,
                                        encoding=encoding,
                                        check=self._checkword(bits, n_bits))

    def align(self, name_a: str, name_b: str) -> str:
        """Copyback-realign two scattered MLC vectors into an aligned pair on
        A's home die (A becomes LSB, B MSB); returns A's name."""
        ma, mb = self.vectors[name_a], self.vectors[name_b]
        if not ma.encoding == mb.encoding == tlc.MLC:
            raise ValueError("align() is the MLC copyback path; use "
                             "align_group for encoded vectors")
        if len(ma.pages) != len(mb.pages):
            raise ValueError("aligned operands must match in size")
        self._invalidate(name_a)
        self._invalidate(name_b)
        with traced(self._tracer, "ftl", "copyback-align") as span:
            if span is not None:
                span.name = f"copyback-align[{name_a},{name_b}]"
                span.args["pages"] = len(ma.pages)
            placement = [self.allocate_wordline(wa[0]) for wa in ma.pages]
            self.device.copyback_align(ma.pages, mb.pages, placement,
                                       ma.role, mb.role)
        # the copyback preserves data, so the checkwords carry over
        self.vectors[name_a] = VectorMeta(name_a, ma.n_bits, placement, "lsb",
                                          die=ma.die, check=ma.check)
        self.vectors[name_b] = VectorMeta(name_b, mb.n_bits, placement, "msb",
                                          die=ma.die, check=mb.check)
        self._group_of[name_a] = self._group_of[name_b] = (name_a, name_b)
        return name_a

    def align_group(self, names: Sequence[str]) -> None:
        """Copyback-realign k same-encoding vectors onto shared wordlines on
        the first vector's home die, in canonical role order.  MLC pairs keep
        the two-read copyback path."""
        metas = [self.vectors[n] for n in names]
        enc = metas[0].encoding
        if not all(m.encoding == enc for m in metas):
            raise ValueError("cannot co-locate mixed encodings: "
                             f"{[m.encoding for m in metas]}")
        if enc == tlc.MLC and len(names) == 2:
            self.align(names[0], names[1])
            return
        # under fault injection a factory-reference readout would copy
        # corrupted bits into the new placement AND recompute matching
        # checkwords; with recovery on, each vector reads back checked
        mgr = getattr(self._session, "reliability", None)
        with traced(self._tracer, "ftl", "align-group",
                    encoding=enc) as span:
            if span is not None:
                span.name = f"align-group[{','.join(names)}]"
            bits = []
            for m in metas:
                if mgr is not None:
                    bits.append(mgr.read_vector_checked(m))
                    continue
                packed = self.device.page_read_batch(m.pages, m.role,
                                                     encoding=enc)
                bits.append(kernel_ref.unpack_bits(
                    packed.reshape(1, -1))[0][: m.n_bits])
            self.write_group_aligned(list(names), bits, die=metas[0].die,
                                     encoding=enc)

    # -- executor lowering helpers --------------------------------------------
    def group_for_sense(self, names: List[str]) -> Tuple[List[Tuple[str, ...]], "str | None"]:
        """Group same-encoding operand names for shared-wordline senses.

        Already-co-located partners group first (no realignment cost); the
        rest group greedily up to the encoding's wordline capacity (each
        group costs one copyback realignment).  A leftover singleton is read
        out as its own partial.
        """
        metas = [self.vectors[n] for n in names]
        enc = metas[0].encoding
        if not all(m.encoding == enc for m in metas):
            raise ValueError("sense groups must share one encoding")
        cap = PAGES_PER_WL[enc]
        used: set = set()
        groups: List[Tuple[str, ...]] = []
        rest: List[str] = []
        for i, n in enumerate(names):
            if i in used:
                continue
            used.add(i)
            idx = [i]
            for p in self._group_of.get(n, ()):
                if p == n or len(idx) >= cap:
                    continue
                j = next((k for k in range(len(names))
                          if k not in used and names[k] == p), None)
                if j is not None:
                    idx.append(j)
                    used.add(j)
            if len(idx) > 1:
                groups.append(tuple(names[k] for k in idx))
            else:
                rest.append(n)
        while len(rest) >= 2:
            take, rest = rest[:cap], rest[cap:]
            groups.append(tuple(take))
        return groups, (rest[0] if rest else None)

    def ensure_aligned(self, name_a: str, name_b: str) -> None:
        """Copyback-realign A,B unless they already share wordlines."""
        if self.partner_of(name_a) != name_b:
            self.align(name_a, name_b)

    def ensure_colocated(self, names: Sequence[str]) -> None:
        """Copyback-realign a group unless its (distinct) members already
        share wordlines.  Duplicate names need no realignment."""
        distinct = list(dict.fromkeys(names))
        if len(distinct) == 1:
            return                     # one vector: its role reads in place
        group = self._group_of.get(distinct[0], ())
        pages = self.vectors[distinct[0]].pages
        if all(n in group for n in distinct) and \
                all(self.vectors[n].pages == pages for n in distinct):
            return
        self.align_group(distinct)

    def ensure_not_ready(self, name: str) -> VectorMeta:
        """Placement for an in-flash NOT: the operand must sit in the MSB page
        over a zero LSB page (paper Table 1).  Vectors stored any other way
        are copyback-rewritten once into a NOT-ready placement, cached under
        a derived name.  Returns the meta whose pages to sense."""
        meta = self.vectors[name]
        if meta.encoding != tlc.MLC:
            raise ValueError("encoded wordlines run NOT as a direct inverse "
                             "role read")
        if meta.role == "msb" and meta.zero_co_page and not self.group_of(name):
            return meta
        copy = self.derived_not_name(name)
        if copy not in self.vectors:
            with traced(self._tracer, "ftl", "not-ready-copy") as span:
                if span is not None:
                    span.name = f"not-ready-copy[{name}]"
                    span.args["pages"] = len(meta.pages)
                packed = self.device.page_read_batch(meta.pages, meta.role)
                self.device.dma_to_controller_batch(meta.pages)
                bits = kernel_ref.unpack_bits(
                    packed.reshape(1, -1))[0][: meta.n_bits]
                # the derived placement stays on the source vector's home die
                self.write_scattered(copy, bits, role="msb", die=meta.die)
        return self.vectors[copy]
