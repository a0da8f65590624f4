"""Functional simulated NAND flash device.

Per-wordline Vth lives in a die-sharded :class:`ShardedVthArena` on one
torch device, addressed by ``(die, slot)`` refs, so a batched sense is one
row gather per touched shard.  Read plans execute through a backend
(the CUDA kernels on a card, the plain versions on the CPU), P/E cycles
are tracked per block, and the unified :class:`~repro_torch.api.ledger.Ledger`
(time + energy) is threaded through every command.

Read plans compile once per key through the device's
:class:`~repro_torch.api.plan_cache.PlanCache`, and executor runners are
shared across sessions through ``device.executables``.  The cost of any
command batch is exposed without booking (:meth:`mcflash_cost` /
:meth:`page_read_cost` / :meth:`dma_cost`) so the executor can merge a
schedule wave of per-die groups into one parallel ledger step.

Vth sampling draws from the device's own ``torch.Generator`` (seeded by
``seed``), one independent draw per page in program order.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.api.ledger import Ledger
from repro_torch.api.plan_cache import ExecutableCache, PlanCache
from repro_torch.core import mcflash, tlc, vth_model
from repro_torch.core.mcflash import ReadPlan
from repro_torch.core.tlc import PAGES_PER_WL, TLCChipModel
from repro_torch.core.vth_model import ChipModel
from repro_torch.flash.arena import ShardedVthArena, SlotRef
from repro_torch.flash.energy import EnergyModel
from repro_torch.flash.geometry import SSDConfig
from repro_torch.flash.timing import TimingModel
from repro_torch.kernels import ref as kernel_ref

WordlineKey = Tuple[int, int, int]  # (plane, block, wordline)

#: ledger/timing op label for a standard page read of each role
PAGE_READ_OP = {"lsb": "and", "csb": "or", "msb": "or"}


class FlashDevice:
    """One simulated multi-plane NAND chip set (the §6 SSD's raw layer).

    ``device`` is the torch device holding the Vth arena (``"cuda"`` or
    ``"cpu"``) and running combines.  ``shard_devices`` (a list of torch
    devices, entries may repeat, or ``"auto"`` for one entry per visible
    card) pins die ``d``'s shard to entry ``d % len(shard_devices)``; each
    CUDA entry owns its own stream, so on one card ``["cuda"] * 4`` runs
    die-disjoint units on four streams (the placed runner).  Programming keeps a copy of each wordline's page bits
    (uint8, one byte per cell and page, on the same device) beside its Vth
    row, never a view of the caller's tensors: the oracles
    :meth:`stored_operands` and :meth:`expected` read them.
    """

    def __init__(self, chip: ChipModel | None = None,
                 config: SSDConfig | None = None,
                 timing: TimingModel | None = None,
                 energy: EnergyModel | None = None,
                 seed: int = 0, shard_devices=None,
                 tlc_chip: TLCChipModel | None = None,
                 exec_cache_capacity: Optional[int] = ExecutableCache.DEFAULT_CAPACITY,
                 device: "torch.device | str" = "cuda"):
        self.device = torch.device(device)
        self.chip = chip or vth_model.get_chip_model()
        # 8-state chip model backing TLC and reduced-MLC wordlines (§7)
        self.tlc_chip = tlc_chip or TLCChipModel()
        self.config = config or SSDConfig()
        self.timing = timing or TimingModel()
        self.energy = energy or EnergyModel()
        self._page_bits = self.config.page_bits
        self.arena = ShardedVthArena(self._page_bits, n_dies=self.config.dies,
                                     device=self.device,
                                     devices=shard_devices)
        self._slot_of: Dict[WordlineKey, SlotRef] = {}
        # stored page bits per wordline: (one tensor per role, row), role
        # order (2 for MLC/reduced, 3 for TLC)
        self._operands: Dict[WordlineKey,
                             Tuple[Tuple[torch.Tensor, ...], int]] = {}
        self._encoding_of: Dict[WordlineKey, str] = {}
        self.pe_counts: Dict[Tuple[int, int], int] = {}
        self.ledger = Ledger()
        self.plans = PlanCache()
        # Executor runners: shared by every session on this device (keys
        # embed backend + plan signature), LRU-bounded.
        self.executables = ExecutableCache(capacity=exec_cache_capacity)
        from repro_torch.api.backends import Backend   # api layers above
        #: the kernels every sense of this device runs through
        self.backend = Backend(self.device)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(int(seed))
        self.ftl = None                # first-bound FTL registers itself here
        #: optional :class:`repro_torch.reliability.FaultModel`: when
        #: installed (``ComputeSession(faults=...)`` / ``REPRO_FAULTS``)
        #: every program perturbs its Vth rows per the seeded wear model
        self.faults = None
        #: when set (by the executor's lowering pass) every shared-page
        #: program appends ``(label, wls)`` here
        self.program_log: "list | None" = None

    # -- geometry helpers ---------------------------------------------------
    def die_of_plane(self, plane: int) -> int:
        return plane // self.config.planes_per_die

    def _channel_of_plane(self, plane: int) -> int:
        return self.die_of_plane(plane) // self.config.dies_per_channel

    # -- arena access (the executor's input surface) --------------------------
    def vth_stack(self, wls: List[WordlineKey], *,
                  place: bool = True) -> torch.Tensor:
        """(N, page_bits) Vth of a wordline batch — one gather per touched
        die shard.  ``place=False`` leaves a die-local gather on its
        shard's device and stream (the placed runner); the default lands
        it on the compute device and stream."""
        return self.arena.gather([self._slot_of[wl] for wl in wls],
                                 place=place)

    def load_vth(self, rows_by_die: Mapping[int, np.ndarray]) -> None:
        """Load per-die Vth rows exported from a reference arena's shards
        into this device's arena at the same ``(die, slot)`` refs (see
        :meth:`ShardedVthArena.load_shards`)."""
        self.arena.load_shards(rows_by_die)

    # -- commands -----------------------------------------------------------
    def program_shared_batch(self, wls: List[WordlineKey],
                             lsb_pages: List[torch.Tensor],
                             msb_pages: List[torch.Tensor],
                             retention_hours: float = 0.0, *,
                             csb_pages: "List[torch.Tensor] | None" = None,
                             encoding: str = tlc.MLC) -> None:
        """Program the shared pages of a wordline batch under one encoding.

        MLC programs (LSB, MSB) through the 4-state chip model; TLC programs
        (LSB, CSB, MSB) and reduced-MLC (LSB, MSB) on the {L0, L2, L5, L7}
        states, both through the 8-state chip.  Vth is drawn per page, the
        arena write is one update per shard and the ledger entry one call.
        """
        self._program_rows(wls, lsb_pages, msb_pages, retention_hours,
                           csb_pages=csb_pages, encoding=encoding)
        if wls:
            self._book_program(wls, encoding)

    def _program_rows(self, wls: List[WordlineKey],
                      lsb_pages: List[torch.Tensor],
                      msb_pages: List[torch.Tensor],
                      retention_hours: float = 0.0, *,
                      csb_pages: "List[torch.Tensor] | None" = None,
                      encoding: str = tlc.MLC,
                      records: "Tuple[torch.Tensor, ...] | None" = None
                      ) -> None:
        """Draw the Vth rows of a wordline batch (one draw per page, in
        order), write them to the arena and keep the page records; books
        nothing.  ``records``: see :meth:`_keep_records`."""
        if encoding not in tlc.ENCODINGS:
            raise ValueError(encoding)
        if encoding == tlc.TLC:
            if csb_pages is None or len(csb_pages) != len(wls):
                raise ValueError("TLC wordlines carry three shared pages "
                                 "(lsb, csb, msb)")
        elif csb_pages is not None:
            raise ValueError(f"{encoding} wordlines have no CSB page")
        if not len(wls) == len(lsb_pages) == len(msb_pages):
            raise ValueError("one lsb and one msb page per wordline")
        if not wls:
            return
        vths = []
        for i, wl in enumerate(wls):
            lsb_bits, msb_bits = lsb_pages[i], msb_pages[i]
            if tuple(lsb_bits.shape) != (self._page_bits,):
                raise ValueError(f"page shape {tuple(lsb_bits.shape)}")
            plane, block, _ = wl
            n_pe = self.pe_counts.get((plane, block), 0)
            if encoding == tlc.MLC:
                vth, _ = vth_model.program_page(
                    self._gen, lsb_bits, msb_bits, self.chip,
                    n_pe=float(n_pe), retention_hours=retention_hours)
            else:
                if retention_hours != 0.0:
                    raise ValueError("retention drift is not modeled for "
                                     "8-state encodings")
                pages = ((lsb_bits, csb_pages[i], msb_bits)
                         if encoding == tlc.TLC else (lsb_bits, msb_bits))
                states = tlc.encode_states(encoding, pages)
                vth = tlc.program_tlc(self._gen, states, self.tlc_chip,
                                      n_pe=float(n_pe))
            if self.faults is not None:
                vth = self.faults.perturb(vth, plane=plane, block=block,
                                          wl=wl[2], n_pe=n_pe)
            vths.append(vth)
        self._keep_records(wls, (lsb_pages, csb_pages, msb_pages)
                           if encoding == tlc.TLC else (lsb_pages, msb_pages),
                           encoding, records)
        slots = []
        for wl in wls:
            slot = self._slot_of.get(wl)
            if slot is None:
                # die-affinity allocation: the row lives on its plane's die shard
                (slot,) = self.arena.alloc(self.die_of_plane(wl[0]), 1,
                                           encoding=encoding)
                self._slot_of[wl] = slot
            elif self.arena.encoding_of(slot) != encoding:
                # reprogram under a different encoding reuses the slot
                self.arena.retag(slot, encoding)
            slots.append(slot)
        self.arena.write(slots, torch.stack(vths))

    def _keep_records(self, wls: List[WordlineKey], roles, encoding: str,
                      records: "Tuple[torch.Tensor, ...] | None") -> None:
        """Keep each wordline's page bits in role order: one (N, page_bits)
        uint8 copy per role of the batch, since the records must not change
        when the caller reuses the memory it wrote from.  ``records``, such
        tensors that the device made itself, are kept in place of a copy.
        A wordline keeps (batch records, row); its rows are views made on
        :meth:`stored_operands`."""
        if records is None:
            records = tuple(torch.stack(pages).to(torch.uint8)
                            for pages in roles)
        for i, wl in enumerate(wls):
            self._operands[wl] = (records, i)
            self._encoding_of[wl] = encoding

    def _book_program(self, wls: List[WordlineKey], encoding: str) -> None:
        """Ledger entry (and lowering-time program log) of one shared-page
        program command over ``wls``."""
        # shared-page program: one page's worth of ISPP per shared page
        n_pages = PAGES_PER_WL[encoding]
        per_die: Dict[int, float] = {}
        for wl in wls:
            die = self.die_of_plane(wl[0])
            per_die[die] = per_die.get(die, 0.0) + n_pages * self.timing.t_prog_us
        self.ledger.add_die_batch(
            per_die,
            n_pages * self.energy.e_prog_uj_kb * self.config.page_kb * len(wls),
            commands=len(wls), category="program",
            label=f"program {encoding}x{len(wls)}p")
        if self.program_log is not None:
            self.program_log.append((f"program {encoding}x{len(wls)}p",
                                     list(wls)))

    def program_shared(self, wl: WordlineKey, lsb_bits: torch.Tensor,
                       msb_bits: torch.Tensor, retention_hours: float = 0.0,
                       *, csb_bits: "torch.Tensor | None" = None,
                       encoding: str = tlc.MLC) -> None:
        """Program the shared pages of one wordline."""
        self.program_shared_batch(
            [wl], [lsb_bits], [msb_bits], retention_hours=retention_hours,
            csb_pages=None if csb_bits is None else [csb_bits],
            encoding=encoding)

    # -- command cost models (no booking) ------------------------------------
    def _per_die_us(self, wls: List[WordlineKey], us: float) -> Dict[int, float]:
        per_die: Dict[int, float] = {}
        for wl in wls:
            die = self.die_of_plane(wl[0])
            per_die[die] = per_die.get(die, 0.0) + us
        return per_die

    def mcflash_cost(self, wls: List[WordlineKey], op: str,
                     switch_op: bool = True,
                     phases: Optional[int] = None) -> Tuple[Dict[int, float], float]:
        """(per-die busy us, energy uj) of a batched MCFlash sense: per-page
        read latency aggregated per die, ONE SET_FEATURE for the whole batch."""
        per_die = self._per_die_us(
            wls, self.timing.op_latency_us(op, switch_op=False, phases=phases))
        if switch_op and wls:
            first = self.die_of_plane(wls[0][0])
            per_die[first] += self.timing.t_setfeature_us
        uj = (self.energy.read_energy_uj_kb(op, phases)
              * self.config.page_kb * len(wls))
        return per_die, uj

    def page_read_cost(self, wls: List[WordlineKey], which: str = "lsb",
                       phases: Optional[int] = None) -> Tuple[Dict[int, float], float]:
        """(per-die busy us, energy uj) of a batched default-reference read."""
        op = PAGE_READ_OP[which]
        per_die = self._per_die_us(wls, self.timing.read_latency_us(op, phases))
        uj = (self.energy.read_energy_uj_kb(op, phases)
              * self.config.page_kb * len(wls))
        return per_die, uj

    def dma_cost(self, wls: List[WordlineKey]) -> Dict[int, float]:
        """Per-channel busy us of NAND -> controller page transfers."""
        us = self.config.page_bytes / (self.config.channel_bw_gbps * 1e3)
        per_ch: Dict[int, float] = {}
        for wl in wls:
            ch = self._channel_of_plane(wl[0])
            per_ch[ch] = per_ch.get(ch, 0.0) + us
        return per_ch

    # -- batched ledger accounting ------------------------------------------
    def account_mcflash_batch(self, wls: List[WordlineKey], op: str,
                              switch_op: bool = True,
                              phases: Optional[int] = None) -> None:
        """Book die busy time + energy for a batched MCFlash sense."""
        if not wls:
            return
        per_die, uj = self.mcflash_cost(wls, op, switch_op=switch_op,
                                        phases=phases)
        self.ledger.add_die_batch(per_die, uj, commands=len(wls))

    def account_page_read_batch(self, wls: List[WordlineKey],
                                which: str = "lsb",
                                phases: Optional[int] = None) -> None:
        """Book die busy time + energy for a batched default-reference read."""
        if not wls:
            return
        per_die, uj = self.page_read_cost(wls, which, phases)
        self.ledger.add_die_batch(per_die, uj, commands=len(wls))

    def mcflash_read_batch(self, wls: List[WordlineKey], op: str, *,
                           plan: ReadPlan | None = None,
                           switch_op: bool = True) -> torch.Tensor:
        """Execute one MCFlash op over a batch of programmed wordlines: one
        backend sense call, one SET_FEATURE booked for the whole batch."""
        if not wls:
            raise ValueError("empty wordline batch")
        if plan is None:
            plan = self.plans.get(op, self.chip)
        self.account_mcflash_batch(wls, op, switch_op=switch_op,
                                   phases=plan.sensing_phases)
        return self.backend.sense(self.vth_stack(wls), plan)

    def mcflash_read(self, wl: WordlineKey, op: str, packed: bool = True,
                     switch_op: bool = True, *,
                     plan: ReadPlan | None = None) -> torch.Tensor:
        """Execute an MCFlash bitwise op on a single programmed wordline."""
        words = self.mcflash_read_batch([wl], op, plan=plan,
                                        switch_op=switch_op)
        return words[0] if packed else kernel_ref.unpack_bits(words)[0]

    def page_read_plan(self, which: str = "lsb",
                       encoding: str = tlc.MLC) -> ReadPlan:
        """Default-reference read plan for one shared-page role."""
        if encoding != tlc.MLC:
            return self.plans.get_encoded("read", (which,), self.tlc_chip,
                                          encoding)
        if which not in ("lsb", "msb"):
            raise ValueError(f"MLC wordlines have no {which!r} page "
                             "(missing encoding=?)")
        v0, v1, v2 = self.chip.vref_default
        if which == "lsb":
            return ReadPlan("page_lsb", "lsb", (v1,), 1)
        return ReadPlan("page_msb", "msb", (v0, v2), 2)

    def page_read_batch(self, wls: List[WordlineKey], which: str = "lsb", *,
                        encoding: str = tlc.MLC) -> torch.Tensor:
        """Standard (default-reference) read of a batch of pages in one
        sense call -> (N, words) packed."""
        if not wls:
            raise ValueError("empty wordline batch")
        plan = self.page_read_plan(which, encoding)
        self.account_page_read_batch(wls, which, phases=plan.sensing_phases)
        return self.backend.sense(self.vth_stack(wls), plan)

    def page_read(self, wl: WordlineKey, which: str = "lsb",
                  packed: bool = True, *, encoding: str = tlc.MLC) -> torch.Tensor:
        """Standard (default-reference) page read."""
        out = self.page_read_batch([wl], which, encoding=encoding)
        return out[0] if packed else kernel_ref.unpack_bits(out)[0]

    def copyback_align(self, srcs_a: List[WordlineKey],
                       srcs_b: List[WordlineKey], dsts: List[WordlineKey],
                       which_a: str = "lsb", which_b: str = "lsb") -> None:
        """Realign scattered operand pages onto shared wordlines (Fig 9e):
        for each ``(src_a, src_b, dst)``, two page reads and one shared-page
        copyback program, on die.  The reads of the whole run sense in one
        call per role and the programs write the arena once; the ledger
        books every command per wordline, in the order one wordline at a
        time would (read a, read b, program).  ``dsts`` are fresh
        wordlines, so no program changes a row a later read senses."""
        if not len(srcs_a) == len(srcs_b) == len(dsts):
            raise ValueError("one source pair per destination wordline")
        if not dsts:
            return
        plan_a = self.page_read_plan(which_a)
        plan_b = self.page_read_plan(which_b)
        bits_a = kernel_ref.unpack_bits(
            self.backend.sense(self.vth_stack(srcs_a), plan_a))
        bits_b = kernel_ref.unpack_bits(
            self.backend.sense(self.vth_stack(srcs_b), plan_b))
        # the sensed bits are the device's own: they are the records too
        self._program_rows(dsts, list(bits_a), list(bits_b),
                           records=(bits_a, bits_b))
        for wa, wb, dst in zip(srcs_a, srcs_b, dsts):
            self.account_page_read_batch([wa], which_a,
                                         phases=plan_a.sensing_phases)
            self.account_page_read_batch([wb], which_b,
                                         phases=plan_b.sensing_phases)
            self._book_program([dst], tlc.MLC)

    def erase_block(self, plane: int, block: int) -> None:
        self.pe_counts[(plane, block)] = self.pe_counts.get((plane, block), 0) + 1
        stale = [k for k in self._slot_of if k[0] == plane and k[1] == block]
        self.arena.free([self._slot_of.pop(wl) for wl in stale])
        for wl in stale:
            self._operands.pop(wl, None)
            self._encoding_of.pop(wl, None)
        # block erase ~ 3.5 ms, energy ~ 2x page program
        self.ledger.add_die(self.die_of_plane(plane), 3500.0,
                            2 * self.energy.e_prog_uj_kb * self.config.page_kb,
                            category="erase",
                            label=f"erase p{plane}b{block}")

    def dma_to_controller(self, wl: WordlineKey) -> None:
        """Account a page transfer NAND -> controller on the wordline's channel."""
        self.dma_to_controller_batch([wl])

    def dma_to_controller_batch(self, wls: List[WordlineKey]) -> None:
        """Account NAND -> controller transfers for a page batch in one call."""
        if not wls:
            return
        self.ledger.add_channel_batch(self.dma_cost(wls))

    def ext_to_host(self, n_bytes: int) -> None:
        self.ledger.add_host(n_bytes / (self.config.host_bw_gbps * 1e3),
                             label=f"to-host {n_bytes}B")

    def age(self, hours: float) -> None:
        """Advance simulated retention time: every already-programmed arena
        row drifts down by the fault model's uniform retention term (later
        programs age from the new baseline).  No-op without a fault model."""
        if self.faults is None or hours <= 0:
            return
        delta = self.faults.age_delta(hours)
        refs = list(self._slot_of.values())
        if refs and delta != 0.0:
            self.arena.write(refs, self.arena.gather(refs) + delta)

    # -- oracles for verification -------------------------------------------
    def stored_operands(self, wl: WordlineKey) -> Tuple[torch.Tensor, ...]:
        """Stored page bits in role order (2 pages for MLC/reduced, 3 TLC)."""
        records, row = self._operands[wl]
        return tuple(rows[row] for rows in records)

    def encoding_of(self, wl: WordlineKey) -> str:
        """Row encoding of a programmed wordline."""
        return self._encoding_of[wl]

    def expected(self, wl: WordlineKey, op: str) -> torch.Tensor:
        """Logical oracle of ``op`` over a 2-page wordline's stored bits."""
        pages = self.stored_operands(wl)
        if len(pages) != 2:
            raise ValueError("expected() models 2-operand wordlines; 3-page "
                             "TLC wordlines need a 3-operand oracle")
        lsb, msb = pages
        return mcflash.expected_result(op, lsb, msb)
