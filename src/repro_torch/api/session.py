"""ComputeSession: the public way to run MCFlash bulk bitwise compute.

A session owns (or wraps) a simulated flash device + FTL, registers named
bit-vectors as :class:`BitVector` handles, records bitwise expressions into
a lazy op DAG, and on :meth:`materialize`:

1. canonicalises the DAG (:func:`repro_torch.api.graph.simplify`);
2. hands it to the :class:`~repro_torch.api.executor.Executor`, which lowers
   it into a static ``ExecPlan`` and replays a cached runner when the DAG
   shape was seen before;
3. books every command in the unified :class:`~repro_torch.api.ledger.Ledger`.

The session runs on the card: ``device=None`` means ``"cuda"``, where the
backend launches the hand-written kernels (``stats()["backend"]`` is
``"cuda"``), and raises when there is no card.  ``device="cpu"`` runs the
kernels' plain versions (backend ``"sim"``).

Its defaults are the JAX package's: every lowered plan passes the static
verifier (``verify=None`` reads ``$REPRO_VERIFY``, falling back to
``"on"``), and ``faults=None`` reads ``$REPRO_FAULTS``.  ``trace=`` attaches
a :class:`~repro_torch.obs.Tracer`; ``faults=`` / ``recovery=`` install the
wear model and the checkword-verified recovery ladder
(:mod:`repro_torch.reliability`).  :meth:`materialize_batch` and
:meth:`materialize_batch_async` lower many expressions in one pass, the
dispatch of :class:`repro_torch.serve.QueryEngine`.
"""
from __future__ import annotations

import dataclasses
import os
from collections import OrderedDict
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.api import predicates
from repro_torch.api.backends import Backend
from repro_torch.api.executor import MAX_FUSED_OPERANDS, ExecPlan, Executor
from repro_torch.api.graph import ASSOCIATIVE, BitVector, Leaf, simplify
from repro_torch.api.hostio import DrainHandle, HostDrainQueue
from repro_torch.api.plan_cache import PlanCache
from repro_torch.core import encoding, tlc
from repro_torch.core.mcflash import ReadPlan
from repro_torch.core.vth_model import ChipModel
from repro_torch.kernels import ref as kernel_ref
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import Tracer, traced
from repro_torch.reliability import FaultConfig, FaultModel
from repro_torch.verify import PlanContext, PlanVerifier

__all__ = ["ComputeSession", "resolve_device"]

#: session-owned Counter metrics, each readable as a plain-int attribute
_SESSION_COUNTERS = (
    ("fused_reduce_calls", "combine steps (incl. fused kernels)"),
    ("in_flash_senses", "logical senses (one per pair / NOT)"),
    ("sense_items", "senses + leaf reads (grouped per plan)"),
    ("sense_batches", "batched per-die sense kernel dispatches"),
    ("sense_waves", "topology-schedule waves dispatched"),
    ("megakernel_calls", "fused sense->reduce(->popcount) passes"),
    ("tiled_megakernel_splits", "fused chains split into several passes"),
    ("placed_unit_dispatches", "wave units issued on their shard's entry"),
    ("host_drain_submits", "async device->host transfers enqueued"),
    ("host_drain_blocks", "drain-queue backpressure stalls (queue full)"),
    ("coalesced_sense_groups", "batch sense groups shared by >1 request"),
    ("waves_shared", "schedule waves carrying work of >1 request"),
    ("tail_mask_evictions", "tail-mask cache entries evicted (LRU bound)"),
    ("slot_table_builds", "page lists' slot tables built for in-place senses"),
    ("slot_table_reuses", "dispatch lookups that found a current slot table"),
    ("placement_profile_builds",
     "page lists' die / channel counts built for ledger costs"),
    ("placement_profile_reuses",
     "lowering / accounting lookups that found a page list's counts"),
    ("encoded_sense_units", "units sensed under a TLC / reduced-MLC plan"),
    ("sensing_phases", "sensing phases of those encoded units"),
    ("sense_counted_roots",
     "counted roots sensed and counted in one sense_popcount call"),
    ("pipelined_drains", "drained roots sensed and copied host-ward in chunks"),
    ("drain_chunks", "chunks those roots were sensed and copied in"),
    ("between_predicates", "range predicates built by between()"),
    ("between_nodes", "graph nodes those predicates built"),
    ("shared_row_senses",
     "multi-plan sense calls, each one page list's rows read once for its "
     "plans (one mlc_sense_multi launch per 8 plans and 32 tables); the "
     "recovery ladder's shifted re-runs are not booked"),
    ("shared_row_items", "sense items those calls served"),
)

#: per-shape tail-mask cache bound
TAIL_MASK_CACHE_CAP = 32


def resolve_device(device: "torch.device | str | None") -> torch.device:
    """``None`` -> the card; raises when the card is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card; pass device='cpu' "
            "to run its plain versions on the CPU")
    return dev


class ComputeSession:
    """Session-level MCFlash compute over named bit-vector handles.

    ``device`` is the torch device (``None`` = the card).  ``flash`` or
    ``ftl`` wrap an existing :class:`~repro_torch.flash.device.FlashDevice`
    (its device then rules).
    """

    def __init__(self, device: "torch.device | str | None" = None, *,
                 flash=None, ftl=None, chip=None, config=None, timing=None, energy=None,
                 seed: int = 0, encoding: str = tlc.MLC,
                 trace: "bool | Tracer" = False,
                 verify: "str | None" = None, faults=None, recovery=None,
                 overlap: "bool | str | None" = None,
                 drain_depth: "int | None" = None):
        from repro_torch.flash.device import FlashDevice
        from repro_torch.flash.ftl import FTL

        if encoding not in tlc.ENCODINGS:
            raise ValueError(f"unknown encoding {encoding!r}; "
                             f"pick one of {tlc.ENCODINGS}")
        #: row encoding this session writes (and senses) vectors under
        self.encoding = encoding

        build_kwargs = {"chip": chip, "config": config, "timing": timing,
                        "energy": energy}
        if ftl is not None:
            if flash is not None and flash is not ftl.device:
                raise ValueError("flash and ftl disagree; pass one or the other")
            flash = ftl.device
        if flash is not None:
            if any(v is not None for v in build_kwargs.values()) or seed != 0:
                raise ValueError(
                    "chip/config/timing/energy/seed only apply when the "
                    "session constructs its own FlashDevice")
            if device is not None and torch.device(device) != flash.device:
                raise ValueError(f"device {device} disagrees with the flash "
                                 f"device's {flash.device}")
            self.device = flash
        else:
            self.device = FlashDevice(seed=seed, device=resolve_device(device),
                                      **build_kwargs)
        self.torch_device = self.device.device
        self.ftl = ftl or getattr(self.device, "ftl", None) or FTL(self.device)
        # the FTL's checked reads (realignment under faults) follow this
        # session's reliability manager; the latest session wins
        self.ftl._session = self
        self.backend: Backend = self.device.backend
        self.plans: PlanCache = self.device.plans     # shared per-chip plan cache
        self.ledger = self.device.ledger
        #: inter-resource ledger timing mode (see repro_torch.api.ledger)
        if overlap is not None or drain_depth is not None:
            if overlap is None:
                mode = self.ledger.mode
            elif overlap is True or overlap == "overlap":
                mode = "overlap"
            elif overlap == "sync":
                mode = "sync"
            elif overlap is False or overlap == "independent":
                mode = "independent"
            else:
                raise ValueError(
                    f"overlap must be True/False, 'overlap', 'sync', or "
                    f"'independent', got {overlap!r}")
            self.ledger.set_mode(mode, drain_depth=drain_depth)
        self.executor = Executor(self)
        #: static ExecPlan verifier (``"off"`` | ``"on"`` | ``"paranoid"``),
        #: run at lowering time and memoized by plan signature
        self.verifier = PlanVerifier(
            verify if verify is not None
            else os.environ.get("REPRO_VERIFY", "on"))
        self.metrics = MetricsRegistry()
        for name, desc in _SESSION_COUNTERS:
            self.metrics.counter(name, desc)
        self.metrics.gauge("max_concurrent_dies",
                           "widest per-wave die concurrency seen")
        self.metrics.histogram("wave_dies", "concurrent dies per wave")
        self.metrics.histogram("fused_operands", "operands per fused kernel")
        #: bounded async device->host drain queue behind materialize_async
        self.host_queue = HostDrainQueue(
            depth=self.ledger.drain_depth,
            on_submit=self._on_drain_submit,
            on_block=lambda: self.metrics.counter("host_drain_blocks").add(1))
        #: device-timeline tracer (``trace=True`` builds one, or pass a
        #: :class:`Tracer`); it attaches to the device ledger, so every
        #: command this session triggers lands on its lanes.  The latest
        #: traced session on a shared device wins.
        self.trace: "Tracer | None" = None
        if trace:
            self.trace = trace if isinstance(trace, Tracer) else Tracer()
            self.ledger.tracer = self.trace
        self.host_queue.tracer = self.trace
        self._tail_masks: "OrderedDict[Tuple[int, int], torch.Tensor]" = \
            OrderedDict()
        #: wear fault injection (``faults=`` or ``$REPRO_FAULTS``, any spec
        #: :meth:`FaultConfig.parse` accepts) and recovery: ``recovery=None``
        #: turns the ladder on when the device has a fault model, ``"off"``
        #: keeps it off under faults, and a dict / :class:`RetryPolicy` /
        #: ``True`` turns it on with that policy
        fault_cfg = FaultConfig.parse(
            faults if faults is not None else os.environ.get("REPRO_FAULTS"))
        if fault_cfg is not None:
            self.device.faults = FaultModel(fault_cfg)
        self.reliability = None
        if recovery != "off" and (recovery is not None
                                  or self.device.faults is not None):
            from repro_torch.reliability.recovery import ReliabilityManager
            self.reliability = ReliabilityManager(
                self, None if recovery in (None, True, "on") else recovery)

    # -- registration --------------------------------------------------------
    def _bits(self, bits) -> torch.Tensor:
        """Host or device bits -> a uint8 tensor on this session's device."""
        if not isinstance(bits, torch.Tensor):
            bits = torch.from_numpy(np.ascontiguousarray(bits, dtype=np.uint8))
        return bits.to(device=self.torch_device, dtype=torch.uint8)

    def write(self, name: str, bits, role: str = "lsb",
              die: "int | None" = None) -> BitVector:
        """Store a single named bit-vector (scattered; realigned on demand).
        ``die`` pins the home die; default round-robins across dies."""
        self.ftl.write_scattered(name, self._bits(bits), role=role, die=die,
                                 encoding=self.encoding)
        return self.vector(name)

    def write_pair(self, name_a: str, bits_a, name_b: str, bits_b,
                   die: "int | None" = None) -> Tuple[BitVector, BitVector]:
        """Store two operands co-located on shared wordlines (the fast path)."""
        self.ftl.write_pair_aligned(name_a, self._bits(bits_a),
                                    name_b, self._bits(bits_b), die=die,
                                    encoding=self.encoding)
        return self.vector(name_a), self.vector(name_b)

    def write_triple(self, name_a: str, bits_a, name_b: str, bits_b,
                     name_c: str, bits_c, die: "int | None" = None
                     ) -> Tuple[BitVector, BitVector, BitVector]:
        """Store three operands co-located on one TLC wordline's LSB/CSB/MSB
        pages (§7): 3-operand AND/OR then take one sense.  TLC only."""
        if tlc.PAGES_PER_WL[self.encoding] < 3:
            raise ValueError(
                f"write_triple needs a 3-page encoding, not {self.encoding!r}")
        self.ftl.write_group_aligned(
            [name_a, name_b, name_c],
            [self._bits(bits_a), self._bits(bits_b), self._bits(bits_c)],
            die=die, encoding=self.encoding)
        return (self.vector(name_a), self.vector(name_b),
                self.vector(name_c))

    def vector(self, name: str) -> BitVector:
        """Handle to an already-registered vector."""
        meta = self.ftl.vectors[name]
        return BitVector(self, Leaf(name), meta.n_bits)

    def __getitem__(self, name: str) -> BitVector:
        return self.vector(name)

    def chain(self, op: str, operands: "Iterable[BitVector | str]") -> BitVector:
        """Fold handles (or registered names) into one lazy k-ary op node
        (``op`` is 'and' | 'or' | 'xor')."""
        if op not in ASSOCIATIVE:
            raise ValueError(f"chains are associative ops only, got {op!r}")
        vecs = [self.vector(v) if isinstance(v, str) else v for v in operands]
        if not vecs:
            raise ValueError("empty operand chain")
        expr = vecs[0]
        for v in vecs[1:]:
            expr = expr._binary(op, v)
        return expr

    def between(self, slices: Sequence[str], lo: int, hi: int) -> BitVector:
        """Rows whose code over the bit-slice vectors ``slices`` (names,
        most significant first) lies in ``lo <= v <= hi``; empty when
        ``lo > hi``.  Built from Table-1 pair senses and page reads alone
        (:mod:`repro_torch.api.predicates`), in a ``predicate`` span."""
        digs = predicates.digits(self.ftl, slices)
        with traced(self.trace, "predicate", "between", digits=len(digs),
                    lo=int(lo), hi=int(hi)):
            expr = predicates.between(self, digs, lo, hi)
        self.metrics.counter("between_predicates").add(1)
        self.metrics.counter("between_nodes").add(predicates.count_nodes(expr))
        return expr

    # -- planning ------------------------------------------------------------
    @property
    def chip(self) -> ChipModel:
        return self.device.chip

    def plan(self, op: str, use_inverse_read: bool = True) -> ReadPlan:
        """Cached Table-1 read plan for this session's chip model."""
        return self.plans.get(op, self.chip, use_inverse_read)

    def describe_plans(self, ops: Iterable[str] = encoding.ALL_OPS) -> List[str]:
        return [self.plan(op).describe() for op in ops]

    # -- execution -----------------------------------------------------------
    def plan_context(self) -> PlanContext:
        """Device/session geometry the static plan verifier checks against."""
        return PlanContext(
            die_of_plane=self.device.die_of_plane,
            page_words=self.ftl.cfg.page_bits // 32,
            max_fused_operands=MAX_FUSED_OPERANDS)

    def verify_lowered_plan(self, plan: ExecPlan,
                            signature: "tuple | None" = None) -> None:
        """Hook the executor calls on every freshly lowered plan; raises
        :class:`repro_torch.verify.PlanInvariantError` before any dispatch
        when a schedule invariant is violated.  No-op with
        ``verify="off"``."""
        if self.verifier.enabled:
            self.verifier.verify(plan, self.plan_context(), signature)

    def _canonical(self, exprs: Sequence[BitVector]) -> List:
        """The canonical DAG of each expression (a ``simplify`` span)."""
        with traced(self.trace, "simplify", "simplify"):
            return [simplify(e.node) for e in exprs]

    def lower(self, expr: BitVector) -> ExecPlan:
        """Canonicalize + lower ``expr`` to its static :class:`ExecPlan`
        without dispatching (the plan is still verified)."""
        return self.executor.lower(self._canonical([expr])[0])

    def materialize(self, expr: BitVector, *, unpacked: bool = False,
                    to_host: bool = True) -> torch.Tensor:
        """Compile + execute the expression DAG; returns the result vector
        on the session's device.

        Packed int32 words by default — page-padded, with any bits beyond
        ``expr.n_bits`` masked to zero; ``unpacked=True`` returns per-cell
        uint8 bits trimmed to ``expr.n_bits``.  ``to_host`` books the final
        controller->host transfer in the ledger.
        """
        packed = self._checked_words(self._canonical([expr])[0], expr.n_bits)
        if to_host:
            self.device.ext_to_host(int(packed.shape[-1]) * 4)
        if unpacked:
            return kernel_ref.unpack_bits(packed.reshape(1, -1))[0][: expr.n_bits]
        return packed

    def _checked_words(self, node, n_bits: int) -> torch.Tensor:
        """Packed words of a canonical DAG, checkword-verified (and
        recovered) when the reliability layer is on."""
        packed = self.executor.run(node, n_bits)
        if self.reliability is not None:
            packed = self.reliability.verify_and_recover(node, n_bits, packed)
        return packed

    def _on_drain_submit(self, n_bytes: int) -> None:
        self.metrics.counter("host_drain_submits").add(1)
        self.device.ext_to_host(n_bytes)

    def materialize_async(self, expr: BitVector) -> DrainHandle:
        """Like :meth:`materialize`, but stream the packed result to the host
        through the bounded drain queue; ``handle.result()`` (or
        :meth:`drain`) returns it as a numpy uint32 array.  Without the
        reliability layer, a root whose plan is one sense drains in chunks
        as it is sensed (:meth:`Executor.run_drained`); checkword recovery
        needs the whole words first."""
        node = self._canonical([expr])[0]
        if self.reliability is None:
            drain = self.host_queue.open()
            packed = self.executor.run_drained(node, expr.n_bits, drain)
            if packed is None:
                return self.host_queue.admit(drain)
        else:
            packed = self._checked_words(node, expr.n_bits)
        return self.host_queue.submit(packed, int(packed.shape[-1]) * 4)

    def drain(self) -> List[np.ndarray]:
        """Resolve every in-flight :meth:`materialize_async` transfer."""
        return [h.result() for h in self.host_queue.drain()]

    # -- cross-request batch execution (the serving engine's dispatch) -------
    def lower_batch(self, exprs: Sequence[BitVector],
                    rids: "Optional[Sequence[int]]" = None) -> ExecPlan:
        """Lower a batch of expressions through ONE shared pass without
        dispatching: identical sub-DAGs dedupe and same-(ReadPlan, die)
        senses coalesce into shared groups/waves.  ``rids`` tags the plan's
        sense items with owning request ids (trace/metrics attribution)."""
        return self.executor.lower_many(
            self._canonical(exprs),
            list(rids) if rids is not None else None)

    def _run_batch(self, exprs: Sequence[BitVector],
                   popcounts: Tuple[bool, ...],
                   rids: "Optional[Sequence[int]]" = None
                   ) -> List[torch.Tensor]:
        """One coalesced executor run; under the reliability layer every
        root materializes as words first (the fused on-device popcount would
        hide bit errors), is verified/recovered per root, and counts fold
        afterwards."""
        nodes = self._canonical(exprs)
        n_bits = [e.n_bits for e in exprs]
        rid_list = list(rids) if rids is not None else None
        if self.reliability is not None:
            outs = self.executor.run_batch(nodes, n_bits,
                                           (False,) * len(nodes),
                                           rids=rid_list)
            fixed: List[torch.Tensor] = []
            for node, nb, pc, packed in zip(nodes, n_bits, popcounts, outs):
                packed = self.reliability.verify_and_recover(node, nb, packed)
                fixed.append(self.backend.popcount(packed.reshape(1, -1))[0]
                             if pc else packed)
            return fixed
        return self.executor.run_batch(nodes, n_bits, popcounts,
                                       rids=rid_list)

    @staticmethod
    def _popcount_flags(exprs, popcount) -> Tuple[bool, ...]:
        flags = (tuple(bool(p) for p in popcount) if popcount is not None
                 else (False,) * len(exprs))
        if len(flags) != len(exprs):
            raise ValueError(f"{len(flags)} popcount flags for "
                             f"{len(exprs)} expressions")
        return flags

    def materialize_batch(self, exprs: Sequence[BitVector], *,
                          popcount: "Optional[Sequence[bool]]" = None,
                          rids: "Optional[Sequence[int]]" = None,
                          to_host: bool = True) -> List:
        """Materialize N expressions through ONE coalesced lowering and
        dispatch: returns one packed word tensor, or ``int`` count where
        ``popcount[i]``, per expression, in order.  Bit-exact against
        materializing each expression on its own."""
        popcounts = self._popcount_flags(exprs, popcount)
        outs = self._run_batch(exprs, popcounts, rids)
        results: List = []
        for out, pc in zip(outs, popcounts):
            if to_host:
                self.device.ext_to_host(4 if pc else int(out.shape[-1]) * 4)
            results.append(int(out) if pc else out)
        return results

    def materialize_batch_async(self, exprs: Sequence[BitVector], *,
                                popcount: "Optional[Sequence[bool]]" = None,
                                rids: "Optional[Sequence[int]]" = None
                                ) -> List[DrainHandle]:
        """Batch variant of :meth:`materialize_async`: one coalesced
        dispatch, then every root's result streams host-ward through the
        bounded drain queue, one rid-tagged :class:`DrainHandle` per
        expression, in order."""
        popcounts = self._popcount_flags(exprs, popcount)
        outs = self._run_batch(exprs, popcounts, rids)
        rid_list = list(rids) if rids is not None else [None] * len(exprs)
        return [self.host_queue.submit(out, rid=rid)
                for out, rid in zip(outs, rid_list)]

    def tail_mask(self, n_bits: int, total_words: int) -> torch.Tensor:
        """Packed (total_words,) mask zeroing page-padding bits past
        ``n_bits`` (inverse-read ops turn padded zeros into ones).  Cached
        per shape under a small LRU bound."""
        total = total_words * 32
        key = (min(n_bits, total), total)
        mask = self._tail_masks.get(key)
        if mask is None:
            if n_bits >= total:
                mask = torch.full((total_words,), -1, dtype=torch.int32,
                                  device=self.torch_device)
            else:
                bits = torch.zeros((1, total), dtype=torch.uint8,
                                   device=self.torch_device)
                bits[0, :n_bits] = 1
                mask = kernel_ref.pack_bits(bits)[0]
            self._tail_masks[key] = mask
            while len(self._tail_masks) > TAIL_MASK_CACHE_CAP:
                self._tail_masks.popitem(last=False)
                self.metrics.counter("tail_mask_evictions").add(1)
        else:
            self._tail_masks.move_to_end(key)
        return mask

    def popcount(self, expr: BitVector, *, to_host: bool = True) -> int:
        """Materialize + bit-count on the device; the count fuses into the
        root kernel when the plan allows, and only the 4-byte count crosses
        to the host."""
        node = self._canonical([expr])[0]
        if self.reliability is not None:
            # words must exist to checkword-verify; the count then folds
            # afterwards (the fused popcount would hide bit errors)
            packed = self._checked_words(node, expr.n_bits)
            count = self.backend.popcount(packed.reshape(1, -1))[0]
        else:
            count = self.executor.run_popcount(node, expr.n_bits)
        if to_host:
            self.device.ext_to_host(4)
        return int(count)

    def stats(self) -> dict:
        return {
            "backend": self.backend.name,
            "device": str(self.torch_device),
            "encoding": self.encoding,
            "arena_rows_by_encoding": self.device.arena.used_by_encoding(),
            "plan_cache": self.plans.stats(),
            "executor": self.executor.stats(),
            "fused_reduce_calls": self.fused_reduce_calls,
            "in_flash_senses": self.in_flash_senses,
            "sense_items": self.sense_items,
            "sense_batches": self.sense_batches,
            "sense_waves": self.sense_waves,
            "max_concurrent_dies": self.max_concurrent_dies,
            "megakernel_calls": self.megakernel_calls,
            "tiled_megakernel_splits": self.tiled_megakernel_splits,
            "placed_unit_dispatches": self.placed_unit_dispatches,
            "slot_table_builds": self.slot_table_builds,
            "slot_table_reuses": self.slot_table_reuses,
            "placement_profile_builds": self.placement_profile_builds,
            "placement_profile_reuses": self.placement_profile_reuses,
            "encoded_sense_units": self.encoded_sense_units,
            "sensing_phases": self.sensing_phases,
            "sense_counted_roots": self.sense_counted_roots,
            "pipelined_drains": self.pipelined_drains,
            "drain_chunks": self.drain_chunks,
            "between_predicates": self.between_predicates,
            "between_nodes": self.between_nodes,
            "shared_row_senses": self.shared_row_senses,
            "shared_row_items": self.shared_row_items,
            "host_drain": {"submits": self.host_drain_submits,
                           "blocks": self.host_drain_blocks,
                           "pending": len(self.host_queue),
                           "depth": self.host_queue.depth},
            "coalesced_sense_groups": self.coalesced_sense_groups,
            "waves_shared": self.waves_shared,
            "tail_mask_cache": {"size": len(self._tail_masks),
                                "cap": TAIL_MASK_CACHE_CAP,
                                "evictions": self.tail_mask_evictions},
            "plans_verified": self.verifier.plans_verified,
            "verify_cache_hits": self.verifier.cache_hits,
            "verify": {"mode": self.verifier.mode,
                       "time_us": self.verifier.time_us},
            "arena_shards": self.device.arena.n_shards,
            "ledger": self.ledger.summary(),
            "faults": (dataclasses.asdict(self.device.faults.cfg)
                       if self.device.faults is not None else None),
            "reliability": (self.reliability.stats()
                            if self.reliability is not None else None),
        }

    def reset_stats(self, include_ledger: bool = True) -> None:
        """Zero this session's metrics (and, by default, the shared ledger).
        Device-shared cache counters are left alone, and an attached tracer
        keeps its spans (``sess.trace.clear()`` drops them)."""
        self.metrics.reset()
        self.verifier.reset()
        self.host_queue.reset()
        if self.reliability is not None:
            self.reliability.reset()
        if include_ledger:
            self.ledger.reset()


def _metric_value_property(name: str) -> property:
    def get(self) -> int:
        return int(self.metrics[name].value)
    get.__name__ = name
    return property(get)


# plain-int views of the registry-backed session counters
for _name, _ in _SESSION_COUNTERS:
    setattr(ComputeSession, _name, _metric_value_property(_name))
setattr(ComputeSession, "max_concurrent_dies",
        _metric_value_property("max_concurrent_dies"))
