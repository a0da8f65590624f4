"""Compiled DAG executor: topology-aware schedule + cached runners.

The executor lowers a canonical (:func:`repro_torch.api.graph.simplify`-ed)
DAG into a static :class:`ExecPlan`, exactly as the JAX package does:

1. **Lowering** walks the DAG once, resolving placement (aligning scattered
   pairs, building NOT-ready copies) and emitting sense items plus a
   combine schedule.
2. **Fusion** rewrites any combine whose inputs are single-use, same-plan
   senses into one fused ``sense_reduce`` kernel call (with a popcount
   root, only the counts leave the kernel).  Chains longer than
   ``MAX_FUSED_OPERANDS`` split into several passes.  A counted root
   whose plan is one sense (one group of one item) is sensed and counted
   in one ``sense_popcount`` call, its words never written; such a root
   drained to the host uncounted (:meth:`Executor.run_drained`) is sensed
   ``DRAIN_CHUNK_PAGES`` pages at a time, each chunk's copy to the host
   starting as soon as the chunk is written.
3. **Grouping** buckets every remaining sense by (:class:`ReadPlan`, die),
   so all same-plan senses on one die run in ONE batched kernel call.  The
   runner then reads each page list once where several of a stream's
   groups sense it (:func:`_row_sharing`, part of the runner-cache key):
   one ``sense_multi`` call computes every read plan its items take over
   it.
4. **Scheduling** packs the per-die groups and fused calls into
   topological waves: units on different dies share a wave, units
   contending for a die serialize, combines attach to the wave their last
   input becomes ready in.
5. **Caching**: the runner built for a plan is cached in the device-shared
   :class:`~repro_torch.api.plan_cache.ExecutableCache` keyed on the plan
   signature.  PyTorch runs eagerly, so the runner is a plain Python loop
   over backend calls; building it counts as the one trace, so the
   ``misses``/``traces`` counters keep the JAX package's meaning.
6. **Placement**: when the device's arena maps its shards onto entries
   (``FlashDevice(shard_devices=...)``), the placed runner issues each
   die-local unit on its shard's stream and each controller combine on
   the compute stream after the events of its producers; the placement
   layout ends the cache key, so placed and unplaced runners never mix.

Every lowered plan passes the session's static verifier
(:mod:`repro_torch.verify`) before any dispatch; with a tracer attached the
executor records lowering, verification, ledger accounting, runner build
and dispatch (the slot-table lookups and the runner's launches inside it) as
wall-clock spans, serving batches' spans tagged with their request ids,
and runner-cache evictions as instants.  Cache hits and misses are the
cache's own ``hits``/``misses`` counters; a miss is also a ``compile``
span.

Ledger accounting is wave-batched: each schedule wave books one parallel
``add_die_batch`` step plus one ``add_channel_batch`` for its transfers,
from :meth:`Executor.wave_costs`, the one description of what a wave costs
(the recovery ladder's shifted re-run books from it too, and runs through
an uncached runner of :meth:`Executor._build`).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.api.graph import ASSOCIATIVE, BASE_OF, Leaf, Node, Op
from repro_torch.api.hostio import ChunkedDrain
from repro_torch.core import tlc as _tlc
from repro_torch.core.mcflash import ReadPlan
from repro_torch.flash.device import PAGE_READ_OP
from repro_torch.kernels.rows import Rows
from repro_torch.obs.trace import traced
from repro_torch.verify.invariants import check_overlap_consistency

__all__ = ["ExecPlan", "Executor", "ProgramStep", "SharedRows", "Wave",
           "WaveCost", "DRAIN_CHUNK_PAGES", "MAX_FUSED_OPERANDS",
           "schedule_programs_into_idle_waves"]

WordlineKey = Tuple[int, int, int]

#: most operands one fused pass takes: 32, what the JAX package's default
#: VMEM budget allows, so both packages split long chains alike.  The CUDA
#: kernel keeps one word per operand in registers and no operand tile in
#: shared memory, so on the card this shapes plans only.
MAX_FUSED_OPERANDS = 32

#: pages a drained root whose plan is one sense is sensed in at a time, each
#: chunk copied to the host while the next is sensed: large enough that a
#: chunk's copy runs at the link's rate, small enough that the first sense,
#: which no copy overlaps, is short
DRAIN_CHUNK_PAGES = 544


@dataclasses.dataclass
class SenseItem:
    """One logical sense/read: all pages of one stored vector."""
    pid: int                      # partial id its packed result binds to
    name: str                     # vector whose pages are sensed
    #: the stored vector's own page list (not a copy: the device caches
    #: its slot tables and placement profile per list)
    wls: List[WordlineKey]
    plan: ReadPlan
    op_label: str                 # timing/energy op label
    is_mcflash: bool              # MCFlash sense (True) vs default-ref read
    which: Optional[str] = None   # page-read role when not is_mcflash
    dies: Tuple[int, ...] = ()    # dies this item's pages live on (sorted)
    #: owning serving-request ids (attribution only — NEVER part of
    #: plan_key/signature, so coalesced batches still share groups and
    #: isomorphic batches still share executables)
    rids: Tuple[int, ...] = ()

    @property
    def plan_key(self) -> tuple:
        return (self.plan, self.op_label, self.is_mcflash, self.which,
                self.dies)


@dataclasses.dataclass
class FusedSpec:
    """A combine folded into one sense_reduce megakernel call."""
    plan: ReadPlan
    op_label: str
    wls: List[WordlineKey]        # n_operands * n_pages, operand-major
    n_operands: int
    n_pages: int
    dies: Tuple[int, ...] = ()    # dies spanned by the operand pages (sorted)
    #: operands taken per fused pass
    pass_operands: int = 1
    #: owning serving-request ids (attribution only, never keyed on)
    rids: Tuple[int, ...] = ()
    #: each operand's page list (its item's ``wls``), whose slot table the
    #: kernel reads it through
    operands: Tuple[List[WordlineKey], ...] = ()


@dataclasses.dataclass
class ProgramStep:
    """A placement write (realignment copyback / NOT-ready program) issued
    *during lowering*, before any wave dispatches.  Recorded on the plan so
    the slot-hazard checker can prove every program/scatter is separated
    from the senses of the same wordlines by a wave barrier: lowering-time
    programs occupy the implicit pre-dispatch barrier wave ``-1``."""
    label: str
    wls: List[WordlineKey]
    dies: Tuple[int, ...] = ()
    wave: int = -1                # barrier wave the write completes in


@dataclasses.dataclass
class CombineStep:
    out: int
    args: Tuple[int, ...]
    op: str
    invert: bool
    fused: Optional[FusedSpec] = None


@dataclasses.dataclass
class SenseGroup:
    """All non-fused senses sharing one (ReadPlan, die): ONE batched kernel
    call reading ONE arena shard, through its items' slot tables in order."""
    plan: ReadPlan
    op_label: str
    is_mcflash: bool
    which: Optional[str]
    dies: Tuple[int, ...]
    items: List[SenseItem]

    @property
    def wls(self) -> List[WordlineKey]:
        return [wl for it in self.items for wl in it.wls]

    @property
    def page_lists(self) -> List[List[WordlineKey]]:
        """Its items' stored page lists, in order: the unit the device's
        cost models book from their placement profiles."""
        return [it.wls for it in self.items]

    @property
    def rids(self) -> Tuple[int, ...]:
        """Serving-request ids whose senses coalesced into this group."""
        return tuple(sorted({r for it in self.items for r in it.rids}))

    def spans(self) -> List[Tuple[int, Tuple[int, int]]]:
        """(pid, (row_start, row_end)) slices into the batched sense output."""
        out, start = [], 0
        for it in self.items:
            out.append((it.pid, (start, start + len(it.wls))))
            start += len(it.wls)
        return out


@dataclasses.dataclass
class Wave:
    """One schedule step: the listed units occupy disjoint dies, so they
    dispatch concurrently; the listed combines' inputs are all ready by the
    end of this wave (they interleave with later waves' senses)."""
    groups: List[int] = dataclasses.field(default_factory=list)   # -> plan.groups
    fused: List[int] = dataclasses.field(default_factory=list)    # -> plan.steps
    combines: List[int] = dataclasses.field(default_factory=list)  # -> plan.steps


@dataclasses.dataclass
class ExecPlan:
    """Static, signature-keyed execution schedule for one canonical DAG —
    or for a *batch* of DAGs lowered together (cross-request coalescing):
    ``roots`` then lists every root partial in request order while the
    scalar ``root`` / ``out_pages`` / ``out_words`` keep pointing at the
    first root for single-root callers."""
    groups: List[SenseGroup]
    steps: List[CombineStep]
    waves: List[Wave]
    root: int
    out_pages: int                # pages in the root partial
    out_words: int                # packed words in the root partial
    senses: int                   # logical in-flash senses (paper semantics)
    items: int                    # all sense/read items incl. fused operands
    concurrent_dies: int          # max dies busy in one wave
    #: lowering-time placement writes (barrier wave -1), for hazard checking
    programs: List[ProgramStep] = dataclasses.field(default_factory=list)
    #: batch roots in request order (empty == single-root plan)
    roots: Tuple[int, ...] = ()
    roots_pages: Tuple[int, ...] = ()
    roots_words: Tuple[int, ...] = ()

    @property
    def all_roots(self) -> Tuple[int, ...]:
        return self.roots or (self.root,)

    @property
    def all_root_pages(self) -> Tuple[int, ...]:
        return self.roots_pages or (self.out_pages,)

    @property
    def all_root_words(self) -> Tuple[int, ...]:
        return self.roots_words or (self.out_words,)

    def with_read_plans(self, fn: Callable[[ReadPlan], ReadPlan]
                        ) -> "ExecPlan":
        """This plan with each sense group's and fused step's read plan
        replaced by ``fn`` of it: structure, pids, waves and page lists are
        shared, only the read plans differ (the recovery ladder's shifted
        re-run)."""
        groups = [dataclasses.replace(g, plan=fn(g.plan)) for g in self.groups]
        steps = [st if st.fused is None else dataclasses.replace(
                     st, fused=dataclasses.replace(st.fused,
                                                   plan=fn(st.fused.plan)))
                 for st in self.steps]
        return dataclasses.replace(self, groups=groups, steps=steps)

    def signature(self, backend_name: str) -> tuple:
        """Hashable shape of the plan: everything the executable closes over
        (structure, plans, page counts, die *topology*, wave layout) minus
        the runtime inputs (the units' arena rows, mask) — the
        ExecutableCache key.

        Physical die ids are normalized to first-appearance order: the
        executable's wave structure depends only on which units *share* a
        die, so isomorphic layouts (a&b on dies {0,1} vs {0,2}) replay one
        executable.  The wave layout is part of the signature because the
        executable iterates it: die normalization alone cannot distinguish
        two plans whose units overlap dies differently (and therefore
        scheduled into different waves) once both normalize to the same
        per-unit die tuples.
        """
        remap: Dict[int, int] = {}

        def norm(dies: Tuple[int, ...]) -> Tuple[int, ...]:
            return tuple(remap.setdefault(d, len(remap)) for d in dies)

        return (
            backend_name,
            tuple((g.plan, g.op_label, norm(g.dies),
                   tuple((it.pid, len(it.wls)) for it in g.items))
                  for g in self.groups),
            tuple((st.out, st.args, st.op, st.invert,
                   (st.fused.plan, st.fused.n_operands, st.fused.n_pages,
                    norm(st.fused.dies))
                   if st.fused else None)
                  for st in self.steps),
            tuple((tuple(w.groups), tuple(w.fused), tuple(w.combines))
                  for w in self.waves),
            self.all_roots, self.all_root_words,
        )


def schedule_programs_into_idle_waves(plan: ExecPlan,
                                      steps: List[ProgramStep]) -> None:
    """Slot migration copyback programs into the plan's wave timeline.

    Each step is assigned the earliest wave whose busy dies (sense groups +
    fused kernels dispatched that wave, plus programs already slotted
    there) are disjoint from the step's own dies — the "idle die slot" the
    reliability layer fills while other dies sense.  A step no wave can host
    falls back to the pre-dispatch barrier wave ``-1`` (it serializes before
    wave 0 instead of overlapping).  Steps are appended to ``plan.programs``
    so the ``migration-barrier`` invariant can audit the placement.
    """
    busy: List[set] = []
    for w in plan.waves:
        dies: set = set()
        for gi in w.groups:
            dies.update(plan.groups[gi].dies)
        for si in w.fused:
            fused = plan.steps[si].fused
            if fused is not None:
                dies.update(fused.dies)
        busy.append(dies)
    for pr in plan.programs:
        if 0 <= pr.wave < len(busy):
            busy[pr.wave].update(pr.dies)
    for st in steps:
        st.wave = -1
        for wi, dies in enumerate(busy):
            if not dies.intersection(st.dies):
                st.wave = wi
                dies.update(st.dies)
                break
        plan.programs.append(st)


class _Lowering:
    """One DAG -> ExecPlan pass (resolves placement; cheap, pure Python)."""

    def __init__(self, session):
        self.session = session
        self.ftl = session.ftl
        self.device = session.device
        self.items: List[SenseItem] = []
        self.steps: List[CombineStep] = []
        self.programs: List[ProgramStep] = []
        self.pages_of: Dict[int, int] = {}    # pid -> page count
        self._next = 0

    def _pid(self, n_pages: int) -> int:
        pid = self._next
        self._next += 1
        self.pages_of[pid] = n_pages
        return pid

    def _dies_of(self, wls: List[WordlineKey]) -> Tuple[int, ...]:
        return tuple(sorted(self.device.placement_profile(wls)[0]))

    def _item(self, name: str, wls: List[WordlineKey], plan: ReadPlan,
              op_label: str, is_mcflash: bool, which: str | None = None) -> int:
        pid = self._pid(len(wls))
        self.items.append(SenseItem(pid, name, wls, plan, op_label,
                                    is_mcflash, which, self._dies_of(wls)))
        return pid

    def _read_leaf(self, name: str) -> int:
        meta = self.ftl.vectors[name]
        plan = self.session.device.page_read_plan(meta.role, meta.encoding)
        return self._item(name, meta.pages, plan, PAGE_READ_OP[meta.role],
                          is_mcflash=False, which=meta.role)

    def _sense_group(self, op: str, names: Tuple[str, ...]) -> int:
        """One in-flash sense over 2..3 co-located operands.

        MLC pairs use the Table-1 plans; TLC / reduced-MLC groups compile a
        multi-reference parity plan over the operands' shared-page roles —
        a 3-operand TLC AND is ONE single-reference sense."""
        enc = self.ftl.vectors[names[0]].encoding
        if enc == _tlc.MLC:
            assert len(names) == 2, names
            self.ftl.ensure_aligned(names[0], names[1])
            pages = self.ftl.vectors[names[0]].pages
            return self._item(names[0], pages, self.session.plan(op), op,
                              is_mcflash=True)
        self.ftl.ensure_colocated(names)
        metas = [self.ftl.vectors[n] for n in names]
        plan = self.device.plans.get_encoded(
            op, tuple(m.role for m in metas), self.device.tlc_chip, enc)
        return self._item(names[0], metas[0].pages, plan, plan.op,
                          is_mcflash=True)

    def _sense_pair(self, op: str, name_a: str, name_b: str) -> int:
        return self._sense_group(op, (name_a, name_b))

    def _sense_not(self, name: str) -> int:
        meta = self.ftl.vectors[name]
        if meta.encoding != _tlc.MLC:
            # encoded rows run NOT as a direct inverse role read — no
            # NOT-ready derived placement, zero extra phases
            plan = self.device.plans.get_encoded(
                "not", (meta.role,), self.device.tlc_chip, meta.encoding)
            return self._item(name, meta.pages, plan, plan.op,
                              is_mcflash=True)
        meta = self.ftl.ensure_not_ready(name)
        return self._item(meta.name, meta.pages, self.session.plan("not"),
                          "not", is_mcflash=True)

    def _lower_node(self, node: Op, memo: Dict[Node, int]) -> int:
        op = node.op
        if op == "not":
            (x,) = node.args
            if isinstance(x, Leaf):
                return self._sense_not(x.name)
            # canonical graphs fold ~(op ...) into the inverse twin, so this
            # only triggers on hand-built non-canonical nodes
            pid = self._pid(self.pages_of[memo[x]])
            self.steps.append(CombineStep(pid, (memo[x],), "and", True))
            return pid
        # exactly two stored operands: a single (possibly inverse-read) sense
        # (mixed-encoding operands cannot share a wordline; they fall through
        # to per-encoding leaf reads + a controller combine)
        if len(node.args) == 2 and all(isinstance(a, Leaf) for a in node.args) \
                and len({self.ftl.vectors[a.name].encoding
                         for a in node.args}) == 1:
            return self._sense_pair(op, node.args[0].name, node.args[1].name)
        base = BASE_OF.get(op, op)
        invert = op in BASE_OF
        assert base in ASSOCIATIVE or len(node.args) == 2, node
        leaves = [a for a in node.args if isinstance(a, Leaf)]
        others = [a for a in node.args if not isinstance(a, Leaf)]
        # bucket by row encoding: groups are pairs on MLC / reduced-MLC
        # wordlines and up to triples on TLC (a&b&c = ONE sense group)
        by_enc: Dict[str, List[str]] = {}
        for leaf in leaves:
            enc = self.ftl.vectors[leaf.name].encoding
            by_enc.setdefault(enc, []).append(leaf.name)
        args = []
        for names in by_enc.values():
            groups, leftover = self.ftl.group_for_sense(names)
            if (invert and not others and len(by_enc) == 1
                    and len(groups) == 1 and leftover is None
                    and self.ftl.vectors[groups[0][0]].encoding != _tlc.MLC):
                # a whole inverted op over ONE encoded group folds into a
                # single inverse-read sense (e.g. TLC ~(a&b&c): same refs
                # as AND3, inverse read) — no controller combine
                return self._sense_group(op, groups[0])
            args.extend(self._sense_group(base, g) for g in groups)
            if leftover is not None:
                args.append(self._read_leaf(leftover))
        args.extend(memo[o] for o in others)
        if len(args) == 1 and not invert:
            return args[0]
        pid = self._pid(self.pages_of[args[0]])
        self.steps.append(CombineStep(pid, tuple(args), base, invert))
        return pid

    def lower(self, root: Node) -> ExecPlan:
        return self.lower_many([root])

    def lower_many(self, roots: List[Node],
                   rids: Optional[List[int]] = None) -> ExecPlan:
        """Lower a batch of canonical DAGs through ONE pass with a shared
        memo: structurally identical sub-DAGs across requests dedupe for
        free (Node eq/hash is structural), and sense items from different
        requests that share a (ReadPlan, die) bucket coalesce into one
        batched kernel call in :meth:`_group` — the cross-request wave
        coalescing the serving engine is built on.  ``rids`` (parallel to
        ``roots``) tags every sense item / fused spec with the owning
        request ids for per-request trace attribution."""
        # iterative post-order: mixed-op expressions nest one level per op
        # switch, so deep graphs must not recurse.  Leaf children are NOT
        # pre-lowered — ops consume their leaves directly as pair senses;
        # only a Leaf root becomes a standalone read.
        memo: Dict[Node, int] = {}
        # Capture every placement write (realignment copyback, NOT-ready
        # program) the walk triggers: they land on the plan as barrier-wave
        # ProgramSteps for the slot-hazard checker.
        prev_log = getattr(self.device, "program_log", None)
        self.device.program_log = log = []
        try:
            for root in roots:
                if root in memo:
                    continue
                if isinstance(root, Leaf):
                    memo[root] = self._read_leaf(root.name)
                    continue
                stack = [root]
                while stack:
                    n = stack[-1]
                    if n in memo:
                        stack.pop()
                        continue
                    assert isinstance(n, Op), n
                    pending = [a for a in n.args
                               if not isinstance(a, Leaf) and a not in memo]
                    if pending:
                        stack.extend(pending)
                        continue
                    stack.pop()
                    memo[n] = self._lower_node(n, memo)
        finally:
            self.device.program_log = prev_log
        # a program's wordlines are a fresh list: walked, not profiled
        self.programs = [ProgramStep(label, list(wls), tuple(sorted(
            {self.device.die_of_plane(p) for p, _, _ in wls})))
                         for label, wls in log]
        return self._finish([memo[r] for r in roots], rids)

    def _finish(self, root_pids: List[int],
                rids: Optional[List[int]] = None) -> ExecPlan:
        self._fuse(root_pids)
        if rids is not None:
            self._attribute(root_pids, rids)
        groups = self._group()
        waves, concurrent = self._schedule(groups)
        fused_ops = sum(st.fused.n_operands for st in self.steps
                        if st.fused is not None)
        senses = sum(1 for it in self.items if it.is_mcflash) + fused_ops
        words_per_page = self.ftl.cfg.page_bits // 32
        pages = tuple(self.pages_of[p] for p in root_pids)
        return ExecPlan(groups=groups, steps=self.steps, waves=waves,
                        root=root_pids[0],
                        out_pages=pages[0],
                        out_words=pages[0] * words_per_page,
                        senses=senses, items=len(self.items) + fused_ops,
                        concurrent_dies=concurrent, programs=self.programs,
                        roots=tuple(root_pids) if len(root_pids) > 1 else (),
                        roots_pages=pages if len(root_pids) > 1 else (),
                        roots_words=tuple(p * words_per_page for p in pages)
                        if len(root_pids) > 1 else ())

    def _attribute(self, root_pids: List[int], rids: List[int]) -> None:
        """Post-fusion attribution pass: walk the producer graph back from
        each root and tag every reachable sense item / fused spec with the
        owning request id.  A shared (deduped) sub-DAG accumulates every
        request that reaches it — exactly the multi-rid tags the coalescing
        counters and trace spans report."""
        producer = {st.out: st for st in self.steps}
        by_pid = {it.pid: it for it in self.items}
        item_rids: Dict[int, set] = {}
        fused_rids: Dict[int, set] = {}
        for root, rid in zip(root_pids, rids):
            stack = [root]
            seen: set = set()
            while stack:
                pid = stack.pop()
                if pid in seen:
                    continue
                seen.add(pid)
                it = by_pid.get(pid)
                if it is not None:
                    item_rids.setdefault(pid, set()).add(rid)
                st = producer.get(pid)
                if st is not None:
                    if st.fused is not None:
                        fused_rids.setdefault(st.out, set()).add(rid)
                    # fused steps' args still name the consumed sense pids;
                    # those were pruned from self.items, so the walk simply
                    # finds no item for them — harmless
                    stack.extend(st.args)
        for pid, rs in item_rids.items():
            by_pid[pid].rids = tuple(sorted(rs))
        for st in self.steps:
            if st.fused is not None and st.out in fused_rids:
                st.fused.rids = tuple(sorted(fused_rids[st.out]))

    def _fuse(self, roots: List[int]) -> None:
        """Fold combines over single-use, same-plan senses into megakernels.

        Fused operands may live on *different* dies — the kernel call is one
        unit, but its pages sense in parallel across their dies (the spec
        records the spanned die set for scheduling/accounting).

        Every batch root counts as a use, so a sense shared across requests
        (use >= 2) never folds away into one request's megakernel.
        """
        use: Dict[int, int] = {}
        for root in roots:
            use[root] = use.get(root, 0) + 1
        for st in self.steps:
            for a in st.args:
                use[a] = use.get(a, 0) + 1
        by_pid = {it.pid: it for it in self.items}
        consumed: set = set()
        for st in self.steps:
            if st.op not in ASSOCIATIVE or len(st.args) < 2:
                continue
            its = [by_pid.get(a) for a in st.args]
            if any(it is None or not it.is_mcflash or use[it.pid] != 1
                   for it in its):
                continue
            # same plan required (dies may differ: cross-die fusion is fine)
            key = its[0].plan_key[:4]
            n_pages = len(its[0].wls)
            if any(it.plan_key[:4] != key or len(it.wls) != n_pages
                   for it in its):
                continue
            dies = tuple(sorted({d for it in its for d in it.dies}))
            st.fused = FusedSpec(plan=its[0].plan, op_label=its[0].op_label,
                                 wls=[wl for it in its for wl in it.wls],
                                 n_operands=len(its), n_pages=n_pages,
                                 dies=dies,
                                 pass_operands=min(len(its),
                                                   MAX_FUSED_OPERANDS),
                                 operands=tuple(it.wls for it in its))
            consumed.update(it.pid for it in its)
        if consumed:
            self.items = [it for it in self.items if it.pid not in consumed]

    def _group(self) -> List[SenseGroup]:
        groups: Dict[tuple, SenseGroup] = {}
        for it in self.items:
            g = groups.get(it.plan_key)
            if g is None:
                g = groups[it.plan_key] = SenseGroup(
                    it.plan, it.op_label, it.is_mcflash, it.which, it.dies, [])
            g.items.append(it)
        return list(groups.values())

    def _schedule(self, groups: List[SenseGroup]) -> Tuple[List[Wave], int]:
        """Greedy topological wave packing: a unit (per-die sense group or
        fused megakernel) lands in the earliest wave where every die it
        touches is free; combines attach to the wave their last input
        becomes ready in, so they overlap with later waves' senses."""
        waves: List[Wave] = []
        wave_dies: List[set] = []             # dies busy per wave
        die_free: Dict[int, int] = {}         # die -> first free wave index
        avail: Dict[int, int] = {}            # pid -> wave it is ready after

        def place(dies: Tuple[int, ...]) -> int:
            w = max((die_free.get(d, 0) for d in dies), default=0)
            while len(waves) <= w:
                waves.append(Wave())
                wave_dies.append(set())
            for d in dies:
                die_free[d] = w + 1
            wave_dies[w].update(dies)
            return w

        for gi, g in enumerate(groups):
            w = place(g.dies)
            waves[w].groups.append(gi)
            for it in g.items:
                avail[it.pid] = w
        for si, st in enumerate(self.steps):
            if st.fused is not None:
                w = place(st.fused.dies)
                waves[w].fused.append(si)
                avail[st.out] = w
            else:
                w = max((avail[a] for a in st.args), default=0)
                while len(waves) <= w:       # pure-combine plans (no senses)
                    waves.append(Wave())
                    wave_dies.append(set())
                waves[w].combines.append(si)
                avail[st.out] = w
        return waves, max((len(d) for d in wave_dies), default=0)


class WaveCost(NamedTuple):
    """What one schedule wave books in the ledger."""
    per_die: Dict[int, float]     # busy us per die
    per_ch: Dict[int, float]      # transfer us per channel
    uj: float                     # energy
    cmds: int                     # pages sensed
    parts: List[str]              # its units' labels, in order


@dataclasses.dataclass(frozen=True)
class SharedRows:
    """Sense items of a plan's unfused groups that read one page list on
    one stream: sensed by one ``sense_multi`` call that reads the list's
    rows once, at the earliest wave of its items' groups."""
    wave: int
    slot: Optional[int]
    #: the list's rows: rows ``start..stop-1`` of group ``group``'s rows
    group: int
    start: int
    stop: int
    #: the distinct read plans, each sensed once
    plans: Tuple[ReadPlan, ...]
    #: (pid, index into ``plans``) of every item it serves
    pids: Tuple[Tuple[int, int], ...]


class Executor:
    """Session-bound executor over the device-shared runner cache."""

    def __init__(self, session):
        self.session = session
        self.cache = session.device.executables
        #: runners this executor built on a runner-cache miss
        self.traces = 0

    # -- public entry points ---------------------------------------------------
    def run(self, node: Node, n_bits: int) -> torch.Tensor:
        """Execute a canonical DAG -> packed 1-D int32 words (tail masked)."""
        return self._execute_many([node], [n_bits], (False,))[0]

    def run_drained(self, node: Node, n_bits: int,
                    drain: ChunkedDrain) -> Optional[torch.Tensor]:
        """Execute a canonical DAG whose words go to the host -> None where
        its root, whose plan is one sense (:func:`_root_drains_in_chunks`),
        was sensed into ``drain`` in chunks of ``DRAIN_CHUNK_PAGES`` pages,
        each chunk's copy starting as soon as the chunk is sensed, so it
        overlaps the next chunk's sense; else the words, as :meth:`run`
        gives them."""
        return self._execute_many([node], [n_bits], (False,), drain=drain)[0]

    def run_popcount(self, node: Node, n_bits: int) -> torch.Tensor:
        """Execute a canonical DAG -> 0-d int32 popcount (fused into the root
        kernel when the plan allows)."""
        return self._execute_many([node], [n_bits], (True,))[0]

    def run_batch(self, nodes: List[Node], n_bits_list: List[int],
                  popcounts: Tuple[bool, ...],
                  rids: Optional[List[int]] = None) -> List[torch.Tensor]:
        """Execute a batch of canonical DAGs through ONE shared lowering
        (same-(ReadPlan, die) senses of different DAGs share kernel calls).
        Returns one packed word tensor (or 0-d count) per DAG, in order."""
        if not len(nodes) == len(n_bits_list) == len(popcounts):
            raise ValueError((len(nodes), len(n_bits_list), len(popcounts)))
        if rids is not None and len(rids) != len(nodes):
            raise ValueError("one rid per node")
        return list(self._execute_many(nodes, n_bits_list, tuple(popcounts),
                                       rids))

    def stats(self) -> dict:
        return {**self.cache.stats(), "traces": self.traces}

    def lower(self, node: Node) -> ExecPlan:
        """Lower a canonical DAG to its static plan without dispatching;
        the plan still passes through the session's verifier."""
        return self.lower_many([node])

    def lower_many(self, nodes: List[Node],
                   rids: Optional[List[int]] = None) -> ExecPlan:
        """Batch variant of :meth:`lower`: one shared-memo lowering pass
        over every DAG, verified like any dispatched plan."""
        plan = _Lowering(self.session).lower_many(nodes, rids)
        self.session.verify_lowered_plan(
            plan, plan.signature(self.session.backend.name))
        return plan

    def _placement_layout(self, plan: ExecPlan) -> Optional[tuple]:
        """Placement layout of a plan on this session's device, or ``None``
        when the arena's shards are unmapped.  Per sense group and per fused
        step, ``(device, stream slot)``: a single-die unit runs on its
        shard's entry, a cross-die unit on the compute device's stream
        (slot ``None``).  The layout ends the runner-cache key: a placed
        runner bakes in which stream each unit runs on, so it must never
        serve unplaced inputs, or dies mapped onto other slots."""
        arena = self.session.device.arena
        if not arena.devices:
            return None

        def unit(dies: Tuple[int, ...]) -> tuple:
            if len(dies) == 1:
                return str(arena.device_of(dies[0])), arena.slot_of(dies[0])
            return str(arena.compute_device()), None

        return (tuple(unit(g.dies) for g in plan.groups),
                tuple(unit(st.fused.dies) for st in plan.steps
                      if st.fused is not None),
                str(arena.compute_device()))

    # -- internals ---------------------------------------------------------------
    def _execute_many(self, nodes: List[Node], n_bits_list: List[int],
                      popcounts: Tuple[bool, ...],
                      rids: Optional[List[int]] = None,
                      drain: Optional[ChunkedDrain] = None):
        """Lower, verify, account and dispatch: one output per root, None
        for a root sensed into ``drain`` (:func:`_root_drains_in_chunks`)."""
        sess = self.session
        tracer = sess.trace
        dev = sess.device
        # lowering looks up each item's placement profile first, accounting
        # reads them again: both count towards this plan's builds
        builds = dev.placement_profile_builds
        reuses = dev.placement_profile_reuses
        # lowering (placement resolution) runs on the host wall clock; the
        # FTL's realignment copybacks inside it also land as device spans
        with traced(tracer, "lower", "lower", roots=len(nodes)) as span:
            if span is not None and rids is not None:
                span.args["rids"] = list(rids)
            plan = _Lowering(sess).lower_many(nodes, rids)
        # static verification runs at lowering time, before any accounting
        # or dispatch; memoized per signature so cache-hit plans pay ~nothing
        sig = plan.signature(sess.backend.name)
        with traced(tracer, "verify", "verify-plan") as span:
            hits = sess.verifier.cache_hits
            sess.verify_lowered_plan(plan, sig)
            if span is not None:
                span.args["cached"] = sess.verifier.cache_hits > hits
        layout = self._placement_layout(plan)
        counted = _root_counts_in_sense(plan, popcounts)
        sess.metrics.counter("sense_counted_roots").add(int(counted))
        chunked = drain is not None and _root_drains_in_chunks(plan, popcounts)
        with traced(tracer, "account", "account-waves") as span:
            if span is not None:
                span.args["waves"] = len(plan.waves)
            self._account(plan, placed=layout is not None,
                          attributed=rids is not None)
            built = dev.placement_profile_builds - builds
            sess.metrics.counter("placement_profile_builds").add(built)
            sess.metrics.counter("placement_profile_reuses").add(
                dev.placement_profile_reuses - reuses)
            if span is not None:
                span.args["profiles_built"] = built
            if sess.verifier.enabled and dev.ledger.mode != "independent":
                # transfers may overlap only LATER waves' work in the step log
                check_overlap_consistency(dev.ledger, plan=plan)
        # rids are not keyed: isomorphic batches replay one runner.  Which
        # items share rows is keyed: the signature keeps only each page
        # list's length, so plans of one signature may share differently
        sharing = self.row_sharing(plan, layout)
        key = (sig, popcounts, sharing, layout)
        if tracer is not None:
            evictions0 = self.cache.evictions

        def build():
            self.traces += 1
            with traced(tracer, "compile", "build-executable",
                        waves=len(plan.waves)):
                return self._build(plan, popcounts, layout, sharing)

        fn = self.cache.get(key, build)
        if tracer is not None and self.cache.evictions > evictions0:
            tracer.instant("cache", "executable-evicted",
                           evicted=self.cache.evictions - evictions0)
        shared = fn.shared_row_plans
        with traced(tracer, "dispatch", "dispatch-waves",
                    waves=len(plan.waves)) as span:
            if span is not None and rids is not None:
                span.args["rids"] = list(rids)
            # the runner's inputs: per unit, the arena rows it senses in
            # place (shard buffers read now, slot tables cached per page
            # list), made outside the cached runner
            with traced(tracer, "gather", "vth-gather") as span:
                builds, reuses = dev.slot_table_builds, dev.slot_table_reuses
                group_rows, fused_rows = self.unit_rows(plan, layout)
                built = dev.slot_table_builds - builds
                sess.metrics.counter("slot_table_builds").add(built)
                sess.metrics.counter("slot_table_reuses").add(
                    dev.slot_table_reuses - reuses)
                if span is not None:
                    span.args["wordlines"] = sum(
                        r.n_rows for r in group_rows + fused_rows)
                    span.args["tables_built"] = built
            masks = tuple(sess.tail_mask(nb, w) for nb, w
                          in zip(n_bits_list, plan.all_root_words))
            with traced(tracer, "launch", "run-waves") as span:
                if span is not None:
                    plans = _unit_plans(plan)
                    span.args["encoding"] = "+".join(
                        dict.fromkeys(_encoding_of(p) for p in plans))
                    span.args["refs"] = [len(p.refs) for p in plans]
                    span.args["counted"] = counted
                    if shared:
                        span.args["plans"] = list(shared)
                outs = fn(group_rows, fused_rows, masks, tuple(n_bits_list),
                          drain if chunked else None)
                if chunked and span is not None:
                    span.args["chunks"] = drain.chunks
        sess.metrics.counter("shared_row_senses").add(len(shared))
        sess.metrics.counter("shared_row_items").add(fn.shared_row_items)
        if chunked:
            sess.metrics.counter("pipelined_drains").add(1)
            sess.metrics.counter("drain_chunks").add(drain.chunks)
        return outs

    def unit_rows(self, plan: ExecPlan, layout: Optional[tuple]
                   ) -> Tuple[Tuple[Rows, ...], Tuple[Rows, ...]]:
        """Per sense group and per fused step, the rows it senses: its page
        lists' slot tables over their shards' buffers (a group's items in
        order; one table per fused operand).  Unplaced, and for a cross-die
        placed unit, the compute device reads them (gathered there only
        where a shard lives on another card); a single-die placed unit
        reads them in place on its shard's device, handed to its stream.

        Every dispatch of a plan, the cached runner's and the recovery
        ladder's shifted re-run alike, takes its rows here, so the units
        sensed under a multi-level encoding and their sensing phases are
        counted here."""
        encoded = [p for p in _unit_plans(plan) if _encoding_of(p) != _tlc.MLC]
        m = self.session.metrics
        m.counter("encoded_sense_units").add(len(encoded))
        m.counter("sensing_phases").add(sum(p.sensing_phases for p in encoded))
        dev = self.session.device
        fused = [st.fused for st in plan.steps if st.fused is not None]
        units = ([[it.wls for it in g.items] for g in plan.groups]
                 + [f.operands for f in fused])
        slots = ([None] * len(units) if layout is None
                 else [slot for _, slot in layout[0] + layout[1]])
        out = []
        for lists, slot in zip(units, slots):
            rows = Rows.cat([dev.vth_rows(wls, place=slot is None)
                             for wls in lists])
            dev.arena.lend(slot, rows.bufs + rows.slots)
            out.append(rows)
        n = len(plan.groups)
        for f, rows in zip(fused, out[n:]):
            if len(rows) != f.n_operands:
                raise ValueError(f"a fused operand's pages span dies: "
                                 f"{len(rows)} tables for {f.n_operands} "
                                 "operands")
        return tuple(out[:n]), tuple(out[n:])

    def wave_costs(self, plan: ExecPlan, wave: Wave) -> WaveCost:
        """What one schedule wave books: its units' die time, transfers,
        energy and pages, and their labels.  Each unit is costed from its
        stored page lists' placement profiles (O(units), no wordline
        walked), sense groups then fused steps; per unit its die costs,
        then its transfers.  The primary accounting and the recovery
        ladder's shifted re-run both book from here: a shifted plan senses
        in as many phases, so it costs the same."""
        dev = self.session.device
        units: List[Tuple[Dict[int, float], float, list, int]] = []
        parts: List[str] = []
        for gi in wave.groups:
            g = plan.groups[gi]
            # the plan's own phase count drives timing/energy — encoded
            # (TLC / reduced-MLC) op labels are not in the Table-1 maps
            lists = g.page_lists
            cost = (dev.mcflash_cost(lists, g.op_label,
                                     phases=g.plan.sensing_phases)
                    if g.is_mcflash
                    else dev.page_read_cost(lists, g.which,
                                            phases=g.plan.sensing_phases))
            n_pages = sum(len(wls) for wls in lists)
            units.append((*cost, lists, n_pages))
            parts.append(f"{g.op_label}x{n_pages}p")
        for si in wave.fused:
            f = plan.steps[si].fused
            units.append((*dev.mcflash_cost(
                f.operands, f.op_label, phases=f.plan.sensing_phases),
                f.operands, f.n_operands * f.n_pages))
            parts.append(f"fused:{f.op_label}x{f.n_operands}")
        per_die: Dict[int, float] = {}
        per_ch: Dict[int, float] = {}
        uj = 0.0
        cmds = 0
        for unit_die, unit_uj, lists, n_pages in units:
            for die, us in unit_die.items():
                per_die[die] = per_die.get(die, 0.0) + us
            for ch, us in dev.dma_cost(lists).items():
                per_ch[ch] = per_ch.get(ch, 0.0) + us
            uj += unit_uj
            cmds += n_pages
        return WaveCost(per_die, per_ch, uj, cmds, parts)

    def _account(self, plan: ExecPlan, placed: bool = False,
                 attributed: bool = False) -> None:
        """Wave-batched ledger + counter updates: ONE parallel die step and
        one channel step per schedule wave (concurrent per-die groups in a
        wave overlap in the ledger's die-parallel makespan), each labeled
        with its wave composition and booked from :meth:`wave_costs`."""
        sess = self.session
        dev = sess.device
        tracer = sess.trace
        # group wave tags: wave indices restart per plan, so the step log
        # compares them only within one epoch
        dev.ledger.begin_epoch()
        n_fused = n_chunks = 0
        n_coalesced = n_shared_waves = 0
        for wi, wave in enumerate(plan.waves):
            cost = self.wave_costs(plan, wave)
            wave_rids: set = set()
            for gi in wave.groups:
                g_rids = plan.groups[gi].rids
                wave_rids.update(g_rids)
                if len(g_rids) > 1:
                    n_coalesced += 1
            for si in wave.fused:
                f = plan.steps[si].fused
                wave_rids.update(f.rids)
                n_fused += 1
                n_chunks += _fused_chunks(f.n_operands)
                sess.metrics.histogram("fused_operands").observe(f.n_operands)
                if tracer is not None and f.n_operands > MAX_FUSED_OPERANDS:
                    tracer.instant("dispatch", "tiled-megakernel-split",
                                   operands=f.n_operands,
                                   passes=_fused_chunks(f.n_operands))
            label = (f"wave {wi}: {'+'.join(cost.parts)}" if cost.parts
                     else None)
            rid_tag = tuple(sorted(wave_rids)) or None
            if len(wave_rids) > 1:
                n_shared_waves += 1
            if cost.per_die:
                dev.ledger.add_die_batch(cost.per_die, cost.uj,
                                         commands=cost.cmds, label=label,
                                         wave=wi, rids=rid_tag)
                sess.metrics.histogram("wave_dies").observe(len(cost.per_die))
            if cost.per_ch:
                dev.ledger.add_channel_batch(
                    cost.per_ch,
                    label=f"wave {wi}: dma" if cost.parts else None,
                    wave=wi, rids=rid_tag)
        m = sess.metrics
        if attributed:
            m.counter("coalesced_sense_groups").add(n_coalesced)
            m.counter("waves_shared").add(n_shared_waves)
        if placed:
            m.counter("placed_unit_dispatches").add(len(plan.groups) + n_fused)
        m.counter("in_flash_senses").add(plan.senses)
        m.counter("sense_items").add(plan.items)
        m.counter("sense_batches").add(len(plan.groups) + n_fused)
        m.counter("sense_waves").add(len(plan.waves))
        m.gauge("max_concurrent_dies").set_max(plan.concurrent_dies)
        m.counter("megakernel_calls").add(n_chunks)
        m.counter("tiled_megakernel_splits").add(sum(
            1 for st in plan.steps if st.fused is not None
            and st.fused.n_operands > MAX_FUSED_OPERANDS))
        m.counter("fused_reduce_calls").add(sum(
            1 for st in plan.steps if len(st.args) > 1 or st.invert
            or st.fused is not None))

    def row_sharing(self, plan: ExecPlan, layout: Optional[tuple]) -> tuple:
        """Where items of the plan's unfused sense groups read one page list
        on one stream more than once (:func:`_row_sharing`): part of the
        runner-cache key, and what :meth:`_build` shares."""
        return _row_sharing(plan, _group_slots(plan, layout),
                            self.session.backend.multi_kinds)

    def _build(self, plan: ExecPlan, popcounts: Tuple[bool, ...],
               layout: Optional[tuple], sharing: tuple):
        """Close an eager wave runner over the static plan.  Runtime
        inputs: per sense group and per fused step the :class:`Rows` it
        senses in place (:meth:`unit_rows`: shard buffers and slot tables,
        one table per fused operand), one packed padding mask and the bit
        count per batch root, and ``drain`` (a
        :class:`~repro_torch.api.hostio.ChunkedDrain`) where the root drains
        in chunks (:func:`_root_drains_in_chunks`).  Returns a tuple of
        outputs, one per root; with ``drain``, ``(None,)``.  A
        runner-cache miss builds it, and counts the one trace; the recovery
        ladder builds one uncached over a plan with shifted read plans and
        counts none.

        Placed (``layout`` from :meth:`_placement_layout`), each single-die
        sense group and fused step is issued on its shard's stream, which
        reads its rows in place, and the next unit is issued without
        waiting, so die-disjoint units of a wave may overlap on the card; a
        cross-die unit runs on the compute stream.  After a wave's units,
        one event per stream marks them; partials reach the compute stream
        only where a controller combine or a root consumes them: the
        compute stream waits for their stream's event, and the partial is
        marked as used there.  The single-root fused popcount keeps its
        fast path on the shard's stream, and so does a counted root whose
        plan is one sense (:func:`_root_counts_in_sense`): one
        ``sense_popcount`` over its group's rows, which counts the root's
        first ``n_bits`` cells and needs no mask.  So does a drained root
        whose plan is one sense: one ``sense_drain`` over its group's rows
        senses them ``DRAIN_CHUNK_PAGES`` pages at a time into the drain's
        host buffer, each chunk's copy on the drain's copy stream after the
        chunk, and only a chunk that holds bits past ``n_bits`` is ANDed with
        the mask.  Unplaced (``layout``
        None), every unit's slot is None, and the arena's placement methods
        do nothing: everything runs on the current stream.

        For each bucket of ``sharing`` (:meth:`row_sharing`: items of its
        groups that read one page list on one stream), one ``sense_multi``
        call over the list's rows, taken from a member's rows, senses each
        of their distinct read plans once, at the earliest wave of their
        groups and on their stream (:func:`_shared_rows`); the items'
        partials take that wave's event, and a group launches only for the
        items it keeps.  The runner carries what that decided:
        ``shared_row_plans`` (the plans of each such call) and
        ``shared_row_items`` (the items they serve).

        The closure captures the backend, the static plan and the arena's
        bound placement methods, never the executor/session (the runner
        cache is device-shared and must not pin dead sessions)."""
        backend = self.session.backend
        arena = self.session.device.arena
        on_slot, ready = arena.on_slot, arena.ready
        to_compute, colocate = arena.to_compute, arena.colocate
        roots = plan.all_roots
        fuse_pc = _root_fuses_popcount(plan, popcounts)
        counted = _root_counts_in_sense(plan, popcounts)
        fused_pos = _fused_positions(plan)
        group_slot = _group_slots(plan, layout)
        fused_slot = (dict.fromkeys(fused_pos) if layout is None else
                      dict(zip(fused_pos, (slot for _, slot in layout[1]))))
        shared, kept = _shared_rows(plan, group_slot, sharing)
        shared_at: List[List[SharedRows]] = [[] for _ in plan.waves]
        for unit in shared:
            shared_at[unit.wave].append(unit)

        def run(group_rows, fused_rows, masks, n_bits, drain=None):
            if drain is not None:
                slot = group_slot[0]
                rows = group_rows[0]
                # the first page holding padding (out_pages when none does)
                tail = n_bits[0] // (plan.out_words // plan.out_pages * 32)
                mask = (colocate(masks[0], slot) if tail < plan.out_pages
                        else None)
                host, copy_stream = drain.target(plan.out_words, rows.device)
                with on_slot(slot):
                    drain.chunks = backend.sense_drain(
                        rows, plan.groups[0].plan, host, DRAIN_CHUNK_PAGES,
                        copy_stream, mask, tail)
                return (None,)
            if counted:
                slot = group_slot[0]
                with on_slot(slot):
                    total = backend.sense_popcount(group_rows[0],
                                                   plan.groups[0].plan,
                                                   n_bits[0])
                    done = ready(slot)
                return (to_compute(total, done),)
            partials: Dict[int, torch.Tensor] = {}
            events: Dict[int, object] = {}    # pid -> event after its producer
            for wi, wave in enumerate(plan.waves):
                made: Dict[Optional[int], List[int]] = {}  # slot -> its pids
                for unit in shared_at[wi]:
                    with on_slot(unit.slot):
                        planes = backend.sense_multi(
                            group_rows[unit.group].take(unit.start, unit.stop),
                            unit.plans)
                    for pid, k in unit.pids:
                        partials[pid] = planes[k].reshape(-1)
                        made.setdefault(unit.slot, []).append(pid)
                for gi in wave.groups:
                    g = plan.groups[gi]
                    slot = group_slot[gi]
                    rows, spans = group_rows[gi], g.spans()
                    if kept[gi] is not None:
                        if not kept[gi]:
                            continue
                        rows = Rows.cat([rows.take(*src)
                                         for _, src, _ in kept[gi]])
                        spans = [(pid, dst) for pid, _, dst in kept[gi]]
                    with on_slot(slot):
                        packed = backend.sense(rows, g.plan)
                    for pid, (s, e) in spans:
                        partials[pid] = packed[s:e].reshape(-1)
                        made.setdefault(slot, []).append(pid)
                for si in wave.fused:
                    st = plan.steps[si]
                    f = st.fused
                    slot = fused_slot[si]
                    vth = fused_rows[fused_pos[si]]
                    if fuse_pc and st.out == plan.root:
                        mask = colocate(masks[0], slot)
                        with on_slot(slot):
                            mask2 = mask.reshape(f.n_pages, -1)
                            if f.n_operands <= MAX_FUSED_OPERANDS:
                                counts = backend.sense_reduce_popcount(
                                    vth, f.plan, mask2, op=st.op,
                                    invert=st.invert)
                            else:
                                counts = backend.popcount(_fused_reduce(
                                    backend, st, vth).reshape(f.n_pages, -1),
                                    mask2)
                            total = counts.sum(dtype=torch.int32)
                            done = ready(slot)
                        return (to_compute(total, done),)
                    with on_slot(slot):
                        partials[st.out] = _fused_reduce(
                            backend, st, vth).reshape(-1)
                    made.setdefault(slot, []).append(st.out)
                for slot, pids in made.items():
                    done = ready(slot)       # one event per stream and wave
                    for pid in pids:
                        events[pid] = done
                for ci in wave.combines:
                    st = plan.steps[ci]
                    if len(st.args) == 1 and not st.invert:
                        partials[st.out] = partials[st.args[0]]
                        events[st.out] = events[st.args[0]]
                    else:
                        # controller combine on the compute stream, after
                        # the shard streams that made its operands
                        partials[st.out] = backend.reduce(
                            [to_compute(partials[a], events[a])
                             for a in st.args], st.op, invert=st.invert)
                        events[st.out] = None
            outs = []
            for root, pc, mask in zip(roots, popcounts, masks):
                out = to_compute(partials[root], events[root])
                outs.append(backend.popcount(out.reshape(1, -1),
                                             mask.reshape(1, -1))[0]
                            if pc else out & mask)
            return tuple(outs)

        run.shared_row_plans = tuple(len(u.plans) for u in shared)
        run.shared_row_items = sum(len(u.pids) for u in shared)
        return run


def _unit_plans(plan: ExecPlan) -> List[ReadPlan]:
    """The read plan of each sense group, then of each fused step."""
    return [g.plan for g in plan.groups] + [
        st.fused.plan for st in plan.steps if st.fused is not None]


def _encoding_of(plan: ReadPlan) -> str:
    """The row encoding a read plan senses: encoded plans are parity reads
    whose op label starts with their encoding (``tlc:and:csb+lsb+msb``)."""
    return plan.op.partition(":")[0] if plan.kind == "parity" else _tlc.MLC


def _root_fuses_popcount(plan: ExecPlan, popcounts: Tuple[bool, ...]) -> bool:
    """Whether the popcount folds into the root kernel: only on a
    single-root plan whose root IS the last step and that step fused (a
    fused root consumes raw wordlines, so nothing else in the plan feeds
    it)."""
    return (len(plan.all_roots) == 1 and popcounts[0] and bool(plan.steps)
            and plan.steps[-1].out == plan.root
            and plan.steps[-1].fused is not None)


def _root_is_one_sense(plan: ExecPlan) -> bool:
    """Whether the plan is a single root with no combine step and one sense
    group of one item, that item being the root."""
    return (len(plan.all_roots) == 1 and not plan.steps
            and len(plan.groups) == 1 and len(plan.groups[0].items) == 1
            and plan.groups[0].items[0].pid == plan.root)


def _root_counts_in_sense(plan: ExecPlan,
                          popcounts: Tuple[bool, ...]) -> bool:
    """Whether the root is sensed and counted in one ``sense_popcount``:
    only on a counted plan whose root is one sense."""
    return popcounts[0] and _root_is_one_sense(plan)


def _root_drains_in_chunks(plan: ExecPlan,
                           popcounts: Tuple[bool, ...]) -> bool:
    """Whether a drained root is sensed in chunks, each copied to the host
    as it is made: only on an uncounted plan whose root is one sense."""
    return not popcounts[0] and _root_is_one_sense(plan)


def _group_slots(plan: ExecPlan, layout: Optional[tuple]
                 ) -> List[Optional[int]]:
    """Each sense group's stream slot (None unplaced)."""
    if layout is None:
        return [None] * len(plan.groups)
    return [slot for _, slot in layout[0]]


def _row_sharing(plan: ExecPlan, group_slot: List[Optional[int]],
                 kinds: Tuple[str, ...]) -> tuple:
    """The items of the plan's unfused sense groups whose group plan is of
    ``kinds``, bucketed by (stream slot, page list), lists compared by
    value: each bucket of two or more items (two plans, or one plan twice)
    as its ``(group, item)`` indices, in first-appearance order.  Each
    list object is compared once a call, and only with the distinct lists
    before it (hashing a list's pages would cost as much every call); the
    FTL never changes a page list in place."""
    index: Dict[int, int] = {}           # id(list) -> the first equal list
    lists: List[List[WordlineKey]] = []
    buckets: Dict[tuple, list] = {}
    for gi, g in enumerate(plan.groups):
        if g.plan.kind not in kinds:
            continue
        for k, it in enumerate(g.items):
            i = index.get(id(it.wls))
            if i is None:
                i = next((j for j, wls in enumerate(lists) if wls == it.wls),
                         len(lists))
                if i == len(lists):
                    lists.append(it.wls)
                index[id(it.wls)] = i
            buckets.setdefault((group_slot[gi], i), []).append((gi, k))
    return tuple(tuple(m) for m in buckets.values() if len(m) > 1)


def _shared_rows(plan: ExecPlan, group_slot: List[Optional[int]],
                 sharing: tuple
                 ) -> Tuple[List[SharedRows], List[Optional[tuple]]]:
    """The :class:`SharedRows` unit of each bucket of ``sharing``
    (:func:`_row_sharing`), and per group None where it launches as
    lowered, else ``(pid, its rows in the group's rows, its rows in what
    the group still senses)`` of each item it keeps (none: it does not
    launch)."""
    wave_of = {gi: wi for wi, w in enumerate(plan.waves) for gi in w.groups}
    spans = [g.spans() for g in plan.groups]
    units: List[SharedRows] = []
    taken: set = set()
    for members in sharing:
        index: Dict[ReadPlan, int] = {}
        pids = tuple((spans[gi][k][0],
                      index.setdefault(plan.groups[gi].plan, len(index)))
                     for gi, k in members)
        gi0, k0 = members[0]
        start, stop = spans[gi0][k0][1]
        units.append(SharedRows(min(wave_of[gi] for gi, _ in members),
                                group_slot[gi0], gi0, start, stop,
                                tuple(index), pids))
        taken.update(pid for pid, _ in pids)
    kept: List[Optional[tuple]] = []
    for group_spans in spans:
        if not any(pid in taken for pid, _ in group_spans):
            kept.append(None)
            continue
        keep, row = [], 0
        for pid, (s, e) in group_spans:
            if pid not in taken:
                keep.append((pid, (s, e), (row, row + e - s)))
                row += e - s
        kept.append(tuple(keep))
    return units, kept


def _fused_positions(plan: ExecPlan) -> Dict[int, int]:
    """Step index -> position among the plan's fused steps."""
    return {si: k for k, si in enumerate(
        si for si, st in enumerate(plan.steps) if st.fused is not None)}


def _fused_chunks(n_operands: int) -> int:
    """Passes a fused spec needs at ``MAX_FUSED_OPERANDS`` per pass."""
    return -(-n_operands // MAX_FUSED_OPERANDS)


def _fused_reduce(backend, st: CombineStep, vth: Rows) -> torch.Tensor:
    """Fused sense->reduce, split into passes of ``MAX_FUSED_OPERANDS``
    operands when the chain has more (``vth[s:e]`` takes operands
    ``s..e-1``)."""
    f = st.fused
    n = MAX_FUSED_OPERANDS
    if f.n_operands <= n:
        return backend.sense_reduce(vth, f.plan, op=st.op, invert=st.invert)
    parts = [backend.sense_reduce(vth[s:s + n], f.plan, op=st.op,
                                  invert=False)
             for s in range(0, f.n_operands, n)]
    return backend.reduce(parts, st.op, invert=st.invert)
