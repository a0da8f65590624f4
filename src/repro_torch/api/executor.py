"""Compiled DAG executor: topology-aware schedule + cached runners.

The executor lowers a canonical (:func:`repro_torch.api.graph.simplify`-ed)
DAG into a static :class:`ExecPlan`, exactly as the JAX package does:

1. **Lowering** walks the DAG once, resolving placement (aligning scattered
   pairs, building NOT-ready copies) and emitting sense items plus a
   combine schedule.
2. **Fusion** rewrites any combine whose inputs are single-use, same-plan
   senses into one fused ``sense_reduce`` kernel call (with a popcount
   root, only the counts leave the kernel).  Chains longer than
   ``max_fused_operands`` split into several passes.
3. **Grouping** buckets every remaining sense by (:class:`ReadPlan`, die),
   so all same-plan senses on one die run in ONE batched kernel call.
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
executor records lowering, runner build and dispatch as wall-clock spans
and runner-cache hits, misses and evictions as instants.

Ledger accounting is wave-batched: each schedule wave books one parallel
``add_die_batch`` step plus one ``add_channel_batch`` for its transfers.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.api.graph import ASSOCIATIVE, BASE_OF, Leaf, Node, Op
from repro_torch.core import tlc as _tlc
from repro_torch.core.mcflash import ReadPlan
from repro_torch.flash.device import PAGE_READ_OP
from repro_torch.obs.trace import traced
from repro_torch.verify.invariants import check_overlap_consistency

__all__ = ["ExecPlan", "Executor", "ProgramStep", "Wave",
           "MAX_FUSED_OPERANDS", "schedule_programs_into_idle_waves"]

WordlineKey = Tuple[int, int, int]

#: most operands one fused pass takes: 32, what the JAX package's default
#: VMEM budget allows, so both packages split long chains alike.  The CUDA
#: kernel keeps one word per operand in registers and no operand tile in
#: shared memory, so on the card this shapes plans only.
MAX_FUSED_OPERANDS = 32


@dataclasses.dataclass
class SenseItem:
    """One logical sense/read: all pages of one stored vector."""
    pid: int                      # partial id its packed result binds to
    name: str                     # vector whose pages are sensed
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
    call gathering ONE arena shard."""
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

    def signature(self, backend_name: str) -> tuple:
        """Hashable shape of the plan: everything the executable closes over
        (structure, plans, page counts, die *topology*, wave layout) minus
        the runtime inputs (arena shard gathers, mask) — the
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
        return tuple(sorted({self.device.die_of_plane(p) for p, _, _ in wls}))

    def _item(self, name: str, wls: List[WordlineKey], plan: ReadPlan,
              op_label: str, is_mcflash: bool, which: str | None = None) -> int:
        pid = self._pid(len(wls))
        self.items.append(SenseItem(pid, name, list(wls), plan, op_label,
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
        self.programs = [ProgramStep(label, list(wls), self._dies_of(wls))
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
                                 pass_operands=min(
                                     len(its),
                                     self.session.executor.max_fused_operands))
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


class _TraceCounter:
    """Tiny mutable cell the cached runners capture INSTEAD of the executor:
    the runner cache outlives sessions (it is device-shared), so cached
    closures must not pin a dead session's executor/session graph."""

    __slots__ = ("n",)

    def __init__(self) -> None:
        self.n = 0


class Executor:
    """Session-bound executor over the device-shared runner cache."""

    def __init__(self, session):
        self.session = session
        self.cache = session.device.executables
        #: most operands one fused pass may take
        self.max_fused_operands = MAX_FUSED_OPERANDS
        self._traces = _TraceCounter()

    @property
    def traces(self) -> int:
        """Runner builds across all plans this executor built."""
        return self._traces.n

    # -- public entry points ---------------------------------------------------
    def run(self, node: Node, n_bits: int) -> torch.Tensor:
        """Execute a canonical DAG -> packed 1-D int32 words (tail masked)."""
        return self._execute_many([node], [n_bits], (False,))[0]

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

    def _fused_chunks(self, n_operands: int) -> int:
        """Passes a fused spec needs at ``max_fused_operands`` per pass."""
        return -(-n_operands // self.max_fused_operands)

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
                      rids: Optional[List[int]] = None):
        sess = self.session
        tracer = sess.trace
        # lowering (placement resolution) runs on the host wall clock; the
        # FTL's realignment copybacks inside it also land as device spans
        with traced(tracer, "lower", "lower", roots=len(nodes)):
            plan = _Lowering(sess).lower_many(nodes, rids)
        # static verification runs at lowering time, before any accounting
        # or dispatch; memoized per signature so cache-hit plans pay ~nothing
        sig = plan.signature(sess.backend.name)
        sess.verify_lowered_plan(plan, sig)
        layout = self._placement_layout(plan)
        self._account(plan, placed=layout is not None,
                      attributed=rids is not None)
        if sess.verifier.enabled and sess.device.ledger.mode != "independent":
            # transfers may overlap only LATER waves' work in the step log
            check_overlap_consistency(sess.device.ledger, plan=plan)
        # rids are not keyed: isomorphic batches replay one runner
        key = (self.max_fused_operands, sig, popcounts, layout)
        if tracer is not None:
            tracer.instant("cache", "executable-hit" if key in self.cache
                           else "executable-miss",
                           waves=len(plan.waves), groups=len(plan.groups))
            evictions0 = self.cache.evictions

        def build():
            with traced(tracer, "compile", "build-executable",
                        waves=len(plan.waves)):
                return self._build(plan, popcounts, layout)

        fn = self.cache.get(key, build)
        if tracer is not None and self.cache.evictions > evictions0:
            tracer.instant("cache", "executable-evicted",
                           evicted=self.cache.evictions - evictions0)
        dev = sess.device
        # the shard gathers run outside the cached runner, one per die shard;
        # placed, a die-local gather stays on its shard's stream
        place = layout is None
        with traced(tracer, "dispatch", "dispatch-waves",
                    waves=len(plan.waves)):
            group_vth = tuple(dev.vth_stack(g.wls, place=place)
                              for g in plan.groups)
            fused_vth = tuple(dev.vth_stack(st.fused.wls, place=place)
                              for st in plan.steps if st.fused is not None)
            masks = tuple(sess.tail_mask(nb, w) for nb, w
                          in zip(n_bits_list, plan.all_root_words))
            return fn(group_vth, fused_vth, masks)

    def _account(self, plan: ExecPlan, placed: bool = False,
                 attributed: bool = False) -> None:
        """Wave-batched ledger + counter updates: ONE parallel die step and
        one channel step per schedule wave (concurrent per-die groups in a
        wave overlap in the ledger's die-parallel makespan), each labeled
        with its wave composition."""
        sess = self.session
        dev = sess.device
        tracer = sess.trace
        # group wave tags: wave indices restart per plan, so the step log
        # compares them only within one epoch
        dev.ledger.begin_epoch()
        n_fused = n_chunks = 0
        n_coalesced = n_shared_waves = 0
        for wi, wave in enumerate(plan.waves):
            per_die: Dict[int, float] = {}
            per_ch: Dict[int, float] = {}
            uj = 0.0
            cmds = 0
            units: List[Tuple[Dict[int, float], float, List]] = []
            parts: List[str] = []
            wave_rids: set = set()
            for gi in wave.groups:
                g = plan.groups[gi]
                g_rids = g.rids
                wave_rids.update(g_rids)
                if len(g_rids) > 1:
                    n_coalesced += 1
                # the plan's own phase count drives timing/energy — encoded
                # (TLC / reduced-MLC) op labels are not in the Table-1 maps
                cost = (dev.mcflash_cost(g.wls, g.op_label,
                                         phases=g.plan.sensing_phases)
                        if g.is_mcflash
                        else dev.page_read_cost(g.wls, g.which,
                                                phases=g.plan.sensing_phases))
                units.append((*cost, g.wls))
                parts.append(f"{g.op_label}x{len(g.wls)}p")
            for si in wave.fused:
                f = plan.steps[si].fused
                wave_rids.update(f.rids)
                units.append((*dev.mcflash_cost(
                    f.wls, f.op_label, phases=f.plan.sensing_phases), f.wls))
                parts.append(f"fused:{f.op_label}x{f.n_operands}")
                n_fused += 1
                n_chunks += self._fused_chunks(f.n_operands)
                sess.metrics.histogram("fused_operands").observe(f.n_operands)
                if (tracer is not None
                        and f.n_operands > self.max_fused_operands):
                    tracer.instant("dispatch", "tiled-megakernel-split",
                                   operands=f.n_operands,
                                   passes=self._fused_chunks(f.n_operands))
            for unit_die, unit_uj, wls in units:
                for die, us in unit_die.items():
                    per_die[die] = per_die.get(die, 0.0) + us
                for ch, us in dev.dma_cost(wls).items():
                    per_ch[ch] = per_ch.get(ch, 0.0) + us
                uj += unit_uj
                cmds += len(wls)
            label = f"wave {wi}: {'+'.join(parts)}" if parts else None
            rid_tag = tuple(sorted(wave_rids)) or None
            if len(wave_rids) > 1:
                n_shared_waves += 1
            if per_die:
                dev.ledger.add_die_batch(per_die, uj, commands=cmds,
                                         label=label, wave=wi, rids=rid_tag)
                sess.metrics.histogram("wave_dies").observe(len(per_die))
            if per_ch:
                dev.ledger.add_channel_batch(
                    per_ch, label=f"wave {wi}: dma" if parts else None,
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
            and st.fused.n_operands > self.max_fused_operands))
        m.counter("fused_reduce_calls").add(sum(
            1 for st in plan.steps if len(st.args) > 1 or st.invert
            or st.fused is not None))

    def _build(self, plan: ExecPlan, popcounts: Tuple[bool, ...],
               layout: Optional[tuple]):
        """Close an eager wave runner over the static plan.  Runtime
        inputs: the gathered per-group / per-fused-step Vth stacks and one
        packed padding mask per batch root.  Returns a tuple of outputs,
        one per root.  Building it counts as the one trace.

        Placed (``layout`` from :meth:`_placement_layout`), each single-die
        sense group and fused step is issued on its shard's stream, where
        its rows were gathered, and the next unit is issued without
        waiting, so die-disjoint units of a wave may overlap on the card; a
        cross-die unit runs on the compute stream.  After a wave's units,
        one event per stream marks them; partials reach the compute stream
        only where a controller combine or a root consumes them: the
        compute stream waits for their stream's event, and the partial is
        marked as used there.  The single-root fused popcount keeps its
        fast path on the shard's stream.  Unplaced (``layout`` None), every
        unit's slot is None, and the arena's placement methods do nothing:
        everything runs on the current stream.

        The closure captures the backend, the static plan and the arena's
        bound placement methods, never the executor/session (the runner
        cache is device-shared and must not pin dead sessions)."""
        backend = self.session.backend
        max_ops = self.max_fused_operands
        arena = self.session.device.arena
        on_slot, ready = arena.on_slot, arena.ready
        to_compute, colocate = arena.to_compute, arena.colocate
        self._traces.n += 1
        roots = plan.all_roots
        fuse_pc = _root_fuses_popcount(plan, popcounts)
        fused_pos = _fused_positions(plan)
        if layout is None:
            group_slot = [None] * len(plan.groups)
            fused_slot = dict.fromkeys(fused_pos)
        else:
            group_slot = [slot for _, slot in layout[0]]
            fused_slot = dict(zip(fused_pos, (slot for _, slot in layout[1])))

        def fused_reduce(st: CombineStep, vth: torch.Tensor) -> torch.Tensor:
            return _fused_reduce(backend, max_ops, st, vth)

        def run(group_vth, fused_vth, masks):
            partials: Dict[int, torch.Tensor] = {}
            events: Dict[int, object] = {}    # pid -> event after its producer
            for wave in plan.waves:
                made: Dict[Optional[int], List[int]] = {}  # slot -> its pids
                for gi in wave.groups:
                    g = plan.groups[gi]
                    slot = group_slot[gi]
                    with on_slot(slot):
                        packed = backend.sense(group_vth[gi], g.plan)
                    for pid, (s, e) in g.spans():
                        partials[pid] = packed[s:e].reshape(-1)
                        made.setdefault(slot, []).append(pid)
                for si in wave.fused:
                    st = plan.steps[si]
                    f = st.fused
                    slot = fused_slot[si]
                    vth = fused_vth[fused_pos[si]].reshape(
                        f.n_operands, f.n_pages, -1)
                    if fuse_pc and st.out == plan.root:
                        mask = colocate(masks[0], slot)
                        with on_slot(slot):
                            mask2 = mask.reshape(f.n_pages, -1)
                            if f.n_operands <= max_ops:
                                counts = backend.sense_reduce_popcount(
                                    vth, f.plan, mask2, op=st.op,
                                    invert=st.invert)
                            else:
                                words = fused_reduce(st, vth).reshape(
                                    f.n_pages, -1) & mask2
                                counts = backend.popcount(words)
                            total = counts.sum(dtype=torch.int32)
                            done = ready(slot)
                        return (to_compute(total, done),)
                    with on_slot(slot):
                        partials[st.out] = fused_reduce(st, vth).reshape(-1)
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
                        stack = torch.stack([to_compute(partials[a], events[a])
                                             for a in st.args])
                        out = backend.reduce(
                            stack.reshape(len(st.args), 1, -1),
                            st.op, invert=st.invert)
                        partials[st.out] = out.reshape(-1)
                        events[st.out] = None
            outs = []
            for root, pc, mask in zip(roots, popcounts, masks):
                out = to_compute(partials[root], events[root]) & mask
                outs.append(backend.popcount(out.reshape(1, -1))[0]
                            if pc else out)
            return tuple(outs)

        return run


def _root_fuses_popcount(plan: ExecPlan, popcounts: Tuple[bool, ...]) -> bool:
    """Whether the popcount folds into the root kernel: only on a
    single-root plan whose root IS the last step and that step fused (a
    fused root consumes raw wordlines, so nothing else in the plan feeds
    it)."""
    return (len(plan.all_roots) == 1 and popcounts[0] and bool(plan.steps)
            and plan.steps[-1].out == plan.root
            and plan.steps[-1].fused is not None)


def _fused_positions(plan: ExecPlan) -> Dict[int, int]:
    """Step index -> position among the plan's fused steps."""
    return {si: k for k, si in enumerate(
        si for si, st in enumerate(plan.steps) if st.fused is not None)}


def _fused_reduce(backend, max_ops: int, st: CombineStep,
                  vth: torch.Tensor) -> torch.Tensor:
    """Fused sense->reduce, split into passes of ``max_ops`` operands when
    the stack holds more."""
    f = st.fused
    if f.n_operands <= max_ops:
        return backend.sense_reduce(vth, f.plan, op=st.op, invert=st.invert)
    parts = [backend.sense_reduce(vth[s:s + max_ops], f.plan, op=st.op,
                                  invert=False)
             for s in range(0, f.n_operands, max_ops)]
    return backend.reduce(torch.stack(parts), st.op, invert=st.invert)
