"""Detection + bounded recovery: retry ladder, recalibration, migration.

The :class:`ReliabilityManager` is the session-side half of the reliability
layer (the device-side half is :class:`~repro_torch.reliability.faults.FaultModel`).
After every materialize it verifies the packed result against the composed
per-leaf checkwords (:mod:`repro_torch.reliability.checkwords`); on mismatch it
walks the escalation ladder the :class:`~repro_torch.reliability.policy.RetryPolicy`
allows:

1. **read-retry** — re-execute the lowered plan eagerly with the whole
   reference stack shifted by alternating offsets around the stored
   per-encoding trim (the fault model is common-mode, so one scalar offset
   per attempt is the paper's dynamic-sensing move); a sampled-clean offset
   is margin-confirmed one step deeper before acceptance, because a
   window-edge offset can pass the samples while tail cells still misread;
2. **recalibration** — a full reference sweep over ``±recal_span_v``; a
   clean offset becomes the sticky per-encoding trim, so the *next*
   incident's ladder starts there (one retry instead of a sweep);
3. **migration** — blocks whose EWMA residual RBER (sampled at the best
   ladder offset) stays above ``migrate_rber_pct`` are retired and their
   vectors relocated to fresh blocks under ``migrate_encoding`` (wider
   margins), with the copyback programs slotted into idle die slots of the
   triggering plan's wave schedule (audited by the ``migration-barrier``
   invariant).

Every re-sense and relocation books real die/channel time in the session
ledger under the ``recovery`` / ``migration`` categories — recovery is never
free — and failure is typed: :class:`SenseMismatchError` (retry disabled),
:class:`RetryExhaustedError` (ladder + recalibration dry), and
:class:`BlockRetiredError` (relocation could not read the data back clean).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.core.calibration import shift_plan
from repro_torch.kernels import ref as kernel_ref
from repro_torch.obs.trace import traced
from repro_torch.reliability import checkwords
from repro_torch.reliability.errors import (BlockRetiredError,
                                            RetryExhaustedError,
                                            SenseMismatchError)
from repro_torch.reliability.policy import RetryPolicy

__all__ = ["ReliabilityManager"]

def _longest_zero_run(indices: List[int]) -> List[int]:
    """Longest run of consecutive ints in a sorted list (ties: first run)."""
    best: List[int] = []
    run: List[int] = []
    for i in indices:
        if run and i == run[-1] + 1:
            run.append(i)
        else:
            run = [i]
        if len(run) > len(best):
            best = run
    return best


#: manager-owned counters, registered in the session's MetricsRegistry so
#: ``reset_stats()`` and ``stats()`` see them like any other session metric
_RELIABILITY_COUNTERS = (
    ("reliability_checks", "materialize results checkword-verified"),
    ("reliability_mismatches", "checkword mismatches detected"),
    ("reliability_retries", "read-retry ladder attempts"),
    ("reliability_recalibrations", "full reference-sweep recalibrations"),
    ("reliability_migrations", "blocks migrated to a wider encoding"),
    ("reliability_retired_blocks", "blocks retired from allocation"),
)


class ReliabilityManager:
    """Session-bound checkword verification + escalating recovery."""

    def __init__(self, session, policy=None):
        self.session = session
        self.policy = RetryPolicy.parse(policy)
        self.ftl = session.ftl
        self.device = session.device
        self.wear = session.ftl.wear
        self.wear.alpha = self.policy.ewma_alpha
        #: sticky per-encoding-set reference trim learned by recalibration
        self.ref_trim: Dict[str, float] = {}
        #: one dict per detection incident (label, residuals, outcome)
        self.incidents: List[dict] = []
        #: (n_bits, torch device) -> (word index on the device, bit shifts):
        #: only the sampled words of a result cross to the host
        self._sample_index: Dict[tuple, tuple] = {}
        m = session.metrics
        for name, desc in _RELIABILITY_COUNTERS:
            m.counter(name, desc)
        m.histogram("incident_rber_pct",
                    "sampled mismatch %% at detection time, per incident")

    # -- small helpers --------------------------------------------------------
    def _count(self, name: str, n: int = 1) -> None:
        self.session.metrics.counter(name).add(n)

    @property
    def _page_bits(self) -> int:
        return self.ftl.cfg.page_bits

    def _positions(self, n_bits: int) -> np.ndarray:
        return checkwords.sample_positions(n_bits, self.policy.check_samples)

    def _sample(self, packed: torch.Tensor, n_bits: int) -> np.ndarray:
        """The sampled bits of an ``n_bits`` packed result, gathering only
        the sampled words on the device (lane-major layout, see
        :func:`checkwords.sample_index`)."""
        key = (int(n_bits), packed.device)
        hit = self._sample_index.get(key)
        if hit is None:
            word, bit = checkwords.sample_index(
                n_bits, self.policy.check_samples, self._page_bits)
            hit = (torch.as_tensor(word, dtype=torch.long,
                                   device=packed.device), bit)
            self._sample_index[key] = hit
        idx, bit = hit
        words = packed.reshape(-1)[idx].cpu().numpy().view(np.uint32)
        return ((words >> bit) & 1).astype(np.uint8)

    def _leaf_names(self, node) -> List[str]:
        """Distinct leaf vector names of a canonical DAG, first-seen order."""
        names: List[str] = []
        seen: set = set()
        stack = [node]
        while stack:
            n = stack.pop()
            if id(n) in seen:
                continue
            seen.add(id(n))
            name = getattr(n, "name", None)
            if name is not None:
                if name not in names:
                    names.append(name)
            else:
                stack.extend(n.args)
        return names

    def _blocks_of(self, meta) -> List[Tuple[int, int]]:
        return sorted({(p, b) for p, b, _ in meta.pages})

    def _block_pe(self, block: Tuple[int, int]) -> int:
        base = 0
        faults = getattr(self.device, "faults", None)
        if faults is not None:
            base = faults.cfg.pe
        return base + self.device.pe_counts.get(block, 0)

    def _enc_key(self, metas) -> str:
        return "+".join(sorted({m.encoding for m in metas}))

    # -- shifted re-execution -------------------------------------------------
    def _execute_shifted(self, plan, dv: float, n_bits: int,
                         label: str) -> torch.Tensor:
        """Re-run a lowered plan with every reference stack shifted by ``dv``
        volts through an uncached runner of the executor's (retry attempts
        are rare and offset-dependent, so caching runners per offset would
        thrash the device cache for no win).  Books one ``recovery`` die step
        and one channel step per wave from the executor's wave costs."""
        sess = self.session
        ex = sess.executor
        ledger = self.device.ledger
        if dv:
            plan = plan.with_read_plans(lambda p: shift_plan(p, dv))
        for wi, wave in enumerate(plan.waves):
            cost = ex.wave_costs(plan, wave)
            step = f"{label} wave {wi} @{dv:+.3f}V"
            if cost.per_die:
                ledger.add_die_batch(cost.per_die, cost.uj,
                                     commands=cost.cmds,
                                     category="recovery", label=step)
            if cost.per_ch:
                ledger.add_channel_batch(cost.per_ch, label=step,
                                         category="recovery")
        run = ex._build(plan, (False,), None, ex.row_sharing(plan, None))
        group_rows, fused_rows = ex.unit_rows(plan, None)
        return run(group_rows, fused_rows,
                   (sess.tail_mask(n_bits, plan.out_words),), (n_bits,))[0]

    def _mismatches(self, packed, want: np.ndarray, n_bits: int) -> int:
        return int(np.count_nonzero(self._sample(packed, n_bits) != want))

    # -- per-vector checked reads (realignment / migration source) ------------
    def _read_role_packed(self, meta, dv: float, *, label: str,
                          category: str = "recovery") -> torch.Tensor:
        dev = self.device
        plan = dev.page_read_plan(meta.role, meta.encoding)
        if dv:
            plan = shift_plan(plan, dv)
        per_die, uj = dev.page_read_cost((meta.pages,), meta.role,
                                         phases=plan.sensing_phases)
        dev.ledger.add_die_batch(per_die, uj, commands=len(meta.pages),
                                 category=category,
                                 label=f"{label} {meta.name}@{dv:+.3f}V")
        return self.session.backend.sense(dev.vth_rows(meta.pages), plan)

    @staticmethod
    def _unpack(packed: torch.Tensor, n_bits: int) -> torch.Tensor:
        return kernel_ref.unpack_bits(packed.reshape(1, -1))[0][:n_bits]

    def read_vector_checked(self, meta) -> torch.Tensor:
        """Read one stored vector's bits back, verified against its
        checkword, retrying/recalibrating per policy — the source read for
        copyback realignment and migration (a factory-reference read under
        injected wear would silently copy corrupted bits forward *and*
        recompute matching checkwords).  Returns the bits as a uint8
        tensor on the session's device."""
        pos = self._positions(meta.n_bits)
        if meta.check is None or len(meta.check) != len(pos):
            # pre-reliability vector: nothing to verify against
            packed = self._read_role_packed(meta, 0.0, label="read",
                                            category="sense")
            return self._unpack(packed, meta.n_bits)
        trim = self.ref_trim.get(meta.encoding, 0.0)
        offsets = [0.0]
        for off in self.policy.ladder_offsets(trim):
            if off not in offsets:
                offsets.append(off)
        tried: List[float] = []

        def clean_at(off: float) -> "torch.Tensor | None":
            packed = self._read_role_packed(meta, off, label="checked-read")
            mm = self._mismatches(packed, meta.check, meta.n_bits)
            if mm == 0:
                return packed
            if not tried and off == 0.0:
                self._count("reliability_mismatches")
                if not self.policy.allows("retry"):
                    raise SenseMismatchError(mm, len(pos), meta.name)
            else:
                self._count("reliability_retries")
            tried.append(off)
            return None

        for off in offsets:
            packed = clean_at(off)
            if packed is None:
                continue
            # margin-confirm non-trim recovery offsets (window-edge luck
            # would silently copy corrupted bits forward) — the factory
            # read and the window-centered trim are pre-verified
            if off == 0.0 or (trim and off == trim):
                return self._unpack(packed, meta.n_bits)
            self._count("reliability_retries")
            deeper = off + math.copysign(self.policy.ref_step_v, off)
            tried.append(deeper)
            confirm = self._read_role_packed(meta, deeper,
                                             label="checked-read")
            if not self._mismatches(confirm, meta.check, meta.n_bits):
                return self._unpack(confirm, meta.n_bits)
        if self.policy.allows("recalibrate"):
            self._count("reliability_recalibrations")
            sweep = [float(o) for o in np.linspace(-self.policy.recal_span_v,
                                                   self.policy.recal_span_v,
                                                   self.policy.recal_steps)]
            clean: List[int] = []
            packs: Dict[int, torch.Tensor] = {}
            for i, off in enumerate(sweep):
                packed = self._read_role_packed(meta, off, label="recal-read")
                if not self._mismatches(packed, meta.check, meta.n_bits):
                    clean.append(i)
                    packs[i] = packed
            # centering the trim in the widest sampled-clean window restores
            # real margin — a window-EDGE offset can pass the samples while
            # tail cells still misread (silent corruption if copied forward)
            run = _longest_zero_run(clean)
            if run:
                mid = run[len(run) // 2]
                self.ref_trim[meta.encoding] = sweep[mid]
                return self._unpack(packs[mid], meta.n_bits)
            raise RetryExhaustedError(len(tried), tried, meta.name,
                                      recalibrated=True)
        raise RetryExhaustedError(len(tried), tried, meta.name)

    # -- localization + migration ---------------------------------------------
    def _localize(self, metas) -> List:
        """Leaves whose *factory-reference* role read disagrees with their
        checkword — the blocks that actually degraded (a clean leaf's blocks
        must not inherit a co-leaf's migration)."""
        faulty = []
        for meta in metas:
            if meta.check is None:
                continue
            pos = self._positions(meta.n_bits)
            if len(meta.check) != len(pos):
                continue
            packed = self._read_role_packed(meta, 0.0, label="localize")
            if self._mismatches(packed, meta.check, meta.n_bits):
                faulty.append(meta)
        return faulty

    def _migrate_blocks(self, blocks: List[Tuple[int, int]], dv: float,
                        plan, label: str) -> None:
        """Retire ``blocks`` and relocate every resident vector to fresh
        blocks under the policy's migration encoding, reading the source at
        the recovered offset ``dv`` and verifying each vector against its
        checkword before the rewrite.  The copyback programs are slotted
        into idle die slots of the triggering plan's wave schedule and the
        modified plan re-verified (migration-barrier invariant)."""
        ftl = self.ftl
        dev = self.device
        blockset = set(blocks)
        names: List[str] = []
        for plane, block in blocks:
            ftl.retire_block(plane, block)
            self._count("reliability_retired_blocks")
            for name in ftl.vectors_in_block(plane, block):
                if name not in names:
                    names.append(name)
        lost: List[Tuple[int, int]] = []
        prog0 = dev.ledger.category_us.get("program", 0.0)
        prev_log = dev.program_log
        dev.program_log = log = []
        try:
            for name in names:
                meta = ftl.vectors[name]
                pos = self._positions(meta.n_bits)
                packed = self._read_role_packed(meta, dv, label="migrate-read",
                                                category="migration")
                if meta.check is not None and len(meta.check) == len(pos):
                    if self._mismatches(packed, meta.check, meta.n_bits):
                        lost.extend(sorted(blockset.intersection(
                            self._blocks_of(meta))) or self._blocks_of(meta))
                        continue
                bits = self._unpack(packed, meta.n_bits)
                ftl.write_scattered(name, bits, role="lsb",
                                    die=meta.die,
                                    encoding=self.policy.migrate_encoding)
        finally:
            dev.program_log = prev_log
        # the relocation programs are migration work, not workload programs
        delta = dev.ledger.category_us.get("program", 0.0) - prog0
        if delta:
            dev.ledger.category_us["program"] -= delta
            dev.ledger.category_us["migration"] = \
                dev.ledger.category_us.get("migration", 0.0) + delta
        from repro_torch.api.executor import (
            ProgramStep, schedule_programs_into_idle_waves)
        steps = [ProgramStep(step_label, list(wls),
                             tuple(sorted({dev.die_of_plane(p)
                                           for p, _, _ in wls})))
                 for step_label, wls in log]
        schedule_programs_into_idle_waves(plan, steps)
        if self.session.verifier.enabled:
            self.session.verifier.verify(plan, self.session.plan_context(),
                                         None)
        self._count("reliability_migrations", len(blocks))
        if lost:
            raise BlockRetiredError(sorted(set(lost)), label)

    # -- the escalation ladder -------------------------------------------------
    def verify_and_recover(self, node, n_bits: int,
                           packed: torch.Tensor) -> torch.Tensor:
        """Checkword-verify one materialized result; on mismatch walk the
        policy's escalation ladder and return the recovered result (or raise
        the taxonomy error for the stage that failed)."""
        names = self._leaf_names(node)
        if not names:
            return packed
        metas = [self.ftl.vectors[n] for n in names if n in self.ftl.vectors]
        if len(metas) != len(names):
            return packed
        pos = self._positions(n_bits)
        if any(m.check is None or m.n_bits != n_bits
               or len(m.check) != len(pos) for m in metas):
            return packed                  # unverifiable (pre-reliability)
        self._count("reliability_checks")
        want = checkwords.expected_samples(node,
                                           {m.name: m.check for m in metas})
        mm = self._mismatches(packed, want, n_bits)
        if mm == 0:
            return packed
        return self._recover(node, n_bits, metas, want, pos, mm, packed)

    def _recover(self, node, n_bits: int, metas, want: np.ndarray,
                 pos: np.ndarray, detected_mm: int, packed) -> torch.Tensor:
        sess = self.session
        policy = self.policy
        label = getattr(node, "op", None) or getattr(node, "name", "read")
        n_samples = len(pos)
        detected_pct = 100.0 * detected_mm / n_samples
        self._count("reliability_mismatches")
        sess.metrics.histogram("incident_rber_pct").observe(detected_pct)
        tracer = sess.trace
        if tracer is not None:
            tracer.instant("reliability", "checkword-mismatch",
                           label=label, mismatches=detected_mm,
                           samples=n_samples)
        if not policy.allows("retry"):
            raise SenseMismatchError(detected_mm, n_samples, label)
        incident = {"label": label, "mismatches": detected_mm,
                    "samples": n_samples, "retries": 0,
                    "recalibrated": False, "migrated_blocks": 0,
                    "offset": None}
        self.incidents.append(incident)
        with traced(tracer, "reliability", f"recover[{label}]",
                    mismatches=detected_mm):
            return self._recover_inner(node, n_bits, metas, want, pos,
                                       label, incident)

    def _recover_inner(self, node, n_bits: int, metas, want: np.ndarray,
                       pos: np.ndarray, label: str,
                       incident: dict) -> torch.Tensor:
        sess = self.session
        policy = self.policy
        plan = sess.executor.lower(node)
        enc_key = self._enc_key(metas)
        trim = self.ref_trim.get(enc_key, 0.0)
        n_samples = len(pos)

        # Stage 1: bounded read-retry ladder around the sticky trim.  A
        # sampled-clean offset is NOT accepted at face value: an offset at
        # the clean window's EDGE can pass the samples while tail cells
        # still misread (silent corruption).  The stored trim is exempt (it
        # was window-centered by a recalibration); any other clean offset
        # is margin-confirmed by probing one ladder step deeper toward the
        # drift — accepted only if the deeper probe also reads clean, in
        # which case the deeper (better-margined) result is returned.
        tried: List[float] = []
        best_off, best_mm = 0.0, n_samples + 1
        for off in policy.ladder_offsets(trim):
            self._count("reliability_retries")
            incident["retries"] += 1
            tried.append(off)
            result = self._execute_shifted(plan, off, n_bits, "retry")
            mm = self._mismatches(result, want, n_bits)
            if mm < best_mm:
                best_off, best_mm = off, mm
            if mm:
                continue
            accept = off
            if not (trim and off == trim):
                deeper = off + math.copysign(policy.ref_step_v, off)
                self._count("reliability_retries")
                incident["retries"] += 1
                tried.append(deeper)
                confirm = self._execute_shifted(plan, deeper, n_bits, "retry")
                cmm = self._mismatches(confirm, want, n_bits)
                if cmm < best_mm:
                    best_off, best_mm = deeper, cmm
                if cmm:
                    continue           # window-edge luck: keep climbing
                accept, result = deeper, confirm
            # healthy incident: the ladder still reads clean, so every
            # involved block's residual decays toward zero (no migration)
            for meta in metas:
                for blk in self._blocks_of(meta):
                    self.wear.record(blk, 0.0, pe=self._block_pe(blk))
            incident["offset"] = accept
            return result
        ladder_residual_pct = 100.0 * best_mm / n_samples

        # Stage 2: full reference recalibration sweep.  The trim is the
        # CENTER of the widest sampled-clean window, not the first clean
        # point — an edge offset can pass the samples while tail cells still
        # misread, and migration would copy that corruption forward.
        result = None
        if policy.allows("recalibrate"):
            self._count("reliability_recalibrations")
            incident["recalibrated"] = True
            sweep = [float(o) for o in np.linspace(-policy.recal_span_v,
                                                   policy.recal_span_v,
                                                   policy.recal_steps)]
            clean: List[int] = []
            for i, off in enumerate(sweep):
                got = self._execute_shifted(plan, off, n_bits, "recal")
                mm = self._mismatches(got, want, n_bits)
                if mm < best_mm:
                    best_off, best_mm = off, mm
                if mm == 0:
                    clean.append(i)
            run = _longest_zero_run(clean)
            if run:
                center = sweep[run[len(run) // 2]]
                got = self._execute_shifted(plan, center, n_bits, "recal")
                if self._mismatches(got, want, n_bits) == 0:
                    self.ref_trim[enc_key] = center
                    best_off, best_mm = center, 0
                    incident["offset"] = center
                    result = got

        # Stage 3: record residuals at the best ladder offset and migrate
        # the blocks whose EWMA crossed the threshold.
        if policy.allows("migrate"):
            faulty = self._localize(metas)
            over: List[Tuple[int, int]] = []
            for meta in faulty:
                for blk in self._blocks_of(meta):
                    if self.wear.is_retired(blk):
                        continue
                    h = self.wear.record(blk, ladder_residual_pct,
                                         pe=self._block_pe(blk))
                    if h.rber_pct >= policy.migrate_rber_pct \
                            and blk not in over:
                        over.append(blk)
            if over:
                self._migrate_blocks(over, best_off, plan, label)
                incident["migrated_blocks"] = len(over)
                # relocation changed placements: re-lower and re-read at the
                # recovered trim (fresh wide-margin rows read clean there)
                plan2 = sess.executor.lower(node)
                final_off = self.ref_trim.get(enc_key, best_off)
                got = self._execute_shifted(plan2, final_off, n_bits,
                                            "post-migrate")
                want2 = checkwords.expected_samples(
                    node, {n: self.ftl.vectors[n].check
                           for n in self._leaf_names(node)})
                if self._mismatches(got, want2, n_bits) == 0:
                    incident["offset"] = final_off
                    return got
                raise RetryExhaustedError(incident["retries"], tried, label,
                                          recalibrated=incident["recalibrated"])
        if result is not None:
            return result
        raise RetryExhaustedError(incident["retries"], tried, label,
                                  recalibrated=incident["recalibrated"])

    # -- stats / reset ---------------------------------------------------------
    def stats(self) -> dict:
        m = self.session.metrics
        return {
            "policy": dataclasses.asdict(self.policy),
            "checks": int(m["reliability_checks"].value),
            "mismatches": int(m["reliability_mismatches"].value),
            "retries": int(m["reliability_retries"].value),
            "recalibrations": int(m["reliability_recalibrations"].value),
            "migrations": int(m["reliability_migrations"].value),
            "retired_blocks": int(m["reliability_retired_blocks"].value),
            "incidents": len(self.incidents),
            "ref_trim": dict(self.ref_trim),
            "wear": self.wear.summary(),
            "rber_histogram": self.wear.histogram(),
        }

    def reset(self) -> None:
        """Drop the incident log (counters live in the session registry and
        reset with it).  The learned reference trims and wear state persist —
        they are device calibration, not per-run statistics."""
        self.incidents.clear()
