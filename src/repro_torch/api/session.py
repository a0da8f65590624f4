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

Not ported yet, and raising ``NotImplementedError`` when asked for: plan
verification (``verify=`` other than ``"off"``, ROADMAP queue 1 item 6),
fault injection and recovery (``faults=`` / ``recovery=``, item 7), span
tracing (``trace=``, item 4) and several shard devices (item 3).
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Iterable, List, Tuple

import numpy as np
import torch

from repro_torch.api.backends import Backend
from repro_torch.api.executor import ExecPlan, Executor
from repro_torch.api.graph import ASSOCIATIVE, BitVector, Leaf, simplify
from repro_torch.api.hostio import DrainHandle, HostDrainQueue
from repro_torch.api.plan_cache import PlanCache
from repro_torch.core import encoding, tlc
from repro_torch.core.mcflash import ReadPlan
from repro_torch.core.vth_model import ChipModel
from repro_torch.kernels import ref as kernel_ref
from repro_torch.obs.metrics import MetricsRegistry

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
    ("host_drain_submits", "async device->host transfers enqueued"),
    ("host_drain_blocks", "drain-queue backpressure stalls (queue full)"),
    ("coalesced_sense_groups", "batch sense groups shared by >1 request"),
    ("waves_shared", "schedule waves carrying work of >1 request"),
    ("tail_mask_evictions", "tail-mask cache entries evicted (LRU bound)"),
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


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP queue 1 "
                               f"{item})")


class ComputeSession:
    """Session-level MCFlash compute over named bit-vector handles.

    ``device`` is the torch device (``None`` = the card).  ``flash`` or
    ``ftl`` wrap an existing :class:`~repro_torch.flash.device.FlashDevice`
    (its device then rules).
    """

    def __init__(self, device: "torch.device | str | None" = None, *,
                 flash=None, ftl=None, chip=None, config=None, timing=None, energy=None,
                 seed: int = 0, encoding: str = tlc.MLC, trace: bool = False,
                 verify: "str | None" = "off", faults=None, recovery=None,
                 overlap: "bool | str | None" = None,
                 drain_depth: "int | None" = None):
        from repro_torch.flash.device import FlashDevice
        from repro_torch.flash.ftl import FTL

        if verify not in (None, "off"):
            raise _not_ported("plan verification (verify=)", "item 6")
        if faults is not None or recovery is not None:
            raise _not_ported("fault injection and recovery", "item 7")
        if trace:
            raise _not_ported("span tracing (trace=)", "item 4")
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
        #: span tracer (not ported yet: always None)
        self.trace = None
        self._tail_masks: "OrderedDict[Tuple[int, int], torch.Tensor]" = \
            OrderedDict()

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
    def lower(self, expr: BitVector) -> ExecPlan:
        """Canonicalize + lower ``expr`` to its static :class:`ExecPlan`
        without dispatching."""
        return self.executor.lower(simplify(expr.node))

    def materialize(self, expr: BitVector, *, unpacked: bool = False,
                    to_host: bool = True) -> torch.Tensor:
        """Compile + execute the expression DAG; returns the result vector
        on the session's device.

        Packed int32 words by default — page-padded, with any bits beyond
        ``expr.n_bits`` masked to zero; ``unpacked=True`` returns per-cell
        uint8 bits trimmed to ``expr.n_bits``.  ``to_host`` books the final
        controller->host transfer in the ledger.
        """
        packed = self.executor.run(simplify(expr.node), expr.n_bits)
        if to_host:
            self.device.ext_to_host(int(packed.shape[-1]) * 4)
        if unpacked:
            return kernel_ref.unpack_bits(packed.reshape(1, -1))[0][: expr.n_bits]
        return packed

    def _on_drain_submit(self, n_bytes: int) -> None:
        self.metrics.counter("host_drain_submits").add(1)
        self.device.ext_to_host(n_bytes)

    def materialize_async(self, expr: BitVector) -> DrainHandle:
        """Like :meth:`materialize`, but stream the packed result to the host
        through the bounded drain queue; ``handle.result()`` (or
        :meth:`drain`) returns it as a numpy uint32 array."""
        packed = self.executor.run(simplify(expr.node), expr.n_bits)
        return self.host_queue.submit(packed, int(packed.shape[-1]) * 4)

    def drain(self) -> List[np.ndarray]:
        """Resolve every in-flight :meth:`materialize_async` transfer."""
        return [h.result() for h in self.host_queue.drain()]

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
        count = self.executor.run_popcount(simplify(expr.node), expr.n_bits)
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
            "host_drain": {"submits": self.host_drain_submits,
                           "blocks": self.host_drain_blocks,
                           "pending": len(self.host_queue),
                           "depth": self.host_queue.depth},
            "coalesced_sense_groups": self.coalesced_sense_groups,
            "waves_shared": self.waves_shared,
            "tail_mask_cache": {"size": len(self._tail_masks),
                                "cap": TAIL_MASK_CACHE_CAP,
                                "evictions": self.tail_mask_evictions},
            "verify": {"mode": "off"},
            "arena_shards": self.device.arena.n_shards,
            "ledger": self.ledger.summary(),
        }

    def reset_stats(self, include_ledger: bool = True) -> None:
        """Zero this session's metrics (and, by default, the shared ledger).
        Device-shared cache counters are left alone."""
        self.metrics.reset()
        self.host_queue.reset()
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
