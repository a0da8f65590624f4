"""Cost analysis of an eager step: FLOPs, bytes and live memory per aten op.

The torch meaning of the JAX package's ``launch/hlo_analysis.py`` ("Loop-
aware cost analysis of compiled (post-SPMD, post-optimization) HLO").  The
port emits no HLO, so there is nothing to parse: :class:`CostCounter` is a
``TorchDispatchMode`` that runs a step (an AOT bundle's ``fn`` on its
``meta`` arguments, or a real step on the card) and counts, for every aten
op it dispatches:

- **FLOPs**: products and convolutions by the formulas of
  ``torch.utils.flop_counter``'s registry (``mm``, ``bmm``, ``addmm``,
  convolutions, attention kernels), kept apart as ``product_flops``; one
  per output element for elementwise ops (tagged ``pointwise``),
  reductions (tagged ``reduction``) and softmaxes, as the HLO walker counts
  its elementwise ops and ``reduce``.  An op without a formula is first
  decomposed, as ``FlopCounterMode`` does, so the two count the same
  products.
- **bytes**: each op's tensor inputs plus its tensor outputs.  Eager
  PyTorch does not fuse, so every operand crosses HBM.  Views (``view``,
  ``expand``, ``t``, ``slice``, ...), ``_unsafe_view`` and allocations
  that write nothing (``empty``) count 0, as the walker's
  ``_SKIP_BYTES_OPS`` do; ``copy_`` moves its source and destination; an
  indexed write into a buffer (``index_copy_``, ``index_put_``) reads its
  source and writes as many bytes, not the whole buffer, as the walker
  counts a dynamic-update-slice.
- **live bytes**: every storage an op makes is held by a weak reference;
  its bytes count from its first output until it is freed, and the peak of
  that sum is the step's temporary memory (the arguments, made before the
  step, are not counted; the outputs, made during it, are).

Loops need no trip counts: eager execution runs every iteration, so
remat's second forward, the microbatches and the cross-entropy chunks are
counted as they run.

:class:`Roofline` keeps the walker's fields and ``to_dict()`` keys, with
the constants of one NVIDIA H100 80GB HBM3 (SXM, 700 W) from its
datasheet.  There is no SPMD partitioner and so no collective in a step:
``coll_bytes`` and the collective terms are ``None``, not a guess.
"""
from __future__ import annotations

import dataclasses
import weakref
from collections import Counter
from typing import Any, Callable, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

__all__ = ["H100_SXM_BF16_FLOPS", "H100_SXM_HBM_BYTES_PER_S",
           "H100_SXM_NVLINK_BYTES_PER_S", "H100_MEMORY_BYTES", "Cost",
           "CostCounter", "count_cost", "Roofline", "roofline"]

# NVIDIA H100 80GB HBM3 (SXM, 700 W), datasheet figures
H100_SXM_BF16_FLOPS = 989e12         # dense bfloat16 FLOP/s
H100_SXM_HBM_BYTES_PER_S = 3.35e12   # HBM3 bytes/s
H100_SXM_NVLINK_BYTES_PER_S = 450e9  # NVLink bytes/s per direction
H100_MEMORY_BYTES = 80 * 2 ** 30

aten = torch.ops.aten

#: in-place writes into a buffer that touch only its indexed part (the
#: MoE dispatch, a decode step's cache slot)
_INDEXED_WRITES = {aten.index_copy_, aten.index_put_}
#: an allocation that writes nothing, and a view that is not tagged one
_NO_BYTES = {aten.empty, aten.empty_like, aten._unsafe_view}
#: softmaxes: elementwise work, one FLOP per output element
_SOFTMAX = {aten._softmax, aten._log_softmax, aten._softmax_backward_data,
            aten._log_softmax_backward_data}


def _tensor_bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@dataclasses.dataclass
class Cost:
    """What a counted run did: FLOPs (``product_flops`` of them in
    products), bytes moved, the peak of live bytes it made, ops run, and
    per op (aten name, first output's shape) its FLOPs and bytes."""
    flops: float = 0.0
    product_flops: float = 0.0
    bytes: float = 0.0
    peak_live_bytes: int = 0
    ops: int = 0
    flops_by_op: Counter = dataclasses.field(default_factory=Counter)
    bytes_by_op: Counter = dataclasses.field(default_factory=Counter)


class CostCounter(TorchDispatchMode):
    """Counts FLOPs, bytes and live memory of every aten op run under it
    (see the module docstring).  ``external`` tensors (the arguments)
    are not counted as memory the run made."""

    def __init__(self, external=()):
        super().__init__()
        self.cost = Cost()
        self._external = {t.untyped_storage()._cdata
                          for t in tree_leaves(external)
                          if isinstance(t, torch.Tensor)}
        self._live: dict = {}
        self._live_bytes = 0

    def _free(self, key: int) -> None:
        self._live_bytes -= self._live.pop(key, 0)

    def _track(self, out) -> None:
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            storage = t.untyped_storage()
            key = storage._cdata
            if key in self._live or key in self._external:
                continue
            self._live[key] = storage.nbytes()
            self._live_bytes += storage.nbytes()
            weakref.finalize(storage, self._free, key)
        self.cost.peak_live_bytes = max(self.cost.peak_live_bytes,
                                        self._live_bytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        packet = func._overloadpacket
        if packet not in flop_registry:      # as FlopCounterMode does
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        self._count(func, packet, args, kwargs, out)
        self._track(out)
        return out

    def _count(self, func, packet, args, kwargs, out) -> None:
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        key = (str(packet).removeprefix("aten."),
               tuple(outs[0].shape) if outs else ())
        flops = 0.0
        if packet in flop_registry:
            flops = float(flop_registry[packet](*args, **kwargs,
                                                out_val=out))
            self.cost.product_flops += flops
        elif (torch.Tag.pointwise in func.tags
              or torch.Tag.reduction in func.tags or packet in _SOFTMAX):
            flops = float(sum(t.numel() for t in outs))
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        if func.is_view or packet in _NO_BYTES:
            moved = 0
        elif packet in _INDEXED_WRITES:
            # the buffer is args[0]: read the source, write as many bytes
            moved = 2 * sum(_tensor_bytes(t) for t in ins[1:])
        elif packet is aten.copy_:
            moved = sum(_tensor_bytes(t) for t in ins[:2])
        else:
            moved = sum(_tensor_bytes(t) for t in ins) \
                + sum(_tensor_bytes(t) for t in outs)
        self.cost.flops += flops
        self.cost.bytes += moved
        self.cost.ops += 1
        if flops:
            self.cost.flops_by_op[key] += flops
        if moved:
            self.cost.bytes_by_op[key] += moved


def count_cost(fn: Callable, *args) -> Tuple[Any, Cost]:
    """``fn(*args)`` under a :class:`CostCounter`: (its output, the cost).
    On ``meta`` arguments nothing is allocated and nothing computed."""
    counter = CostCounter(external=args)
    with counter:
        out = fn(*args)
    return out, counter.cost


@dataclasses.dataclass
class Roofline:
    """One device's roofline terms for a step, with the H100's datasheet
    rates.  ``coll_bytes`` and the collective terms are ``None``: the port
    has no SPMD partitioner, so no step it runs holds a collective to
    count.  ``xla_flops`` / ``xla_bytes`` (XLA's own ``cost_analysis``)
    are ``None``: no XLA runs."""
    flops: float                # per device
    bytes_accessed: float       # per device, every eager op's operands
    coll_bytes: Optional[float] = None
    coll_by_kind: Optional[dict] = None
    xla_flops: Optional[float] = None
    xla_bytes: Optional[float] = None

    @property
    def compute_s(self) -> float:
        return self.flops / H100_SXM_BF16_FLOPS

    @property
    def memory_s(self) -> float:
        return self.bytes_accessed / H100_SXM_HBM_BYTES_PER_S

    @property
    def collective_s(self) -> Optional[float]:
        if self.coll_bytes is None:
            return None
        return self.coll_bytes / H100_SXM_NVLINK_BYTES_PER_S

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s}
        if self.collective_s is not None:
            terms["collective"] = self.collective_s
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Ideal-overlap lower bound: the largest term."""
        return max(t for t in (self.compute_s, self.memory_s,
                               self.collective_s) if t is not None)

    def to_dict(self) -> dict:
        return {
            "flops_per_device": self.flops,
            "bytes_per_device": self.bytes_accessed,
            "collective_bytes_per_device": self.coll_bytes,
            "collective_by_kind": self.coll_by_kind,
            "xla_cost_analysis_flops": self.xla_flops,
            "xla_cost_analysis_bytes": self.xla_bytes,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bottleneck": self.bottleneck,
            "step_time_lower_bound_s": self.step_time_s,
        }


def roofline(cost: Cost, devices: int = 1) -> Roofline:
    """The roofline of a counted step run by ``devices`` devices: its FLOPs
    and bytes split evenly over them (a perfectly sharded step's lower
    bound; with ``devices=1``, the step as one device ran it)."""
    return Roofline(flops=cost.flops / devices,
                    bytes_accessed=cost.bytes / devices)
