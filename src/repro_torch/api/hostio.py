"""Double-buffered device->host result streaming.

:meth:`HostDrainQueue.submit` starts the device->host copy of a result
asynchronously and returns a :class:`DrainHandle` at once, so the caller
can lower and dispatch the next expression while the transfer runs.  The
queue is bounded (``depth`` in-flight transfers, default 2: the double
buffer): submitting past the bound resolves the oldest transfer first.

On a card the copy is a ``non_blocking`` copy into pinned host memory,
followed by a CUDA event; :attr:`DrainHandle.done` asks the event.  CPU
tensors are host memory already.  Results come back as numpy arrays, with
packed int32 words viewed as ``uint32``.
"""
from __future__ import annotations

from collections import deque
from typing import Callable, Deque, List, Optional

import numpy as np
import torch

__all__ = ["DrainHandle", "HostDrainQueue", "DEFAULT_DRAIN_DEPTH", "to_numpy"]

#: in-flight transfers the bounded queue holds — 2 == classic double buffer
DEFAULT_DRAIN_DEPTH = 2


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """Host numpy copy of a result; int32 words come back as uint32."""
    # the callers book the transfer (ext_to_host, or the drain queue's submit)
    out = t.detach().cpu().numpy()  # verify: allow(unledgered-transfer)
    return out.view(np.uint32) if out.dtype == np.int32 else out


class DrainHandle:
    """One in-flight device->host result transfer.

    :meth:`result` waits for the bytes and returns the numpy array
    (memoized: repeat calls are free).
    """

    __slots__ = ("_host", "_event", "_out", "n_bytes", "rid")

    def __init__(self, tensor: torch.Tensor, n_bytes: int,
                 rid: Optional[int] = None) -> None:
        self.n_bytes = int(n_bytes)
        #: owning request id (serving attribution), or None
        self.rid = rid
        self._out: Optional[np.ndarray] = None
        self._event = None
        if tensor.device.type == "cuda":
            self._host = torch.empty(tensor.shape, dtype=tensor.dtype,
                                     pin_memory=True)
            self._host.copy_(tensor, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = tensor.detach().clone()

    @property
    def done(self) -> bool:
        """True once the bytes are host-resident — a non-blocking probe."""
        return (self._out is not None or self._event is None
                or self._event.query())

    def result(self) -> np.ndarray:
        if self._out is None:
            if self._event is not None:
                self._event.synchronize()
            self._out = to_numpy(self._host)
            self._host = self._event = None
        return self._out


class HostDrainQueue:
    """Bounded async drain queue for device->host result streaming.

    ``on_submit(n_bytes)`` fires once per submit (ledger/metrics hook);
    ``on_block()`` fires each time a submit had to resolve the oldest
    in-flight transfer to respect ``depth`` (backpressure events).
    """

    def __init__(self, depth: int = DEFAULT_DRAIN_DEPTH,
                 on_submit: Optional[Callable[[int], None]] = None,
                 on_block: Optional[Callable[[], None]] = None) -> None:
        if depth < 1:
            raise ValueError(f"drain depth must be >= 1, got {depth}")
        self.depth = int(depth)
        self._pending: Deque[DrainHandle] = deque()
        self._on_submit = on_submit
        self._on_block = on_block

    def __len__(self) -> int:
        return len(self._pending)

    def submit(self, tensor: torch.Tensor, n_bytes: Optional[int] = None,
               rid: Optional[int] = None) -> DrainHandle:
        """Enqueue one result transfer; resolves the oldest in-flight
        transfer first when the queue is full."""
        if n_bytes is None:
            n_bytes = tensor.numel() * tensor.element_size()
        handle = DrainHandle(tensor, n_bytes, rid=rid)
        if self._on_submit is not None:
            self._on_submit(handle.n_bytes)
        self._pending.append(handle)
        while len(self._pending) > self.depth:
            oldest = self._pending.popleft()
            if self._on_block is not None:
                self._on_block()
            oldest.result()
        return handle

    def drain(self) -> List[DrainHandle]:
        """Resolve every in-flight transfer; returns the handles in submit
        order (all ``done``)."""
        out: List[DrainHandle] = []
        while self._pending:
            h = self._pending.popleft()
            h.result()
            out.append(h)
        return out

    def reset(self) -> None:
        """Drop in-flight transfers without resolving them."""
        self._pending.clear()
