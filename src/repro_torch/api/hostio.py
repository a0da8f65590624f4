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

A result made in chunks drains as they are made: :meth:`HostDrainQueue.open`
gives an empty :class:`ChunkedDrain`; its producer takes one pinned buffer
and a copy stream from it (:meth:`ChunkedDrain.target`) and copies each
chunk into the buffer while it makes the next; :meth:`HostDrainQueue.admit`
then queues it like any submit.

With a tracer, each submit (or admit) is a ``drain_submit`` span, tagged
with the transfer's ``bytes``, ``rid`` and ``chunks`` (1 for a whole
tensor), and each handle's first :meth:`DrainHandle.result` a
``drain_wait`` span, tagged with ``bytes`` and ``rid``.
"""
from __future__ import annotations

from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.obs.trace import Tracer, traced

__all__ = ["ChunkedDrain", "DrainHandle", "HostDrainQueue", "DEFAULT_DRAIN_DEPTH",
           "to_numpy"]

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

    __slots__ = ("_host", "_event", "_out", "_tracer", "n_bytes", "rid")

    def __init__(self, tensor: torch.Tensor, n_bytes: int,
                 rid: Optional[int] = None,
                 tracer: Optional[Tracer] = None) -> None:
        self._start(n_bytes, rid, tracer)
        if tensor.device.type == "cuda":
            self._host = torch.empty(tensor.shape, dtype=tensor.dtype,
                                     pin_memory=True)
            self._host.copy_(tensor, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = tensor.detach().clone()

    def _start(self, n_bytes: int, rid: Optional[int],
               tracer: Optional[Tracer]) -> None:
        self.n_bytes = int(n_bytes)
        #: owning request id (serving attribution), or None
        self.rid = rid
        self._tracer = tracer
        self._out: Optional[np.ndarray] = None
        self._event = None

    @property
    def done(self) -> bool:
        """True once the bytes are host-resident — a non-blocking probe."""
        return (self._out is not None or self._event is None
                or self._event.query())

    def result(self) -> np.ndarray:
        if self._out is None:
            with traced(self._tracer, "drain_wait", "drain-result",
                        bytes=self.n_bytes, rid=self.rid):
                if self._event is not None:
                    self._event.synchronize()
                self._out = to_numpy(self._host)
            self._host = self._event = None
        return self._out


#: per card, the stream chunked drains copy on
_COPY_STREAMS: Dict[torch.device, "torch.cuda.Stream"] = {}


def _copy_stream(device: torch.device) -> "torch.cuda.Stream":
    stream = _COPY_STREAMS.get(device)
    if stream is None:
        stream = _COPY_STREAMS[device] = torch.cuda.Stream(device)
    return stream


class ChunkedDrain(DrainHandle):
    """A device->host transfer whose producer copies its result in chunks,
    each as soon as it is made.

    :meth:`target` gives the producer the flat int32 buffer of the result's
    packed words (pinned, on a card) and the stream it copies the chunks
    on, each after the event of its chunk, so a chunk's copy runs while the
    next is made.  The producer sets :attr:`chunks`.  :meth:`close` marks
    the last copy, which :meth:`result` waits for.
    """

    __slots__ = ("_stream", "chunks")

    def __init__(self, tracer: Optional[Tracer] = None) -> None:
        self._start(0, None, tracer)
        self.chunks = 0
        self._stream = None
        self._host = None

    def target(self, words: int, device: torch.device
               ) -> "Tuple[torch.Tensor, Optional[torch.cuda.Stream]]":
        """The buffer of a result of ``words`` packed words made on
        ``device``, and the stream its chunks are copied on (None off the
        card, where the copies are plain)."""
        self.n_bytes = words * 4
        on_card = device.type == "cuda"
        self._host = torch.empty((words,), dtype=torch.int32,
                                 pin_memory=on_card)
        self._stream = _copy_stream(device) if on_card else None
        return self._host, self._stream

    def close(self) -> None:
        """Mark the last chunk's copy: :meth:`result` waits for it."""
        if self._stream is not None:
            self._event = torch.cuda.Event()
            self._event.record(self._stream)


class HostDrainQueue:
    """Bounded async drain queue for device->host result streaming.

    ``on_submit(n_bytes)`` fires once per submit (ledger/metrics hook);
    ``on_block()`` fires each time a submit had to resolve the oldest
    in-flight transfer to respect ``depth`` (backpressure events).
    ``tracer`` (the session's) spans each submit and each handle's wait.
    """

    def __init__(self, depth: int = DEFAULT_DRAIN_DEPTH,
                 on_submit: Optional[Callable[[int], None]] = None,
                 on_block: Optional[Callable[[], None]] = None,
                 tracer: Optional[Tracer] = None) -> None:
        if depth < 1:
            raise ValueError(f"drain depth must be >= 1, got {depth}")
        self.depth = int(depth)
        self.tracer = tracer
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
        with traced(self.tracer, "drain_submit", "drain-submit",
                    bytes=n_bytes, rid=rid, chunks=1):
            handle = DrainHandle(tensor, n_bytes, rid=rid, tracer=self.tracer)
            self._enqueue(handle)
        return handle

    def open(self) -> ChunkedDrain:
        """An empty transfer of a result made in chunks
        (:class:`ChunkedDrain`); :meth:`admit` queues it once its producer
        has enqueued the last chunk's copy."""
        return ChunkedDrain(tracer=self.tracer)

    def admit(self, handle: ChunkedDrain) -> ChunkedDrain:
        """Close a chunked transfer and queue it, as :meth:`submit` does a
        whole tensor's."""
        with traced(self.tracer, "drain_submit", "drain-submit",
                    bytes=handle.n_bytes, rid=handle.rid,
                    chunks=handle.chunks):
            handle.close()
            self._enqueue(handle)
        return handle

    def _enqueue(self, handle: DrainHandle) -> None:
        if self._on_submit is not None:
            self._on_submit(handle.n_bytes)
        self._pending.append(handle)
        while len(self._pending) > self.depth:
            oldest = self._pending.popleft()
            if self._on_block is not None:
                self._on_block()
            oldest.result()

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
        """Drop in-flight transfers without resolving them.  A chunked
        transfer's copies are waited for first: nothing else keeps its
        pinned buffer from being handed out again while they run."""
        for handle in self._pending:
            if isinstance(handle, ChunkedDrain) and handle._event is not None:
                handle._event.synchronize()
        self._pending.clear()
