"""GPipe pipeline parallelism over one mesh axis, on CUDA streams.

The JAX package's ``parallel/pipeline.py``: a layer-stacked model is cut
into ``S = mesh.sizes[axis]`` stages, stage ``s`` holding slice ``s`` of
the stacked parameters, and ``M`` microbatches stream through them on
GPipe's fill-and-drain schedule: ``M + S - 1`` ticks, microbatch ``m`` at
stage ``s`` in tick ``m + s``, a bubble of ``(S - 1) / (M + S - 1)``.

The JAX package runs the stages as the shards of a ``shard_map`` with
``ppermute`` handoffs.  Here stage ``s`` runs on ``devices[s]`` (entries
may repeat, as the placed runner's ``shard_devices`` do; by default the
input's device ``S`` times) on a CUDA stream of its own.  A handoff from
stage ``s`` to ``s + 1`` is ordered by an event recorded on stage ``s``'s
stream, which stage ``s + 1``'s stream waits on, and the handed tensor is
marked with ``record_stream`` so the caching allocator does not reuse its
memory while the next stage still reads it (as ``flash/arena.py`` orders
its shards).  No process group is needed: one process issues every stage.

Autograd flows through: PyTorch runs each backward op on the stream of
its forward op and orders the streams itself.  On CPU tensors the same
schedule runs in order, with no streams: that is the plain version.
"""
from __future__ import annotations

from contextlib import nullcontext
from typing import Callable, List, Optional, Sequence

import torch

from repro_torch.launch.mesh import Mesh
from repro_torch.models.specs import tree_map

__all__ = ["pipeline_apply", "bubble_fraction"]


def bubble_fraction(n_stages: int, microbatches: int) -> float:
    """GPipe's idle share of a stage: ``(S - 1) / (M + S - 1)``."""
    return (n_stages - 1) / (microbatches + n_stages - 1)


def pipeline_apply(stage_fn: Callable, params_stacked, x: torch.Tensor, *,
                   mesh: Mesh, axis: str = "pod", microbatches: int = 4,
                   devices: Optional[Sequence] = None) -> torch.Tensor:
    """``stage_fn`` composed over the ``S`` stages of ``axis``,
    microbatch-pipelined.

    ``stage_fn(stage_params, x_mb) -> x_mb`` applies one stage;
    ``params_stacked`` is a tree of tensors whose leading dimension is
    ``S``; ``x`` is the (B, ...) global batch, ``B % microbatches == 0``.
    Returns the last stage's output for every microbatch, in order, on
    ``x``'s device."""
    n_stages = mesh.sizes[axis]
    if x.shape[0] % microbatches:
        raise ValueError(f"microbatches={microbatches} does not divide the "
                         f"batch of {x.shape[0]}")
    devices = [torch.device(d) for d in devices] if devices is not None \
        else [x.device] * n_stages
    if len(devices) != n_stages:
        raise ValueError(f"{len(devices)} devices for {n_stages} stages")
    streams = [torch.cuda.Stream(device=d) if d.type == "cuda" else None
               for d in devices]
    for stream in streams:
        if stream is not None:       # x and the parameters are ready first
            stream.wait_stream(torch.cuda.current_stream(stream.device))

    params: List = []                # stage s's slice, on its stream
    for s, stream in enumerate(streams):
        with _on(stream):
            params.append(tree_map(
                lambda p: p[s].to(devices[s], non_blocking=True),
                params_stacked))

    xs = list(x.split(x.shape[0] // microbatches))
    carry: List = [None] * microbatches      # (activation, its ready event)
    for tick in range(microbatches + n_stages - 1):
        for s in range(n_stages):
            m = tick - s
            if not 0 <= m < microbatches:
                continue
            inp, ready = (xs[m], None) if s == 0 else carry[m]
            stream = streams[s]
            with _on(stream):
                if ready is not None and stream is None:  # card to CPU
                    ready.synchronize()
                elif ready is not None:
                    stream.wait_event(ready)
                    if inp.device != stream.device:   # a copy across cards
                        torch.cuda.current_stream(inp.device).wait_event(
                            ready)
                if stream is not None and inp.device == stream.device:
                    inp.record_stream(stream)
                y = stage_fn(params[s], inp.to(devices[s], non_blocking=True))
                done = None
                if stream is not None:
                    done = torch.cuda.Event()
                    done.record(stream)
            carry[m] = (y, done)

    outs = []
    for y, done in carry:            # the caller's stream waits for each
        if done is not None:
            here = torch.cuda.current_stream(y.device)
            here.wait_event(done)
            y.record_stream(here)
        outs.append(y.to(x.device))
    return torch.cat(outs)


def _on(stream):
    """``torch.cuda.stream(stream)``, or nothing for a CPU stage."""
    return torch.cuda.stream(stream) if stream is not None else nullcontext()
