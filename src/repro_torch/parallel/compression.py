"""Gradient compression with error feedback (the inter-pod all-reduce).

The JAX package's ``parallel/compression.py``: symmetric per-tensor int8
quantization, deterministic, with a residual (error-feedback) accumulator:
the quantization error of step t is added back at step t + 1, which keeps
SGD / Adam convergence unbiased in practice.  :func:`compressed_all_reduce`
is the counterpart of ``compressed_psum``, over
``torch.distributed.all_reduce``.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.models.specs import tree_map

__all__ = ["quantize_int8", "dequantize_int8", "compress_with_feedback",
           "decompress", "compressed_all_reduce"]


def quantize_int8(x: torch.Tensor):
    """Symmetric per-tensor int8 quantization -> (q int8, scale float32)."""
    amax = x.abs().max().float()
    scale = torch.clamp(amax, min=1e-30) / 127.0
    q = torch.clamp(torch.round(x.float() / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_with_feedback(grads, residuals):
    """Quantize ``grads`` plus the carried error.  Returns (payload, new
    residuals); the payload holds a ``(q, scale)`` pair per leaf."""
    if residuals is None:
        residuals = tree_map(lambda g: torch.zeros_like(g, dtype=torch.float32),
                             grads)

    def one(g, r):
        corrected = g.float() + r
        q, scale = quantize_int8(corrected)
        return (q, scale), corrected - dequantize_int8(q, scale)

    pairs = tree_map(one, grads, residuals)
    return tree_map(lambda p: p[0], pairs), tree_map(lambda p: p[1], pairs)


def decompress(payload):
    return tree_map(lambda p: dequantize_int8(*p), payload)


def compressed_all_reduce(grads, residuals, group=None):
    """The int8-compressed mean all-reduce of ``grads`` over ``group`` (the
    default process group): each rank quantizes with error feedback, and
    the dequantized tensors are averaged.  Returns (mean grads, new
    residuals)."""
    payload, new_res = compress_with_feedback(grads, residuals)
    world = dist.get_world_size(group)

    def reduce_one(p):
        deq = dequantize_int8(*p)
        dist.all_reduce(deq, group=group)
        return deq / world

    return tree_map(reduce_one, payload), new_res
