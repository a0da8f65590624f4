"""XOR-delta incremental checkpoints via the MCFlash bitwise kernel.

Between two checkpoints most bytes are similar, and the XOR delta
raw-bit-encodes the change.  Deltas are computed and applied with the
packed ``bitwise_reduce`` kernel through the port's
:class:`~repro_torch.api.backends.Backend` (the op an MCFlash SSD runs in
flash at restore time), as in the JAX package's ``checkpoint/delta.py``:
every leaf is viewed as 32-bit words (zero-padded), laid out as
``(2, rows, 512)`` words and folded with ``"xor"``.  On the card that
launches the CUDA kernel; leaves on the card stay there, and nothing is
copied to the host.  Delta leaves are int32 words (the JAX package's are
uint32; the bits are the same).
"""
from __future__ import annotations

import torch

from repro_torch.api.backends import Backend
from repro_torch.models.specs import flatten, tree_map

__all__ = ["delta_encode", "delta_apply", "delta_sparsity"]

#: words per row of the (2, rows, COLS) stack the kernel folds
COLS = 512

#: the backend the deltas run through, per device type (one object, so a
#: caller can wrap its methods to watch the kernel calls)
BACKENDS = {kind: Backend(torch.device(kind)) for kind in ("cuda", "cpu")}


def _to_words(x: torch.Tensor) -> torch.Tensor:
    """A leaf's bytes as flat int32 words, the last one zero-padded."""
    raw = x.detach().contiguous().reshape(-1).view(torch.uint8)
    pad = (-raw.numel()) % 4
    if pad:
        raw = torch.cat([raw, raw.new_zeros(pad)])
    return raw.view(torch.int32)


def _from_words(words: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    nbytes = like.numel() * like.element_size()
    raw = words.reshape(-1).view(torch.uint8)[:nbytes]
    return raw.view(like.dtype).reshape(like.shape).clone()


def _xor_words(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    n = a.numel()
    rows = -(-n // COLS)
    stack = torch.zeros((2, rows * COLS), dtype=torch.int32, device=a.device)
    stack[0, :n] = a
    stack[1, :n] = b
    return BACKENDS[a.device.type].reduce(stack.view(2, rows, COLS), "xor").reshape(-1)[:n]


def delta_encode(base_tree, new_tree):
    """XOR delta between two checkpoints of the same structure: a tree of
    int32 word tensors on the leaves' devices."""
    return tree_map(lambda b, n: _xor_words(_to_words(b), _to_words(n)),
                    base_tree, new_tree)


def delta_apply(base_tree, delta_tree):
    """Reconstruct: base XOR delta (the in-flash op on an MCFlash SSD)."""
    return tree_map(lambda b, d: _from_words(
        _xor_words(_to_words(b), d.to(b.device)), b),
        base_tree, delta_tree)


def delta_sparsity(delta_tree) -> float:
    """Fraction of zero words in the delta (compressibility proxy)."""
    zeros = total = 0
    for _, leaf in flatten(delta_tree):
        zeros += int((leaf == 0).sum())
        total += leaf.numel()
    return zeros / max(total, 1)
