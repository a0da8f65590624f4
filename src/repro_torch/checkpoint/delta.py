"""XOR-delta incremental checkpoints via the MCFlash bitwise kernel.

Between two checkpoints most bytes are similar, and the XOR delta
raw-bit-encodes the change.  Deltas are computed and applied with the
packed ``bitwise_reduce`` kernel through the port's
:class:`~repro_torch.api.backends.Backend` (the op an MCFlash SSD runs in
flash at restore time), as in the JAX package's ``checkpoint/delta.py``:
every leaf is viewed as flat 32-bit words (zero-padded to whole words),
and the two word tensors are folded with ``"xor"`` as they are, with no
stacking (the JAX package's ``(2, rows, 512)`` layout was the TPU's tile).
``delta_apply`` writes base XOR delta straight into the new leaf's storage.
On the card that launches the CUDA kernel once per leaf and direction;
leaves on the card stay there, and nothing is copied to the host.  Delta
leaves are int32 words (the JAX package's are uint32; the bits are the
same).
"""
from __future__ import annotations

import torch

from repro_torch.api.backends import Backend
from repro_torch.models.specs import flatten, tree_map

__all__ = ["delta_encode", "delta_apply", "delta_sparsity"]

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


def _xor_words(a: torch.Tensor, b: torch.Tensor,
               out: "torch.Tensor | None" = None) -> torch.Tensor:
    return BACKENDS[a.device.type].reduce((a, b), "xor", out=out)


def delta_encode(base_tree, new_tree):
    """XOR delta between two checkpoints of the same structure: a tree of
    int32 word tensors on the leaves' devices."""
    return tree_map(lambda b, n: _xor_words(_to_words(b), _to_words(n)),
                    base_tree, new_tree)


def _apply_leaf(base: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    words = _to_words(base)
    delta = delta.to(base.device)
    leaf = torch.empty(base.shape, dtype=base.dtype, device=base.device)
    nbytes = leaf.numel() * leaf.element_size()
    if nbytes % 4 == 0:             # the XOR lands in the new leaf itself
        _xor_words(words, delta, out=leaf.reshape(-1).view(torch.uint8)
                   .view(torch.int32))
        return leaf
    raw = _xor_words(words, delta).view(torch.uint8)[:nbytes]
    return leaf.copy_(raw.view(base.dtype).reshape(base.shape))


def delta_apply(base_tree, delta_tree):
    """Reconstruct: base XOR delta (the in-flash op on an MCFlash SSD)."""
    return tree_map(_apply_leaf, base_tree, delta_tree)


def delta_sparsity(delta_tree) -> float:
    """Fraction of zero words in the delta (compressibility proxy)."""
    zeros = total = 0
    for _, leaf in flatten(delta_tree):
        zeros += int((leaf == 0).sum())
        total += leaf.numel()
    return zeros / max(total, 1)
