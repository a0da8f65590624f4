"""Checkpoints of tensor trees (the JAX package's on-disk layout) and XOR
deltas through the port's ``bitwise_reduce`` kernel."""
from repro_torch.checkpoint import ckpt, delta
from repro_torch.checkpoint.ckpt import latest_step, restore, save
from repro_torch.checkpoint.delta import (delta_apply, delta_encode,
                                          delta_sparsity)

__all__ = ["ckpt", "delta", "save", "restore", "latest_step",
           "delta_encode", "delta_apply", "delta_sparsity"]
