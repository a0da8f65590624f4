"""End-to-end training driver for the PyTorch port: a ~100M-parameter LM
trained on the card, with MCFlash-backed bitmap data filtering,
fault-tolerant checkpointing (kill it mid-run and restart: it resumes) and
XOR-delta incremental checkpoints.

    PYTHONPATH=src python examples/torch_train_lm.py [--steps 300]
        [--arch qwen3-1.7b] [--device cuda|cpu] [--tiny]

The counterpart of ``examples/train_lm.py``.  The arch flag picks the
family; its widths are cut to the ~100M class (``scale_to_100m``), or with
``--tiny`` to ``launch/train.py``'s tiny scale, which trains in seconds on
the CPU.  The quality and dedup bitmaps of 131072 corpus shards are ANDed
and counted in flash (``BitmapFilter``); the count is held against numpy.
After training, the XOR delta between the first and the last checkpoint
of the whole parameter tree is encoded and applied back through the
``bitwise_reduce`` kernel, bit for bit.  The loss drops visibly (the
synthetic corpus has a learnable bigram).
"""
import argparse
import dataclasses
import os
import shutil
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.checkpoint import (delta_apply, delta_encode,  # noqa: E402
                                    delta_sparsity)
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import BitmapFilter  # noqa: E402
from repro_torch.launch.train import scale_config  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.specs import count_params, flatten  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.train.loop import LoopConfig, TrainLoop  # noqa: E402

N_SHARDS = 131072


def scale_to_100m(cfg):
    """Keep the family, shrink to ~100M params."""
    kw = dict(d_model=768, d_ff=2048, vocab=16384,
              repeats=min(cfg.repeats, 8))
    if cfg.n_heads:
        kw.update(n_heads=8, n_kv_heads=min(cfg.n_kv_heads, 4) or 1,
                  head_dim=64)
    if cfg.rnn_width:
        kw.update(rnn_width=512)
    if cfg.n_experts:
        kw.update(n_experts=4, top_k=2)
    pattern = tuple(dataclasses.replace(b, window=128 if b.window else 0)
                    for b in cfg.pattern)
    return dataclasses.replace(cfg, pattern=pattern, tail=(), **kw)


def filter_shards(device) -> int:
    """The in-flash AND of the quality and dedup bitmaps of N_SHARDS
    corpus shards, counted on the device; equal to numpy's count."""
    rng = np.random.default_rng(0)
    quality = (rng.random(N_SHARDS) < 0.95).astype(np.uint8)
    dedup = (rng.random(N_SHARDS) < 0.98).astype(np.uint8)
    bf = BitmapFilter(N_SHARDS, device=device)
    bf.add_pair("quality", quality, "dedup", dedup)
    kept = bf.count([("quality", "dedup")])
    if kept != int((quality & dedup).sum()):
        raise RuntimeError(f"in-flash count {kept} differs from numpy's")
    print(f"MCFlash bitmap filter kept {kept}/{N_SHARDS} corpus shards "
          f"({bf.device.ledger.commands} flash commands)")
    return kept


def delta_round_trip(ckpt_dir, like, base_step: int, params) -> float:
    """The XOR delta from checkpoint ``base_step``'s parameters to
    ``params``, applied back: bit-exact.  Returns the zero-word share."""
    (base, _), _ = ckpt.restore(ckpt_dir, like, base_step)
    delta = delta_encode(base, params)
    back = delta_apply(base, delta)
    for (path, got), (_, want) in zip(flatten(back), flatten(params)):
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            raise RuntimeError(f"delta round trip of {path} is not "
                               "bit-exact")
    return delta_sparsity(delta)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--fresh", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true")
    args = ap.parse_args(argv)
    if args.fresh:
        shutil.rmtree(args.ckpt_dir, ignore_errors=True)

    full = get_config(args.arch)
    cfg = scale_config(full, "tiny") if args.tiny else scale_to_100m(full)
    n = count_params(lm.build_specs(cfg))
    print(f"arch family {args.arch} scaled to {n / 1e6:.1f}M params")
    kept = filter_shards(args.device)

    ckpt_every = max(args.steps // 3, 1)
    loop = TrainLoop(
        cfg,
        LoopConfig(total_steps=args.steps, ckpt_every=ckpt_every,
                   ckpt_dir=args.ckpt_dir, log_every=20),
        opt_cfg=AdamWConfig(lr=1e-3, warmup_steps=max(args.steps // 10, 1),
                            total_steps=args.steps),
        global_batch=4, seq_len=256, device=args.device)
    loop.install_preemption_handler()
    result = loop.run()

    losses = [m["loss"] for m in result["metrics"]]
    k = max(min(10, len(losses) // 2), 1)
    first, last = np.mean(losses[:k]), np.mean(losses[-k:])
    print(f"\nloss: first{k}={first:.3f}  last{k}={last:.3f}  "
          f"(dropped {first - last:.3f})")

    base_step = min(ckpt_every, result["last_step"])
    zero = delta_round_trip(args.ckpt_dir, (result["params"], result["opt"]),
                            base_step, result["params"])
    print(f"XOR-delta checkpoint, step {base_step} -> {result['last_step']}, "
          f"whole tree: bit-exact=True (zero-word share {zero:.3f})")
    return {"kept": kept, "losses": losses, "delta_zero_share": zero,
            "last_step": result["last_step"]}


if __name__ == "__main__":
    main()
