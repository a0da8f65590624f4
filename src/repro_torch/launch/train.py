"""Training launcher: ``--arch <id>`` selects any registry architecture.

The JAX package's ``launch/train.py``: ``--scale tiny|100m`` shrinks the
selected family (``tiny`` runs in seconds on the CPU, ``100m`` is the
~100M-parameter class), with the fault-tolerant loop and its checkpoints.
``--scale full`` is refused, as in the JAX package: a full-size config is
trained on a card by ``chip_smoke.py`` (gemma3-1b) or from Python.

    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m \\
        --scale tiny --steps 50 [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.optim import AdamWConfig
from repro_torch.train.loop import LoopConfig, TrainLoop

__all__ = ["scale_config", "main"]


def scale_config(cfg, scale: str):
    """``cfg`` cut to ``tiny`` or ``100m`` widths (``full``: unchanged)."""
    if scale == "full":
        return cfg
    dims = dict(tiny=dict(d_model=128, d_ff=512, vocab=2048, repeats=2),
                **{"100m": dict(d_model=768, d_ff=2048, vocab=16384,
                                repeats=min(cfg.repeats, 8))})[scale]
    kw = dict(dims)
    if cfg.n_heads:
        kw.update(n_heads=4, n_kv_heads=min(cfg.n_kv_heads, 2) or 1,
                  head_dim=32)
    if cfg.rnn_width:
        kw.update(rnn_width=dims["d_model"])
    if cfg.n_experts:
        kw.update(n_experts=4, top_k=2)
    if cfg.encdec:
        kw.update(enc_layers=2, dec_seq=64)
    pattern = tuple(dataclasses.replace(b, window=64 if b.window else 0)
                    for b in cfg.pattern)
    return dataclasses.replace(cfg, pattern=pattern, tail=(), **kw)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(ARCH_NAMES))
    ap.add_argument("--scale", choices=("tiny", "100m", "full"),
                    default="tiny")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_launch_train"))
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.scale == "full":
        raise SystemExit("full-size training of a registry config is driven "
                         "from Python on a card (chip_smoke.py trains "
                         "gemma3-1b); use --scale tiny or 100m here")
    cfg = scale_config(get_config(args.arch), args.scale)
    loop = TrainLoop(
        cfg,
        LoopConfig(total_steps=args.steps, ckpt_every=max(args.steps // 2, 1),
                   ckpt_dir=args.ckpt_dir, log_every=10,
                   microbatches=args.microbatches),
        opt_cfg=AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                            total_steps=args.steps),
        global_batch=args.batch, seq_len=args.seq, device=args.device)
    loop.install_preemption_handler()
    result = loop.run()
    losses = [m["loss"] for m in result["metrics"]]
    if losses:
        print(f"done: steps={result['last_step']} "
              f"loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    return result


if __name__ == "__main__":
    main()
