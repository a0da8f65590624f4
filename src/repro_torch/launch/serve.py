"""Serving launcher: batched prefill + greedy decode for any registry
arch whose prompts are token ids, at the launcher's ``tiny`` or ``100m``
scale (``launch/train.py``'s ``scale_config``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b \\
        --batch 4 --new-tokens 32 [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.launch.train import scale_config
from repro_torch.serve import Engine, ServeConfig

__all__ = ["main"]


def main(argv=None) -> torch.Tensor:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(ARCH_NAMES))
    ap.add_argument("--scale", choices=("tiny", "100m"), default="tiny")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = scale_config(get_config(args.arch), args.scale)
    if cfg.encdec or not cfg.uses_tokens:
        raise SystemExit(f"{args.arch} does not take token prompts; this "
                         "driver serves decoder-only LMs")
    eng = Engine.from_seed(cfg, seed=0, device=args.device,
                           serve_cfg=ServeConfig(
                               max_seq=args.prompt_len + args.new_tokens + 32,
                               temperature=args.temperature))
    gen = torch.Generator(device=eng.device)
    gen.manual_seed(1)
    prompts = torch.randint(1, cfg.vocab, (args.batch, args.prompt_len),
                            generator=gen, device=eng.device)
    t0 = time.perf_counter()
    out = eng.generate(prompts, max_new_tokens=args.new_tokens)
    if eng.device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if out.shape != (args.batch, args.prompt_len + args.new_tokens):
        raise RuntimeError(f"generate returned {tuple(out.shape)}")
    print(f"{args.arch} [{args.scale}]: {args.batch}x{args.new_tokens} "
          f"tokens in {dt:.1f}s ({args.batch * args.new_tokens / dt:.0f} "
          "tok/s)")
    print("sample:", out[0, args.prompt_len:args.prompt_len + 12].tolist())
    return out


if __name__ == "__main__":
    main()
