"""Serving driver for the PyTorch port: batched prefill + greedy decode.

    PYTHONPATH=src python examples/torch_serve_lm.py [--arch gemma3-1b]
        [--device cuda|cpu] [--full-width]

The counterpart of ``examples/serve_lm.py``.  Without ``--full-width`` the
arch is cut to the same ``tiny()`` family config (d_model 256, 4 pattern
repeats, window 64; RG-LRU width 256, 4 experts, the published SSD
sizes); with it, the published widths and depth run on a card
(gemma3-1b is about 1e9 parameters, mamba2-130m 1.3e8, recurrentgemma-9b
8.6e9; the float32 weights of mixtral-8x7b, dbrx-132b, qwen3-32b and
internvl2-26b do not fit one 80 GB card).  Weights are random, from a
seed.  Every arch whose prompts are token ids serves; internvl2-26b
(patch embeddings) and whisper-tiny (audio frames) take other prompts
and the engine rejects them.
"""
import argparse
import dataclasses
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.serve import Engine, ServeConfig  # noqa: E402

PROMPT = 32


def tiny(cfg):
    kw = dict(d_model=256, d_ff=1024, vocab=4096, repeats=4)
    if cfg.n_heads:
        kw.update(n_heads=4, n_kv_heads=min(cfg.n_kv_heads, 2) or 1, head_dim=64)
    if cfg.rnn_width:
        kw.update(rnn_width=256)
    if cfg.n_experts:
        kw.update(n_experts=4, top_k=2)
    pattern = tuple(dataclasses.replace(b, window=64 if b.window else 0)
                    for b in cfg.pattern)
    return dataclasses.replace(cfg, pattern=pattern, tail=(), **kw)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-1b")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--full-width", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--new-tokens", type=int, default=48)
    args = ap.parse_args()

    cfg = get_config(args.arch)
    if not args.full_width:
        cfg = tiny(cfg)
    eng = Engine.from_seed(cfg, seed=0, device=args.device,
                           serve_cfg=ServeConfig(max_seq=256))
    gen = torch.Generator(device=eng.device)
    gen.manual_seed(1)
    prompts = torch.randint(1, cfg.vocab, (args.batch, PROMPT),
                            generator=gen, device=eng.device)
    t0 = time.perf_counter()
    out = eng.generate(prompts, max_new_tokens=args.new_tokens)
    if eng.device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    assert out.shape == (args.batch, PROMPT + args.new_tokens)
    assert torch.equal(out[:, :PROMPT], prompts)
    assert eng.decode_calls == args.new_tokens - 1
    where = (torch.cuda.get_device_name(eng.device)
             if eng.device.type == "cuda" else "the CPU")
    width = "full width" if args.full_width else "tiny family config"
    print(f"{args.arch} ({width}): generated {args.batch}x{args.new_tokens} "
          f"tokens in {dt:.2f} s on {where} "
          f"({args.batch * args.new_tokens / dt:.0f} tok/s, first call)")
    print("sample token ids:", out[0, PROMPT:PROMPT + 16].tolist())


if __name__ == "__main__":
    main()
