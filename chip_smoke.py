#!/usr/bin/env python3
"""Run the PyTorch port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py

1. Prints the card's name and power limit (``nvidia-smi``) and builds the
   CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc`` per source, in
   parallel).
2. Holds each of the five kernels against its plain PyTorch version on
   the card at full 16 kB pages (131072 cells), bit for bit: rows that are
   and are not multiples of 8, every read kind (``parity`` with 1..8
   references), every op, both inversion flags, words with bit 31 set.
   Then, at the shapes the main path gives each kernel, holds it against
   its plain version once more and times both with CUDA events (and the
   one PyTorch call that computes the same function, where there is one).
3. Drives the compute-session main path, ``ComputeSession(device="cuda")``
   on the default SSD (16 channels x 8 dies, 16 kB pages): the seven
   Table-1 ops and the TLC AND3/OR3 fast paths under mlc, tlc and
   reduced-mlc; the Fig-10 bitmap index (AND over 30 daily bitmaps of
   2**25 users, 256 pages each) with its popcount; an image-encryption XOR.
   Every result is held against a numpy oracle bit for bit, and every
   kernel's launch count must have risen during this phase.
4. Serving phase: a ``repro_torch.serve.QueryEngine`` with the default
   ``SLOConfig`` over a session on the default SSD: 32 column bitmaps of
   2**25 bits (16 MLC pairs over 16 dies, 2 GiB of Vth) and 96 requests in
   the mix of ``benchmarks/serve_latency.py`` (pair AND, pair XOR,
   3-operand OR chain, popcount of an AND).  Every result is held against
   a numpy oracle; it prints solo against batched waves, ``waves_shared``,
   ``coalesced_sense_groups`` and the p50/p99 admit->result latency read
   from the tracer's request spans.
5. Recovery phase: sessions with 10k-P/E wear faults and one dead
   (plane, block) under a written pair, recovery on, under mlc and
   reduced-mlc: Table-1 ops, a fused chain and a controller combine on
   2**20-bit pairs.  The dead block's data cannot be read back at any
   reference, so the ladder (retry, recalibrate, migrate) retires it and
   raises ``BlockRetiredError``; the pair is rewritten from the host copy
   and every result is then held against numpy.  It prints the raw bit
   errors of the same work with recovery off, the ladder's counters, the
   bit errors left after ``device.age(5000 h)`` on top of the ladder
   (measured, not gated: the sampled checkword can miss sparse errors, and
   the JAX package leaves the same errors on the same rows,
   ``tests/test_torch_reliability.py``), and reduced-mlc's raw error rate
   at 10k P/E over 8 fault seeds.  Retention aging as
   ``tests/test_reliability.py`` checks it (a 5k-P/E mlc pair, recovery on,
   ``age(5000 h)``) must stay bit-exact with no fewer retries; tlc and
   reduced-mlc run the same way and report their bit errors.
   In both phases the session's backend records the first call of each
   kernel at each read plan, as the served pass and the ladder make them
   (the ladder's shifted references included), and each recorded call is
   held against its kernel's plain version on the same inputs; every
   kernel the phase launched must have a recorded call, and the phase's
   launch counts must be above 0 for the kernels it needs.
6. Endurance phase: ``repro_torch.core.rber.measure_rber`` for every op at
   fresh (2**30 bits per op), 1.5k P/E (2**27), 10k P/E (2**30) and 3k P/E
   + 1000 h (2**27), 1024 pages per chunk; the claims of
   ``tests/test_rber.py`` held as rates; one chunk per (op, point) counted
   through the kernels (each call held against its plain version) and per
   cell, the two counts equal.
7. Applications phase: ``run_workload`` for the three Fig-10 workloads at
   2**25 bits per operand (the bitmap index: 15 pairs, 2 GiB of Vth) and a
   ``BitmapFilter`` over 2**25 samples with 4 pairs, each against numpy,
   every recorded kernel call against its plain version; the kernel calls
   per kernel must equal the launches and the CPU rehearsal's counts
   (``APPS_LAUNCHES``).  Prints the full-scale speedup projections.
8. Placed phase: ``FlashDevice(shard_devices=["cuda"] * 4)`` (four
   streams on the card, die ``d`` on stream ``d % 4``) runs the main
   path's Table-1 ops under the three encodings at 2**20 bits and the
   30-operand bitmap index at 2**25 users, plus an OR over the bitmap's 15
   day pairs, AND and XOR in turn (one pair per die: one wave of 15
   die-disjoint sense groups and a combine).  Every
   result equals numpy and the unplaced device's words, the plan counters
   equal the unplaced run's, ``placed_unit_dispatches`` is above 0, the
   recorded kernel calls ran on at least two streams and each equals its
   plain version.  Placed and unplaced are then timed in alternating
   pairs: the whole workload on fresh devices, and the fold query.
9. LM phase: ``Engine.from_seed(get_config("gemma3-1b"))`` at full width
   (26 layers, d_model 1152, vocab 262144; about 1e9 parameters) on the
   card serves 4 prompts of 64 tokens with 32 new tokens at max_seq 256.
   Two greedy calls give equal tokens, the prompts come back unchanged,
   ``decode_calls`` is 31 per call, and each decode step's logits equal a
   full prefill's over the same prefix within 2e-2 of the logits' scale.
   Then ``delta_encode`` / ``delta_apply`` of the whole parameter tree
   against a copy with one layer perturbed round-trips bit for bit,
   launching ``bitwise_reduce`` once per leaf and direction; its recorded
   call equals the plain version.  Prints prefill and decode times,
   tokens/s and the peak allocated memory.  A second engine over the same
   weights at max_seq 1024 (twice the 512-token window) serves prompts of
   480 tokens with 64 new, so each sliding-window ring wraps after 32
   steps; every decode step's logits, teacher-forced, equal those of one
   forward pass over the tokens within the same tolerance.  Then, each
   from a fresh ``Engine.from_seed`` at its published widths
   (``LM_ARCHS``): mamba2-130m (24 ``ssd`` layers; 4 x 64 tokens + 32
   new, then the XOR delta of its tree), recurrentgemma-9b (38 layers of
   ``rglru`` and ``swa``; 4 x 64 + 16), mixtral-8x7b cut to 4 of its 32
   layers (4 x 64 + 16 at capacity factor 4.0, where nothing is dropped,
   and the share of dropped assignments at the published 1.25),
   whisper-tiny (``encdec_prefill`` of 4 x 1536 frames, 32 greedy steps
   from token 1, then the XOR delta) and internvl2-26b cut to 4 of its 48
   layers (a prefill of 4 x 256 patch embeddings, 16 greedy tokens).
   Each: tokens equal over two runs; each step, replayed, picks the
   served token; in float32 (the master weights) each decode step within
   1e-3 of one full pass over the same tokens; in bfloat16 each served
   step's gap to a bfloat16 full pass is reported (at random weights
   bfloat16 rounding alone moves these stacks' logits by more than 2e-2),
   with the bfloat16 pass's distance from the float32 one.  Prints prefill and decode
   times, the card's busy share of a decode step, tokens/s and the peak
   allocated memory.
10. Training phase: the training example's MCFlash filter (the quality
   and dedup bitmaps of 131072 corpus shards ANDed and counted in flash,
   equal to numpy's count); ``TrainLoop`` over gemma3-1b at its published
   widths and depth from seed 0 (``TokenPipeline`` batches of 4 x 512
   tokens, float32 master weights and AdamW moments, remat on, lr 3e-4
   after 2 warmup steps): preempted after step 12, restarted from its
   checkpoint with the restored state bit-exact and the first resumed
   loss within 1e-4 of the uninterrupted run's, run to step 16; every
   loss finite, the first within 1.0 of ln(262144), the last four below
   the first four; one step with microbatches=2 within 2e-2 of one
   batch's gradient norm; the step timed (CUDA events), profiled and its
   model FLOPs set against the bf16 peak; the XOR delta of the whole
   trained tree between checkpoints 8 and 16 bit-exact through
   ``bitwise_reduce``.  The phase's kernel calls must equal the CPU
   rehearsal's (``TRAIN_LAUNCHES``), each recorded call its plain
   version.  Then one full-width pattern unit (5 ``swa`` layers and 1
   ``attn``) in float32 on 1 x 512 tokens: the loss within 1e-5 and every
   gradient within 1e-3 of the CPU's; and mamba2-130m trained 4 steps of
   4 x 256 tokens at its published widths, its losses finite.  The step
   also runs once under ``FlopCounterMode`` for the cost phase.
11. Pipeline phase: ``parallel.pipeline.pipeline_apply`` over gemma3-1b's
   four stacked pattern units (6 layers each, full width, seed 0) as four
   stages, each on a stream of its own on the card, over 16 x 512 tokens
   of bfloat16 hidden state at 4 and 16 microbatches: each microbatch's
   output equal bit for bit to the sequential pass over it, the whole
   within 2e-2 of one full-batch sequential pass; in float32, one unit
   per stage on 1 x 512 tokens, the gradients of every stacked leaf and
   of the input within 1e-5 of the sequential pass's.  Prints the times
   (CUDA events), the kernels' overlap across the stage streams
   (``torch.profiler``) and GPipe's bubble formula.
12. Cost phase: ``launch.dryrun.run_cell`` for gemma3-1b's ``train_4k``
   cell on the 16 x 16 and 2 x 16 x 16 production meshes (meta tensors,
   no card memory); the training phase's step counted on meta tensors
   (``launch.cost_analysis``), its product FLOPs equal to
   ``FlopCounterMode``'s on the real step on the card; prints them beside
   ``train_flops`` and the JAX package's 6·N·D, and the step's measured
   time against the roofline's lower bound.
13. Prints the ``kernels`` JSON line (launches summed over the eight
   paths; the pipeline and cost phases launch none of the five kernels),
   then a last line ``{"ok": true, "device": {...}}``.

Any failure raises and exits non-zero before the last line.  Without a
card, or without the rest of the repository beside it, it exits non-zero.
A fuller record goes to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: H100 SXM device-memory rate and fp32 (non-tensor) peak, from the data sheet
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
COLS = 131072                        # one 16 kB page of cells
BITMAP_USERS = 2 ** 25               # 256 pages per daily bitmap
BITMAP_DAYS = 30
TABLE1_BITS = 2 ** 20                # 8 pages per operand
IMAGE_BITS = 800 * 600 * 24          # one RGB image as 24 bitplanes (Fig 10)
SERVE_COLUMNS = 32                   # 16 MLC pairs of 2**25-bit bitmaps
SERVE_REQUESTS = 96
FAULT_PE = 10_000
DEAD_BLOCK = (0, 0)                  # (plane, block): under die 0's first pair
RATE_SEEDS = 8                       # fault seeds of the raw error rate
AGE_HOURS = 5000.0                   # retention aging (5000 h)
AGE_PE = 5000                        # wear of the gated aging check
ENDURANCE_SEED = 0
PAGES_PER_CHUNK = 1024               # 2**27 cells, 512 MiB of Vth per chunk
#: (label, P/E cycles, retention hours, 16 kB pages per op): Table 2, Fig 6
ENDURANCE_POINTS = (("fresh", 0, 0.0, 8192),          # 2**30 bits per op
                    ("1.5k P/E", 1500, 0.0, 1024),    # 2**27
                    ("10k P/E", 10_000, 0.0, 8192),
                    ("3k P/E + 1000 h", 3000, 1000.0, 1024))
RBER_BOUND_PCT = 0.015 * 1.5         # the paper's 10k-P/E bound, 1.5x slack
APP_BITS = 2 ** 25                   # bits per operand of each workload
APP_SEED = 3
FILTER_SAMPLES = 2 ** 25
FILTER_PAIRS = 4
#: kernel calls of the applications phase, per kernel, in its rehearsal on
#: the CPU at 1 kB pages and the same page counts (2**21 bits per operand)
APPS_LAUNCHES = {"mlc_sense": 3, "sense_reduce": 2, "sense_reduce_popcount": 1,
                 "bitwise_reduce": 1, "popcount_rows": 0}
PLACED_SHARDS = 4                    # FlashDevice(shard_devices=["cuda"] * 4)
PLACED_SEED = 5
PLACED_PAIRS = 3                     # placed / unplaced workload pairs, timed
QUERY_PAIRS = 8                      # ... and pairs of the fold query
QUERY_ITERS = 10                     # materializes per timed query turn
PROFILE_TRIES = 3                    # torch.profiler sessions per measurement
LM_ARCH = "gemma3-1b"                # at its published widths and depth
LM_BATCH = 4
LM_PROMPT = 64
LM_NEW = 32
LM_MAX_SEQ = 256
LM_SEED = 0
#: decode logits against a full prefill's, as a share of the logits' scale
#: (the bfloat16 tolerance of tests/test_torch_lm.py)
LM_TOL = 2e-2
#: decode steps before and after each sliding-window ring wraps, in the LM
#: phase's second run (prompt = window - LM_WRAP_STEPS, max_seq 2 * window)
LM_WRAP_STEPS = 32
#: float32 decode steps against a float32 full pass, as a share of the
#: logits' scale (the float32 tolerance of tests/test_torch_lm_archs.py)
LM_F32_TOL = 1e-3
#: the LM phase's runs after gemma3-1b, each at its published widths:
#: mixtral-8x7b and internvl2-26b cut in depth to fit one card; whisper's
#: 1500 encoder frames rounded up to 1536, a multiple of flash_attention's
#: 512-token kv block; mixtral checked at a capacity factor that drops
#: nothing (n_experts / top_k), its drops counted at the published 1.25.
#: mamba2's bfloat16 decode gap is reported, not gated: at its published
#: width its bfloat16 logits carry rounding noise past LM_TOL (its
#: bfloat16 full pass lies about 0.06 of the scale from its float32 one,
#: ``bf16_full_vs_f32``); its float32 decode is gated
LM_ARCHS = {
    "mamba2-130m": dict(batch=4, prompt=64, new=32, max_seq=256, delta=True,
                        bf16_gated=False),
    "recurrentgemma-9b": dict(batch=4, prompt=64, new=16, max_seq=256),
    "mixtral-8x7b": dict(batch=4, prompt=64, new=16, max_seq=256, repeats=4,
                         capacity_factor=4.0, drops_at=1.25),
    "whisper-tiny": dict(batch=4, frames=1536, new=32, delta=True),
    "internvl2-26b": dict(batch=4, patches=256, new=16, max_seq=512,
                          repeats=4),
}

#: the training phase: gemma3-1b at its published widths and depth, from
#: seed 0, on TokenPipeline batches of 4 x 512 tokens (512 is both the
#: sliding window and the cross-entropy chunk), float32 master weights and
#: AdamW moments, remat on; 16 steps, checkpoints every 8, preempted after
#: step 12 and restarted
TRAIN_ARCH = "gemma3-1b"
TRAIN_BATCH, TRAIN_SEQ = 4, 512
TRAIN_STEPS, TRAIN_CKPT_EVERY, TRAIN_PREEMPT = 16, 8, 12
TRAIN_LR, TRAIN_WARMUP = 3e-4, 2
TRAIN_SEED = 0
#: the first loss lies within this of ln(vocab) (initial logits have a std
#: of about 0.02 * sqrt(d_model), 0.68 at gemma3-1b's width)
TRAIN_FIRST_LOSS_TOL = 1.0
#: the restarted loop's first loss against the uninterrupted run's
#: (relative; the same state gives the same forward pass)
TRAIN_RESUME_TOL = 1e-4
#: microbatches=2 against one batch: the gradient norm (relative; each
#: microbatch's bfloat16 gradients are rounded before they are summed)
TRAIN_MB_TOL = 2e-2
#: float32 forward_loss of one full-width pattern unit, card against CPU:
#: the loss (relative) and each gradient leaf (of its largest magnitude)
TRAIN_F32_LOSS_TOL, TRAIN_F32_GRAD_TOL = 1e-5, 1e-3
TRAIN_F32_SEQ = 512
#: mamba2-130m at its published widths and depth: steps of 4 x 256 tokens
SSM_TRAIN_ARCH, SSM_TRAIN_STEPS, SSM_TRAIN_SEQ = "mamba2-130m", 4, 256
#: the corpus shards the training example's BitmapFilter selects from
TRAIN_SHARDS = 131072
#: kernel calls of the training phase per kernel, from its rehearsal on the
#: CPU (the same filter on the default SSD: one sense of the pair's AND and
#: its popcount; the delta of a tree with gemma3-1b's 90 leaves, one reduce
#: per leaf and direction)
TRAIN_LAUNCHES = {"mlc_sense": 1, "sense_reduce": 0,
                  "sense_reduce_popcount": 0, "bitwise_reduce": 180,
                  "popcount_rows": 1}
#: the H100's dense bfloat16 peak (NVIDIA's data sheet, SXM, at 700 W)
BF16_PEAK_FLOPS = 989e12
#: the pipeline phase: gemma3-1b's four stacked pattern units (6 layers
#: each) as four stages on four streams of the card, 16 sequences x 512
#: tokens of bfloat16 hidden state, at these microbatch counts
PIPE_ARCH, PIPE_SEED = "gemma3-1b", 0
PIPE_BATCH, PIPE_SEQ, PIPE_MICROBATCHES = 16, 512, (4, 16)
#: the pipeline's output against one full-batch sequential pass (bfloat16,
#: of the output's scale; each microbatch is gated bit for bit against the
#: sequential pass over that microbatch)
PIPE_TOL = 2e-2
#: float32 gradients through the pipeline (one unit per stage, 1 x 512
#: tokens) against the sequential pass's, of each leaf's scale
PIPE_GRAD_TOL = 1e-5
#: the cost phase: gemma3-1b's dry-run cell on both production meshes
COST_CELL = ("gemma3-1b", "train_4k")

KERNELS = {
    "mlc_sense": ("src/repro_torch/csrc/mlc_sense.cu",
                  "src/repro/kernels/mlc_sense.py:87"),
    "sense_reduce": ("src/repro_torch/csrc/fused.cu",
                     "src/repro/kernels/fused.py:168"),
    "sense_reduce_popcount": ("src/repro_torch/csrc/fused.cu",
                              "src/repro/kernels/fused.py:211"),
    "bitwise_reduce": ("src/repro_torch/csrc/bitops.cu",
                       "src/repro/kernels/bitops.py:46"),
    "popcount_rows": ("src/repro_torch/csrc/popcount.cu",
                      "src/repro/kernels/popcount.py:47"),
}
KIND_REFS = {"lsb": [1.9], "msb": [0.1, 3.7], "sbr": [0.1, 3.7, 1.9, 5.5]}
#: float32 compares per cell of each read kind (parity: one per reference)
KIND_COMPARES = {"lsb": 1, "msb": 2, "sbr": 4}


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def sync() -> None:
    torch.cuda.synchronize()


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def word_err(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest difference of two word tensors, read as uint32 (0 = equal)."""
    if a.shape != b.shape:
        fail(f"shapes differ: {tuple(a.shape)} vs {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    ua, ub = a.long() & 0xFFFFFFFF, b.long() & 0xFFFFFFFF
    return int((ua - ub).abs().max())


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds per call of ``fn`` over ``iters`` back-to-back
    calls, from CUDA events: the stream's time, which includes the host's
    launch path wherever that is longer than the device's work."""
    for _ in range(warmup):
        fn()
    sync()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) / iters


def card_profile(fn, what: str):
    """``fn()`` under ``torch.profiler``: the profiler of the first of
    PROFILE_TRIES sessions that recorded a kernel on the card, or None.
    A CUPTI trace can come back empty; the device times read from it are
    reported and never checked, so an empty trace leaves them "not
    measured" (None) instead of failing the run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            sync()
        if any(e.device_type == DeviceType.CUDA for e in prof.events()):
            return prof
    print(f"{what}: torch.profiler recorded no kernel on the card in "
          f"{PROFILE_TRIES} sessions; its device time is not measured",
          file=sys.stderr, flush=True)
    return None


def device_ms(fn, iters: int, what: str) -> "float | None":
    """Mean milliseconds per call that the card spends in kernels (all the
    kernels ``fn`` launches), from ``torch.profiler``; None when no
    session recorded a kernel."""
    def calls():
        for _ in range(iters):
            fn()

    prof = card_profile(calls, what)
    if prof is None:
        return None
    return sum(e.self_device_time_total for e in prof.key_averages()) / iters / 1e3


# -- phase 2: every kernel against its plain version ----------------------------

def kind_cases(gen: torch.Generator):
    """(kind, refs, n_refs) for every read kind, parity with 1..8 refs."""
    cases = [(k, refs, len(refs)) for k, refs in KIND_REFS.items()]
    for n in range(1, 9):
        refs = torch.sort(torch.rand(n, generator=gen, device="cuda") * 6 - 1).values
        cases.append(("parity", [float(r) for r in refs.cpu()], n))
    return cases


def random_words(gen: torch.Generator, shape) -> torch.Tensor:
    """int32 words over the full 32-bit range (half with bit 31 set)."""
    return torch.randint(-2 ** 31, 2 ** 31, shape, generator=gen,
                         device="cuda", dtype=torch.int64).to(torch.int32)


def check_kernels(gen: torch.Generator) -> dict:
    from repro_torch.kernels import bitops, fused, mlc_sense, popcount

    errs = {name: 0 for name in KERNELS}
    cases = kind_cases(gen)
    for rows in (5, 8):
        vth = torch.randn(rows, COLS, generator=gen, device="cuda") * 2 + 2
        stack = torch.randn(3, rows, COLS, generator=gen, device="cuda") * 2 + 2
        mask = random_words(gen, (rows, COLS // 32))
        for kind, refs, n_refs in cases:
            for invert in (False, True):
                got = mlc_sense.mlc_sense(vth, refs, kind=kind, invert=invert,
                                          n_refs=n_refs)
                want = mlc_sense.reference(vth, refs, kind, invert, n_refs)
                errs["mlc_sense"] = max(errs["mlc_sense"], word_err(got, want))
            for op in ("and", "or", "xor"):
                for sense_invert in (False, True):
                    for invert in (False, True):
                        got = fused.sense_reduce(
                            stack, refs, kind=kind, sense_invert=sense_invert,
                            op=op, invert=invert, n_refs=n_refs)
                        want = fused.reference(stack, refs, kind, sense_invert,
                                               op, invert, n_refs)
                        errs["sense_reduce"] = max(errs["sense_reduce"],
                                                   word_err(got, want))
                        got = fused.sense_reduce_popcount(
                            stack, refs, mask, kind=kind,
                            sense_invert=sense_invert, op=op, invert=invert,
                            n_refs=n_refs)
                        want = fused.reference_popcount(
                            stack, refs, mask, kind, sense_invert, op, invert,
                            n_refs)
                        errs["sense_reduce_popcount"] = max(
                            errs["sense_reduce_popcount"], word_err(got, want))
        for n in (1, 2, 3, 8):
            words = random_words(gen, (n, rows, COLS // 32))
            for op in ("and", "or", "xor"):
                for invert in (False, True):
                    got = bitops.bitwise_reduce(words, op=op, invert=invert)
                    want = bitops.reference(words, op, invert)
                    errs["bitwise_reduce"] = max(errs["bitwise_reduce"],
                                                 word_err(got, want))
    for shape in ((1, COLS // 32), (5, COLS // 32), (8, 130), (3, 2 * 1024 * 1024)):
        words = random_words(gen, shape)
        words[0, : min(shape[1], 7)] = -1                 # all-ones words
        errs["popcount_rows"] = max(errs["popcount_rows"], word_err(
            popcount.popcount_rows(words), popcount.reference(words)))
    sync()
    bad = {k: v for k, v in errs.items() if v}
    if bad:
        fail(f"kernels disagree with their plain versions: {bad}")
    return errs


def time_kernels(gen: torch.Generator, errs: dict, fused_n: int,
                 rows: int) -> dict:
    """Each kernel against its plain version, bit for bit, then both timed,
    at the main path's shapes: a sense group of ``rows`` pages, a
    ``fused_n``-operand fused chain over them, and a two-operand combine /
    root popcount of ``rows`` pages of words.  Folds the differences into
    ``errs``."""
    from repro_torch.kernels import bitops, fused, mlc_sense, popcount

    words = rows * COLS // 32
    vth = torch.randn(rows, COLS, generator=gen, device="cuda") * 2 + 2
    stack = torch.randn(fused_n, rows, COLS, generator=gen, device="cuda") * 2 + 2
    mask = torch.full((rows, COLS // 32), -1, dtype=torch.int32, device="cuda")
    pair = random_words(gen, (2, 1, words))
    flat = random_words(gen, (1, words))
    lsb = KIND_REFS["lsb"]
    cell_bytes = 4 + 1 / 8
    plan = {
        "mlc_sense": (
            lambda: mlc_sense.mlc_sense(vth, lsb, kind="lsb", n_refs=1),
            lambda: mlc_sense.reference(vth, lsb, "lsb", False, 1),
            None, rows * COLS * cell_bytes,
            rows * COLS * KIND_COMPARES["lsb"], 20),
        "sense_reduce": (
            lambda: fused.sense_reduce(stack, lsb, kind="lsb", sense_invert=False,
                                       op="and", n_refs=1),
            lambda: fused.reference(stack, lsb, "lsb", False, "and", False, 1),
            None, fused_n * rows * COLS * 4 + rows * COLS / 8,
            fused_n * rows * COLS * 2, 5),
        "sense_reduce_popcount": (
            lambda: fused.sense_reduce_popcount(stack, lsb, mask, kind="lsb",
                                                sense_invert=False, op="and",
                                                n_refs=1),
            lambda: fused.reference_popcount(stack, lsb, mask, "lsb", False,
                                             "and", False, 1),
            None, fused_n * rows * COLS * 4 + rows * COLS / 8 + rows * 4,
            fused_n * rows * COLS * 2 + rows * COLS, 5),
        "bitwise_reduce": (
            lambda: bitops.bitwise_reduce(pair, op="or"),
            lambda: bitops.reference(pair, "or", False),
            lambda: torch.bitwise_or(pair[0], pair[1]),
            3 * words * 4, words, 50),
        "popcount_rows": (
            lambda: popcount.popcount_rows(flat),
            lambda: popcount.reference(flat),
            None, words * 4 + 4, words * 2, 50),
    }
    out = {}
    for name, (kernel, plain, library, n_bytes, n_ops, iters) in plan.items():
        err = word_err(kernel(), plain())
        if library is not None:
            err = max(err, word_err(kernel(), library()))
        sync()
        if err:
            fail(f"{name} disagrees with its plain version at the main "
                 f"path's shape: max word difference {err}")
        errs[name] = max(errs[name], err)
        bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        ops_ms = n_ops / FP32_OPS_PER_S * 1e3
        plain_iters = max(2, iters // 5)
        out[name] = {
            "ms": time_ms(kernel, iters),
            "plain_ms": time_ms(plain, plain_iters, warmup=1),
            "library_ms": (time_ms(library, iters) if library is not None
                           else None),
            "device_ms": device_ms(kernel, iters, name),
            "plain_device_ms": device_ms(plain, plain_iters, f"{name} plain"),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": n_bytes,
        }
        torch.cuda.empty_cache()
    return out


# -- phase 3: the main path -------------------------------------------------------

def oracle(op: str, a: np.ndarray, b: np.ndarray | None = None) -> np.ndarray:
    if op == "not":
        return ~a
    return {"and": a & b, "or": a | b, "xor": a ^ b, "xnor": ~(a ^ b),
            "nand": ~(a & b), "nor": ~(a | b)}[op]


def host_bits(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().astype(bool)


def expect(got: torch.Tensor, want: np.ndarray, what: str,
           words: "dict | None" = None) -> None:
    """``got`` must equal the numpy oracle bit for bit; with ``words``,
    its bits are kept there (packed) under ``what``."""
    got = host_bits(got)
    if got.shape != want.shape or not np.array_equal(got, want):
        bad = int((got != want).sum()) if got.shape == want.shape else -1
        fail(f"{what}: {bad} bits differ from the numpy oracle")
    if words is not None:
        words[what] = np.packbits(got)


def table1(sess, encoding: str, gen: torch.Generator,
           words: "dict | None" = None) -> int:
    """The seven Table-1 ops (and the TLC 3-operand fast paths) under one
    encoding, each materialized and counted; returns the checks made."""
    p = f"{encoding}_"
    raw = (torch.rand(3, TABLE1_BITS, generator=gen, device=sess.torch_device)
           < 0.5).to(torch.uint8)
    a_np, b_np, c_np = (host_bits(r) for r in raw)
    if encoding == "tlc":
        a, b, c = sess.write_triple(p + "a", raw[0], p + "b", raw[1],
                                    p + "c", raw[2])
    else:
        a, b = sess.write_pair(p + "a", raw[0], p + "b", raw[1])
        c = sess.write(p + "c", raw[2])
    exprs = {"and": a & b, "or": a | b, "xor": a ^ b, "xnor": a.xnor(b),
             "nand": a.nand(b), "nor": a.nor(b), "not": ~b}
    checks = 0
    for op, expr in exprs.items():
        want = oracle(op, a_np, b_np) if op != "not" else ~b_np
        expect(sess.materialize(expr, unpacked=True), want, f"{encoding} {op}",
               words)
        if sess.popcount(expr) != int(want.sum()):
            fail(f"{encoding} {op} popcount")
        checks += 2
    extra = {"and-scattered": (a & c, a_np & c_np)}
    if encoding == "tlc":
        extra = {"and3": (a & b & c, a_np & b_np & c_np),
                 "or3": (a | b | c, a_np | b_np | c_np)}
    for name, (expr, want) in extra.items():
        expect(sess.materialize(expr, unpacked=True), want, f"{encoding} {name}",
               words)
        if sess.popcount(expr) != int(want.sum()):
            fail(f"{encoding} {name} popcount")
        checks += 2
    return checks


def bitmap_index(sess, gen: torch.Generator,
                 words: "dict | None" = None) -> dict:
    """Fig-10 bitmap index: AND over 30 daily activity bitmaps, 2**25 users."""
    days = (torch.rand(BITMAP_DAYS, BITMAP_USERS, generator=gen,
                       device=sess.torch_device) < 0.9).to(torch.uint8)
    vecs = []
    for d in range(0, BITMAP_DAYS, 2):
        vecs.extend(sess.write_pair(f"day{d}", days[d], f"day{d + 1}", days[d + 1]))
    host = days.cpu().numpy().astype(bool)
    want = np.logical_and.reduce(host, axis=0)
    expr = sess.chain("and", vecs)
    expect(sess.materialize(expr, unpacked=True), want, "bitmap AND of 30",
           words)
    count = sess.popcount(expr)
    if count != int(want.sum()):
        fail(f"bitmap popcount {count} != {int(want.sum())}")
    pair_want = host[0] & host[1]
    if sess.popcount(vecs[0] & vecs[1]) != int(pair_want.sum()):
        fail("day0 & day1 popcount")
    mixed = (vecs[0] & vecs[1]) | (vecs[2] ^ vecs[3])
    expect(sess.materialize(mixed, unpacked=True),
           pair_want | (host[2] ^ host[3]), "(d0 & d1) | (d2 ^ d3)", words)
    return {"users": BITMAP_USERS, "days": BITMAP_DAYS,
            "active_all_month": count, "checks": 4}


def image_encryption(sess, gen: torch.Generator) -> int:
    """Bulk XOR of one image's 24 bitplanes with a key (Fig 10)."""
    raw = (torch.rand(2, IMAGE_BITS, generator=gen, device=sess.torch_device)
           < 0.5).to(torch.uint8)
    img, key = sess.write_pair("image", raw[0], "key", raw[1])
    host = raw.cpu().numpy().astype(bool)
    expect(sess.materialize(img ^ key, unpacked=True), host[0] ^ host[1],
           "image XOR key")
    return 1


def main_path(device: str = "cuda", config=None, seed: int = 0) -> dict:
    """The compute-session main path; returns phase times and stats."""
    from repro_torch.api.session import ComputeSession

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    phases, checks = {}, 0
    t0 = time.perf_counter()
    sess = ComputeSession(device=device, config=config, seed=seed)
    for encoding in ("mlc", "tlc", "reduced-mlc"):
        s = sess if encoding == "mlc" else ComputeSession(
            flash=sess.device, encoding=encoding)
        t = time.perf_counter()
        checks += table1(s, encoding, gen)
        if device == "cuda":
            sync()
        phases[f"table1_{encoding}_s"] = time.perf_counter() - t
    t = time.perf_counter()
    bitmap = bitmap_index(sess, gen)
    if device == "cuda":
        sync()
    phases["bitmap_index_s"] = time.perf_counter() - t
    t = time.perf_counter()
    checks += bitmap["checks"] + image_encryption(sess, gen)
    if device == "cuda":
        sync()
    phases["image_encryption_s"] = time.perf_counter() - t
    phases["main_path_s"] = time.perf_counter() - t0
    stats = sess.stats()
    return {"phases": phases, "checks": checks, "bitmap": bitmap,
            "stats": {k: stats[k] for k in (
                "backend", "device", "sense_items", "sense_batches",
                "sense_waves", "megakernel_calls", "in_flash_senses",
                "executor", "plan_cache", "arena_shards")},
            "makespan_us": sess.ledger.makespan_us()}


# -- phases 4 and 5: serving and recovery -------------------------------------

def lane_major_words(bits: np.ndarray) -> np.ndarray:
    """{0,1} bits -> uint32 words in the packed layout, in numpy: word ``w``
    of each 4096-cell tile holds bit ``k`` from column ``k * 128 + w``."""
    tiles = np.ascontiguousarray(bits.reshape(-1, 32, 128).transpose(0, 2, 1))
    return np.packbits(tiles, axis=-1, bitorder="little").view("<u4").reshape(-1)


def word_popcount(words: np.ndarray) -> int:
    return int(np.unpackbits(words.view(np.uint8)).sum())


#: backend method -> the kernel its call launches
BACKEND_KERNELS = {"sense": "mlc_sense", "sense_reduce": "sense_reduce",
                   "sense_reduce_popcount": "sense_reduce_popcount",
                   "reduce": "bitwise_reduce", "popcount": "popcount_rows"}


@dataclasses.dataclass
class Recording:
    #: ``(kernel, plan or None) -> (args, kwargs, output)`` of the first call
    #: of each kernel at each read plan
    calls: dict = dataclasses.field(default_factory=dict)
    #: kernel -> calls made (each call is one launch on the card)
    counts: dict = dataclasses.field(
        default_factory=lambda: dict.fromkeys(KERNELS, 0))
    #: kernel -> the CUDA streams its calls were issued on (on a card)
    streams: dict = dataclasses.field(
        default_factory=lambda: {k: set() for k in KERNELS})


@contextlib.contextmanager
def recording(backend):
    """While the block runs, keep the inputs and output of the first call of
    each kernel at each read plan that ``backend`` makes, count every call
    per kernel and note the current CUDA stream of each (a
    :class:`Recording`)."""
    from repro_torch.core.mcflash import ReadPlan

    rec = Recording()

    def wrap(method: str, name: str):
        real = getattr(backend, method)

        def call(*args, **kwargs):
            out = real(*args, **kwargs)
            plan = next((a for a in args if isinstance(a, ReadPlan)), None)
            rec.counts[name] += 1
            if out.device.type == "cuda":
                rec.streams[name].add(torch.cuda.current_stream().cuda_stream)
            if (name, plan) not in rec.calls:
                rec.calls[name, plan] = (args, kwargs, out.clone())
            return out
        return call

    for method, name in BACKEND_KERNELS.items():
        setattr(backend, method, wrap(method, name))
    try:
        yield rec
    finally:
        for method in BACKEND_KERNELS:
            delattr(backend, method)        # the class's methods again


def hold_recorded(calls: dict) -> dict:
    """Each recorded call's output against its kernel's plain version on the
    same inputs.  Returns the largest word difference per kernel."""
    from repro_torch.kernels import bitops, fused, mlc_sense, popcount

    def parts(plan):
        return list(plan.refs), plan.kind, plan.uses_inverse, len(plan.refs)

    def sense(vth, plan):
        refs, kind, inv, n = parts(plan)
        return mlc_sense.reference(vth, refs, kind, inv, n)

    def sense_reduce(vth, plan, *, op, invert=False):
        refs, kind, inv, n = parts(plan)
        return fused.reference(vth, refs, kind, inv, op, invert, n)

    def sense_reduce_popcount(vth, plan, mask, *, op, invert=False):
        refs, kind, inv, n = parts(plan)
        return fused.reference_popcount(vth, refs, mask, kind, inv, op,
                                        invert, n)

    plain = {"mlc_sense": sense, "sense_reduce": sense_reduce,
             "sense_reduce_popcount": sense_reduce_popcount,
             "bitwise_reduce": lambda stack, op, invert=False:
                 bitops.reference(stack, op, invert),
             "popcount_rows": popcount.reference}
    out: dict = {}
    for (name, _), (args, kwargs, got) in calls.items():
        out[name] = max(out.get(name, 0),
                        word_err(got, plain[name](*args, **kwargs)))
    sync()
    return out


def fold_errs(errs: dict, checked: dict, launches: dict, phase: str) -> None:
    unchecked = [k for k, n in launches.items() if n and k not in checked]
    if unchecked:
        fail(f"{phase}: launched {unchecked} but recorded no call of them")
    bad = {k: v for k, v in checked.items() if v}
    if bad:
        fail(f"{phase}: kernels disagree with their plain versions at the "
             f"phase's shapes and references: {bad}")
    for name, err in checked.items():
        errs[name] = max(errs[name], err)


def require_launches(launches: dict, names, phase: str) -> None:
    idle = [k for k in names if launches[k] == 0]
    if idle:
        fail(f"{phase} never launched {idle}")


def serve_workload(sess, gen: torch.Generator, column_bits: int):
    """The request mix of ``benchmarks/serve_latency.py:_workload`` over 32
    column bitmaps: returns (exprs, popcounts, oracles), the oracles as
    numpy words (or counts)."""
    rng = np.random.default_rng(11)
    dies = sess.device.config.dies
    words, vecs = {}, {}
    for i in range(SERVE_COLUMNS // 2):
        raw = (torch.rand(2, column_bits, generator=gen,
                          device=sess.torch_device) < 0.5).to(torch.uint8)
        a, b = f"col{2 * i}", f"col{2 * i + 1}"
        vecs[a], vecs[b] = sess.write_pair(a, raw[0], b, raw[1], die=i % dies)
        host = raw.cpu().numpy()
        words[a], words[b] = lane_major_words(host[0]), lane_major_words(host[1])

    def pick(k: int):
        return list(rng.choice(sorted(vecs), size=k, replace=False))

    exprs, pcs, oracles = [], [], []
    for i in range(SERVE_REQUESTS):
        kind = i % 4
        if kind in (0, 1):
            op = ("and", "xor")[kind]
            a, b = pick(2)
            exprs.append(vecs[a]._binary(op, vecs[b]))
            oracles.append(words[a] & words[b] if op == "and"
                           else words[a] ^ words[b])
        elif kind == 2:
            a, b, c = pick(3)
            exprs.append(sess.chain("or", [vecs[a], vecs[b], vecs[c]]))
            oracles.append(words[a] | words[b] | words[c])
        else:
            a, b = pick(2)
            exprs.append(vecs[a] & vecs[b])
            oracles.append(word_popcount(words[a] & words[b]))
        pcs.append(kind == 3)
    return exprs, pcs, oracles


def serving_phase(gen: torch.Generator, errs: dict, gpu: str,
                  device: str = "cuda", config=None,
                  column_bits: int = BITMAP_USERS) -> dict:
    from repro_torch.api.session import ComputeSession
    from repro_torch.kernels import cuda
    from repro_torch.serve import QueryEngine

    t0 = time.perf_counter()
    sess = ComputeSession(device, config=config, trace=True)
    exprs, pcs, oracles = serve_workload(sess, gen, column_bits)
    sync()
    write_s = time.perf_counter() - t0
    t = time.perf_counter()
    solo_waves = sum(len(sess.lower(e).waves) for e in exprs)
    lower_s = time.perf_counter() - t
    sess.reset_stats()
    sess.trace.clear()
    cuda.reset_launches()
    t = time.perf_counter()
    eng = QueryEngine(sess)
    tickets = []
    with recording(sess.backend) as rec:
        for expr, pc in zip(exprs, pcs):
            tickets.append(eng.submit(expr, popcount=pc))
            eng.poll()
        results = eng.drain(tickets)
        sync()
    serve_s = time.perf_counter() - t
    launches = dict(cuda.launches)
    for ticket, got, want in zip(tickets, results, oracles):
        if ticket.popcount:
            if got != want:
                fail(f"served request {ticket.rid}: count {got} != {want}")
        elif got.dtype != np.uint32 or not np.array_equal(got, want):
            fail(f"served request {ticket.rid}: words differ from the numpy "
                 "oracle")
    st = eng.stats()
    if st["requests_completed"] != SERVE_REQUESTS:
        fail(f"served {st['requests_completed']} of {SERVE_REQUESTS}")
    if not (st["sense_waves"] < solo_waves and st["waves_shared"] >= 1
            and st["coalesced_sense_groups"] >= 1):
        fail(f"no cross-request coalescing: {st}, solo waves {solo_waves}")
    lat = sorted(s.dur_us for s in sess.trace.wall_spans
                 if s.category == "serve")
    if len(lat) != SERVE_REQUESTS:
        fail(f"{len(lat)} request spans for {SERVE_REQUESTS} requests")
    p50 = lat[len(lat) // 2]
    p99 = lat[min(len(lat) - 1, int(len(lat) * 0.99))]
    checked = hold_recorded(rec.calls)
    del rec
    fold_errs(errs, checked, launches, "serving")
    require_launches(launches, ("mlc_sense", "bitwise_reduce",
                                "popcount_rows"), "serving")
    out = {"requests": SERVE_REQUESTS, "batches": st["batches_dispatched"],
           "solo_waves": solo_waves, "batched_waves": st["sense_waves"],
           "waves_shared": st["waves_shared"],
           "coalesced_sense_groups": st["coalesced_sense_groups"],
           "p50_ms": p50 / 1e3, "p99_ms": p99 / 1e3,
           "write_s": write_s, "solo_lowering_s": lower_s,
           "serve_s": serve_s, "seconds": time.perf_counter() - t0,
           "launches": launches, "kernel_checks": sorted(checked),
           "megakernel_calls": sess.megakernel_calls,
           "makespan_us": sess.ledger.makespan_us()}
    print(f"serving ({gpu}): {SERVE_REQUESTS} requests over "
          f"{SERVE_COLUMNS} columns of {column_bits} bits in "
          f"{out['batches']} batches, "
          f"all bit-exact; waves solo {solo_waves} vs batched "
          f"{out['batched_waves']}, waves_shared {out['waves_shared']}, "
          f"coalesced_sense_groups {out['coalesced_sense_groups']}; "
          f"admit->result p50 {out['p50_ms']:.3f} ms, p99 "
          f"{out['p99_ms']:.3f} ms (tracer request spans); serve "
          f"{serve_s:.2f} s, phase {out['seconds']:.2f} s; launches "
          + json.dumps(launches), flush=True)
    return out


def _recovery_work(sess, raw) -> dict:
    """Three pairs, the first (a0, b0) on die 0 over the dead block."""
    vec = {}
    for i in range(3):
        vec[f"a{i}"], vec[f"b{i}"] = sess.write_pair(
            f"a{i}", raw[2 * i], f"b{i}", raw[2 * i + 1], die=i)
    return vec


def _recovery_exprs(sess, vec, host):
    """(label, expr, numpy oracle) of the phase: a fused chain under a
    controller combine, then the Table-1 ops on the first pair."""
    a0, b0, a1, b1, a2, b2 = (vec[k] for k in ("a0", "b0", "a1", "b1",
                                               "a2", "b2"))
    x, y = host[0], host[1]
    return [
        ("chain|xor", sess.chain("and", [a0, b0, a1, b1]) | (a2 ^ b2),
         (x & y & host[2] & host[3]) | (host[4] ^ host[5])),
        ("and", a0 & b0, x & y), ("or", a0 | b0, x | y),
        ("xor", a0 ^ b0, x ^ y), ("nand", a0.nand(b0), ~(x & y)),
        ("nor", a0.nor(b0), ~(x | y)), ("xnor", a0.xnor(b0), ~(x ^ y)),
        ("not", ~b0, ~y),
    ]


def recovery_phase(gen: torch.Generator, errs: dict, gpu: str,
                   device: str = "cuda", config=None,
                   operand_bits: int = TABLE1_BITS) -> dict:
    from repro_torch.api.session import ComputeSession
    from repro_torch.core.calibration import shift_plan
    from repro_torch.kernels import cuda
    from repro_torch.reliability import BlockRetiredError

    t0 = time.perf_counter()
    out: dict = {"encodings": {}}
    launches = {k: 0 for k in cuda.launches}
    for encoding in ("mlc", "reduced-mlc"):
        t = time.perf_counter()
        faults = {"pe": FAULT_PE, "seed": 1, "dead_blocks": (DEAD_BLOCK,)}
        raw = (torch.rand(6, operand_bits, generator=gen, device=device)
               < 0.5).to(torch.uint8)
        host = raw.cpu().numpy().astype(bool)
        # the same writes with recovery off: the raw bit errors
        control = ComputeSession(device, config=config, encoding=encoding,
                                 faults=faults, recovery="off", seed=5)
        cvec = _recovery_work(control, raw)
        raw_errors = raw_bits = 0
        for _, expr, want in _recovery_exprs(control, cvec, host):
            got = host_bits(control.materialize(expr, unpacked=True))
            raw_errors += int(np.count_nonzero(got != want))
            raw_bits += want.size
        del control, cvec

        sess = ComputeSession(device, config=config, encoding=encoding,
                              faults=faults, seed=5)
        vec = _recovery_work(sess, raw)
        if (DEAD_BLOCK + (0,)) not in sess.ftl.vectors["a0"].pages:
            fail("the dead block holds none of the first pair's pages")
        exprs = _recovery_exprs(sess, vec, host)
        cuda.reset_launches()
        with recording(sess.backend) as rec:
            try:
                sess.materialize(exprs[0][1])
            except BlockRetiredError as exc:
                retired = exc.blocks
            else:
                fail(f"{encoding}: data over a dead block read back clean")
            if DEAD_BLOCK not in retired:
                fail(f"{encoding}: retired {retired}, not the dead block")
            detected = sess.reliability.incidents[0]["mismatches"]
            # the data in a dead block is lost: rewrite the pair from the host
            sess.write_pair("a0", raw[0], "b0", raw[1], die=0)
            exprs = _recovery_exprs(sess, {k: sess[k] for k in vec}, host)
            checks = 0
            for label, expr, want in exprs:
                expect(sess.materialize(expr, unpacked=True), want,
                       f"{encoding} {label} after recovery")
                if sess.popcount(expr) != int(want.sum()):
                    fail(f"{encoding} {label} popcount after recovery")
                checks += 2
            # retention aging on top of 10k-P/E wear, after the ladder: the
            # bit errors left are measured, not gated (the JAX package
            # leaves the same sparse errors, unseen by the sampled check, on
            # the same cells: tests/test_torch_reliability.py::
            # test_dead_block_retires_then_rewrite_reads_clean)
            rel = sess.stats()["reliability"]
            ladder_us = dict(sess.ledger.category_us)
            before = rel["retries"]
            sess.device.age(AGE_HOURS)
            aged_errors = aged_bits = 0
            for label, expr, want in exprs:
                got = host_bits(sess.materialize(expr, unpacked=True))
                aged_errors += int(np.count_nonzero(got != want))
                aged_bits += want.size
            aged = sess.stats()["reliability"]["retries"]
            sync()
        phase_launches = dict(cuda.launches)
        for k, n in phase_launches.items():
            launches[k] += n
        # the ladder's first retry shifts every reference by ``dv``
        dv = sess.reliability.policy.ladder_offsets()[0]
        shifted = sorted({name for name, p in rec.calls if p is not None
                          and (name, shift_plan(p, dv)) in rec.calls})
        if not shifted:
            fail(f"recovery {encoding}: no kernel call at the ladder's "
                 f"first offset {dv:+.3f} V was recorded")
        checked = hold_recorded(rec.calls)
        del rec
        fold_errs(errs, checked, phase_launches, f"recovery {encoding}")
        out["encodings"][encoding] = {
            "raw_bit_errors": raw_errors, "raw_bits": raw_bits,
            "detected_sample_mismatches": detected,
            "retired_blocks": [list(b) for b in retired], "checks": checks,
            "retries": rel["retries"],
            "recalibrations": rel["recalibrations"],
            "migrations": rel["migrations"],
            "retired": rel["retired_blocks"], "ref_trim": rel["ref_trim"],
            "recovery_us": ladder_us.get("recovery", 0.0),
            "migration_us": ladder_us.get("migration", 0.0),
            "kernel_checks": sorted(checked), "shifted_checks": shifted,
            "kernel_checks_dv": dv,
            "aging": {"hours": AGE_HOURS, "retries_before": before,
                      "retries_after": aged, "bit_errors": aged_errors,
                      "bits": aged_bits},
            "seconds": time.perf_counter() - t}
        del sess, vec, exprs
    require_launches(launches, ("mlc_sense", "sense_reduce", "bitwise_reduce",
                                "popcount_rows"), "recovery")
    out["launches"] = launches

    # retention aging as tests/test_reliability.py:306 checks it (5k P/E,
    # one written pair, recovery on): under mlc, where the JAX package makes
    # the claim, bit-exact before and after and retries no fewer after; tlc
    # and reduced-mlc run the same way and report their bit errors
    cuda.reset_launches()
    out["aging"] = {}
    for encoding in ("mlc", "tlc", "reduced-mlc"):
        sess = ComputeSession(device, config=config, encoding=encoding,
                              faults={"pe": AGE_PE, "seed": 9}, seed=21)
        raw = (torch.rand(2, operand_bits, generator=gen, device=device)
               < 0.5).to(torch.uint8)
        x, y = host_bits(raw[0]), host_bits(raw[1])
        a, b = sess.write_pair("a", raw[0], "b", raw[1])
        checks = [(a ^ b, x ^ y), (a & b, x & y), (a | b, x | y), (~b, ~y)]

        def wrong_bits() -> int:
            return sum(int(np.count_nonzero(
                host_bits(sess.materialize(expr, unpacked=True)) != want))
                for expr, want in checks)

        start = dict(cuda.launches)
        with recording(sess.backend) as rec:
            wrong = {"before": wrong_bits()}
            before = sess.stats()["reliability"]["retries"]
            sess.device.age(AGE_HOURS)
            wrong["after"] = wrong_bits()
            aged = sess.stats()["reliability"]["retries"]
            sync()
        if encoding == "mlc" and (any(wrong.values()) or aged < before):
            fail(f"aging mlc: bit errors {wrong}, retries {before} -> {aged}")
        out["aging"][encoding] = {"retries_before": before,
                                  "retries_after": aged,
                                  "bit_errors": wrong,
                                  "bits": len(checks) * operand_bits,
                                  "gated": encoding == "mlc"}
        fold_errs(errs, hold_recorded(rec.calls),
                  {k: n - start[k] for k, n in cuda.launches.items()},
                  f"aging {encoding}")
        del sess, rec
    for k, n in cuda.launches.items():
        launches[k] += n

    # reduced-MLC's raw error rate at 10k P/E (no dead block, recovery off)
    t = time.perf_counter()
    errors = bits = 0
    for seed in range(RATE_SEEDS):
        sess = ComputeSession(device, config=config, encoding="reduced-mlc",
                              recovery="off",
                              faults={"pe": FAULT_PE, "seed": seed},
                              seed=100 + seed)
        raw = (torch.rand(6, operand_bits, generator=gen, device=device)
               < 0.5).to(torch.uint8)
        host = raw.cpu().numpy().astype(bool)
        vec = _recovery_work(sess, raw)
        for _, expr, want in _recovery_exprs(sess, vec, host):
            got = host_bits(sess.materialize(expr, unpacked=True))
            errors += int(np.count_nonzero(got != want))
            bits += want.size
    out["reduced_mlc_rate"] = {"seeds": RATE_SEEDS, "bit_errors": errors,
                               "bits": bits, "rate": errors / bits,
                               "seconds": time.perf_counter() - t}
    out["seconds"] = time.perf_counter() - t0
    for enc, r in out["encodings"].items():
        print(f"recovery ({gpu}) {enc} at {FAULT_PE} P/E, dead block "
              f"{DEAD_BLOCK}: raw bit errors with recovery off "
              f"{r['raw_bit_errors']} of {r['raw_bits']}; detected "
              f"{r['detected_sample_mismatches']} sampled mismatches; ladder "
              f"retries {r['retries']}, recalibrations {r['recalibrations']}, "
              f"migrations {r['migrations']}, retired blocks {r['retired']} "
              f"(BlockRetiredError, pair rewritten); {r['checks']} checks "
              f"bit-exact after recovery; after age({AGE_HOURS:g} h) "
              f"{r['aging']['bit_errors']} bit errors in "
              f"{r['aging']['bits']} bits (rate "
              f"{r['aging']['bit_errors'] / r['aging']['bits']:.3e}), retries "
              f"{r['aging']['retries_before']} -> "
              f"{r['aging']['retries_after']}; {r['seconds']:.2f} s",
              flush=True)
        if r["aging"]["bit_errors"]:
            print(f"FINDING: {enc} at {FAULT_PE} P/E after the ladder and "
                  f"age({AGE_HOURS:g} h): {r['aging']['bit_errors']} of "
                  f"{r['aging']['bits']} bits wrong past the sampled "
                  "checkword (measured, not gated: ROADMAP R4)", flush=True)
    for enc, r in out["aging"].items():
        e = r["bit_errors"]
        print(f"aging ({gpu}) {enc} at {AGE_PE} P/E, {operand_bits}-bit "
              f"pair, 4 ops: bit errors {e['before']} before and "
              f"{e['after']} after age({AGE_HOURS:g} h) in {r['bits']} bits "
              f"each; retries {r['retries_before']} -> {r['retries_after']}"
              + ("; gated (tests/test_reliability.py:306)" if r["gated"]
                 else "; reported"), flush=True)
    rate = out["reduced_mlc_rate"]
    print(f"reduced-mlc raw error rate at {FAULT_PE} P/E over {RATE_SEEDS} "
          f"fault seeds ({gpu}): {rate['bit_errors']} bit errors in "
          f"{rate['bits']} bits = {rate['rate']:.3e}; recovery phase "
          f"{out['seconds']:.2f} s; launches " + json.dumps(launches),
          flush=True)
    return out


# -- phases 6 and 7: endurance and applications ---------------------------------

def hold_chunk(errs: dict, plan, op: str, lsb, msb, vth, backend) -> dict:
    """One RBER chunk's error count through the kernels (the harness's own
    ``chunk_errors``, each kernel call held against its plain version on
    the same inputs) and per cell (``execute_plan != expected_result``);
    the two must agree.  Folds each kernel's word difference into
    ``errs``."""
    from repro_torch.core import mcflash, rber

    with recording(backend) as rec:
        kernel = int(rber.chunk_errors(plan, op, vth, lsb, msb, backend))
    for name, err in hold_recorded(rec.calls).items():
        errs[name] = max(errs[name], err)
    per_cell = int(torch.count_nonzero(
        mcflash.execute_plan(plan, vth)
        != mcflash.expected_result(op, lsb, msb)))
    if kernel != per_cell:
        fail(f"endurance {op}: {kernel} errors through the kernels, "
             f"{per_cell} per cell")
    return {"kernel": kernel, "per_cell": per_cell, "bits": int(vth.numel())}


def endurance_phase(errs: dict, gpu: str, device: str = "cuda",
                    points=ENDURANCE_POINTS,
                    pages_per_chunk: int = PAGES_PER_CHUNK) -> dict:
    """RBER against endurance (Table 2, Fig 6): ``measure_rber`` for every
    op at every point, the claims of ``tests/test_rber.py`` held as rates,
    and one chunk per (op, point) counted through the kernels (each call
    held against its plain version) and per cell."""
    from repro_torch.api.backends import Backend
    from repro_torch.api.plan_cache import PlanCache
    from repro_torch.core import encoding, rber, vth_model
    from repro_torch.kernels import cuda

    chip = vth_model.get_chip_model()
    t0 = time.perf_counter()
    cuda.reset_launches()
    rates: dict = {}
    for label, pe, hours, pages in points:
        for op in encoding.ALL_OPS:
            t = time.perf_counter()
            r = rber.measure_rber(op, chip, pages=pages, n_pe=pe,
                                  retention_hours=hours, seed=ENDURANCE_SEED,
                                  pages_per_chunk=pages_per_chunk,
                                  device=device)
            sync()
            rates[label, op] = row = {
                "errors": r.errors, "bits": r.bits, "rate_pct": r.rber_pct,
                "upper95_pct": 300.0 / r.bits if r.errors == 0 else None,
                "seconds": time.perf_counter() - t}
            bound = (f", 95% upper bound {row['upper95_pct']:.3e}%"
                     if r.errors == 0 else "")
            print(f"endurance ({gpu}) {op:4s} @ {label}: {r.errors} errors "
                  f"in {r.bits} bits, RBER {r.rber_pct:.6f}%{bound}; "
                  f"{row['seconds']:.2f} s", flush=True)
    launches = dict(cuda.launches)
    run_s = time.perf_counter() - t0
    # one sense, one XOR and one popcount per chunk, nothing else
    chunks = len(encoding.ALL_OPS) * sum(-(-pages // pages_per_chunk)
                                         for *_, pages in points)
    counted = {"mlc_sense": chunks, "bitwise_reduce": chunks,
               "popcount_rows": chunks}
    if device == "cuda" and launches != {**dict.fromkeys(KERNELS, 0),
                                         **counted}:
        fail(f"endurance: launches {launches}, expected {counted}")

    backend, plans = Backend(torch.device(device)), PlanCache()
    held: dict = {}
    for label, pe, hours, pages in points:
        n_bits = min(pages, pages_per_chunk) * rber.PAGE_BITS
        for op in encoding.ALL_OPS:
            lsb, msb, vth = rber.program_chunk(
                ENDURANCE_SEED, 0, op=op, chip=chip, n_bits=n_bits, n_pe=pe,
                retention_hours=hours, device=device)
            held[f"{op} @ {label}"] = hold_chunk(
                errs, plans.get(op, chip), op, lsb, msb, vth, backend)
            del lsb, msb, vth
    sync()
    bad = {k: errs[k] for k in ("mlc_sense", "bitwise_reduce",
                                "popcount_rows") if errs[k]}
    if bad:
        fail(f"endurance: kernels disagree with their plain versions: {bad}")

    def rate(label, op):
        return rates[label, op]["errors"] / rates[label, op]["bits"]

    worn, cycled, aged = "10k P/E", "1.5k P/E", "3k P/E + 1000 h"
    if not 0 < 100 * rate(cycled, "xnor") < 0.01:
        fail(f"endurance: xnor at 1.5k P/E has RBER "
             f"{100 * rate(cycled, 'xnor'):.6f}%, outside (0, 0.01%)")
    for op in ("and", "or", "xnor", "not"):
        if 100 * rate(worn, op) >= RBER_BOUND_PCT:
            fail(f"endurance: {op} at 10k P/E has RBER "
                 f"{100 * rate(worn, op):.6f}% >= {RBER_BOUND_PCT}%")
    if not rate(worn, "or") > rate(cycled, "or"):
        fail("endurance: OR is not worse at 10k P/E than at 1.5k P/E")
    if not rate(aged, "not") > rate(aged, "and"):
        fail("endurance: NOT is not worse than AND under retention")
    e = {op: rates[worn, op]["errors"] for op in ("and", "or", "xnor")}
    if not e["and"] <= e["or"] <= 2 * e["xnor"]:
        fail(f"endurance: and <= or <= 2 xnor fails at 10k P/E: {e}")
    fresh_errors = {op: rates["fresh", op]["errors"]
                    for op in encoding.ALL_OPS if rates["fresh", op]["errors"]}
    if fresh_errors:
        print(f"FINDING: fresh pages read with errors at "
              f"{rates['fresh', 'and']['bits']} bits per op: {fresh_errors}",
              flush=True)
    out = {"rates": {f"{op} @ {label}": v for (label, op), v in rates.items()},
           "held_chunks": held, "launches": launches, "run_s": run_s,
           "fresh_errors": fresh_errors,
           "seconds": time.perf_counter() - t0}
    print(f"endurance ({gpu}): bounds hold; one chunk per (op, point) "
          f"counted alike through the kernels (each call bit-exact against "
          f"its plain version) and per cell ({len(held)} chunks); measured "
          f"in {run_s:.2f} s, phase "
          f"{out['seconds']:.2f} s; launches " + json.dumps(launches),
          flush=True)
    return out


def _app_oracle(workload, n_bits: int, seed: int) -> np.ndarray:
    """The workload's result words in numpy, from the bits ``run_workload``
    draws for ``seed``."""
    rng = np.random.default_rng(seed)
    bits = [rng.random(n_bits) < 0.5 for _ in range(workload.k_operands)]
    fold = {"and": np.logical_and, "or": np.logical_or,
            "xor": np.logical_xor}[workload.op]
    return lane_major_words(fold.reduce(bits).astype(np.uint8))


def applications_phase(errs: dict, gpu: str, device: str = "cuda",
                       config=None, n_bits: int = APP_BITS,
                       filter_samples: int = FILTER_SAMPLES) -> dict:
    """The Fig-10 workloads through ``run_workload`` and a ``BitmapFilter``,
    each result held against numpy, every recorded kernel call against its
    plain version; kernel calls counted per kernel."""
    from repro_torch.api.hostio import to_numpy
    from repro_torch.api.session import ComputeSession
    from repro_torch.api.workloads import run_workload
    from repro_torch.data import BitmapFilter
    from repro_torch.flash import system
    from repro_torch.kernels import cuda

    t0 = time.perf_counter()
    cuda.reset_launches()
    calls = dict.fromkeys(KERNELS, 0)
    checked: dict = {}
    out: dict = {"workloads": {}}

    def fold(rec) -> None:
        for name, n in rec.counts.items():
            calls[name] += n
        for name, err in hold_recorded(rec.calls).items():
            checked[name] = max(checked.get(name, 0), err)

    workloads = (system.image_segmentation(), system.image_encryption(),
                 system.bitmap_index(1))
    for i, w in enumerate(workloads):
        seed = APP_SEED + i
        t = time.perf_counter()
        sess = ComputeSession(device, config=config, seed=seed)
        with recording(sess.backend) as rec:
            res = run_workload(w, session=sess, n_bits=n_bits, seed=seed)
            sync()
        wall = time.perf_counter() - t
        got = to_numpy(res["result_packed"])
        if not np.array_equal(got, _app_oracle(w, n_bits, seed)):
            fail(f"{w.name}: result words differ from the numpy oracle")
        fold(rec)
        st = res["stats"]
        out["workloads"][w.name] = {
            "k": w.k_operands, "op": w.op, "bits_per_operand": n_bits,
            "wall_s": wall, "makespan_us": res["measured"]["makespan_us"],
            "commands": res["measured"]["commands"],
            "megakernel_calls": st["megakernel_calls"],
            "sense_waves": st["sense_waves"],
            "kernel_calls": dict(rec.counts),
            "speedup_vs": res["projection"]["speedup_vs"]}
        del sess, res, rec

    t = time.perf_counter()
    rng = np.random.default_rng(APP_SEED + len(workloads))
    maps = [(rng.random(filter_samples) < 0.9).astype(np.uint8)
            for _ in range(2 * FILTER_PAIRS)]
    sess = ComputeSession(device, config=config, seed=17)
    bf = BitmapFilter(filter_samples, session=sess)
    pairs = [(f"filter{j}", f"filter{j + 1}")
             for j in range(0, 2 * FILTER_PAIRS, 2)]
    with recording(sess.backend) as rec:
        for j, (a, b) in enumerate(pairs):
            bf.add_pair(a, maps[2 * j], b, maps[2 * j + 1])
        mask, count = bf.select(pairs), bf.count(pairs)
        sync()
    want = np.logical_and.reduce(maps).astype(bool)
    if not np.array_equal(mask, want) or count != int(want.sum()):
        fail("BitmapFilter: selection differs from the numpy oracle")
    fold(rec)
    out["bitmap_filter"] = {"samples": filter_samples, "pairs": FILTER_PAIRS,
                            "selected": count,
                            "wall_s": time.perf_counter() - t,
                            "kernel_calls": dict(rec.counts)}
    del sess, bf, rec
    launches = dict(cuda.launches)
    fold_errs(errs, checked, launches, "applications")
    if device == "cuda" and launches != calls:
        fail(f"applications: launches {launches} differ from the backend's "
             f"kernel calls {calls}")
    if calls != APPS_LAUNCHES:
        fail(f"applications: kernel calls {calls} differ from the CPU "
             f"rehearsal's {APPS_LAUNCHES}")
    out.update(launches=launches, kernel_calls=calls,
               kernel_checks=sorted(checked),
               seconds=time.perf_counter() - t0)
    for name, r in out["workloads"].items():
        proj = ", ".join(f"{p} {x:.2f}x" for p, x in r["speedup_vs"].items())
        print(f"applications ({gpu}) {name}: {r['k']} operands x {n_bits} "
              f"bits, {r['op']} chain bit-exact in {r['wall_s']:.2f} s, "
              f"simulated makespan {r['makespan_us']:.0f} us, kernel calls "
              f"{json.dumps(r['kernel_calls'])}; full-scale MCFlash speedup "
              f"vs {proj}", flush=True)
    bfo = out["bitmap_filter"]
    print(f"applications ({gpu}) BitmapFilter: {filter_samples} samples, "
          f"{FILTER_PAIRS} pairs, {bfo['selected']} selected, mask and count "
          f"bit-exact in {bfo['wall_s']:.2f} s; phase {out['seconds']:.2f} s; "
          "launches " + json.dumps(launches), flush=True)
    return out


# -- phase 8: the placed wave runner on per-shard streams --------------------------

def placed_session(shard_devices, device: str = "cuda", config=None,
                   seed: int = PLACED_SEED):
    """A session on a fresh device whose shards sit on ``shard_devices``
    (None: unplaced)."""
    from repro_torch.api.session import ComputeSession
    from repro_torch.flash.device import FlashDevice

    return ComputeSession(flash=FlashDevice(config=config, seed=seed,
                                            device=device,
                                            shard_devices=shard_devices))


def placed_workload(sess, seed: int = PLACED_SEED,
                    words: "dict | None" = None):
    """The main path's Table-1 ops under the three encodings and the
    30-operand bitmap index on ``sess``'s device, each result against
    numpy, then the die-parallel fold query over the bitmap's 15 pairs.
    Returns (seconds of the first two, the fold query)."""
    from repro_torch.api.session import ComputeSession

    device = sess.torch_device.type
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    t = time.perf_counter()
    for encoding in ("mlc", "tlc", "reduced-mlc"):
        s = sess if encoding == "mlc" else ComputeSession(
            flash=sess.device, encoding=encoding)
        table1(s, encoding, gen, words)
    state = gen.get_state()
    bitmap_index(sess, gen, words)
    if device == "cuda":
        sync()
    seconds = time.perf_counter() - t
    # the OR over the 15 day pairs, AND and XOR in turn: one pair per die,
    # and the two read plans keep the senses out of one fused pass, so the
    # plan is one wave of 15 die-disjoint sense groups, then a controller
    # combine.  Its oracle: the same day bitmaps again, from the
    # generator's state.
    redraw = torch.Generator(device=device)
    redraw.set_state(state)
    days = torch.rand(BITMAP_DAYS, BITMAP_USERS, generator=redraw,
                      device=device) < 0.9
    want = host_bits(torch.cat([days[0::4] & days[1::4],
                                days[2::4] ^ days[3::4]]).any(dim=0))
    del days
    query = fold_query(sess)
    expect(sess.materialize(query, unpacked=True), want,
           "fold of 15 pair ANDs / XORs", words)
    return seconds, query


def fold_query(sess):
    """OR over the bitmap's 15 day pairs, AND and XOR in turn."""
    pairs = [(sess.vector(f"day{d}"), sess.vector(f"day{d + 1}"))
             for d in range(0, BITMAP_DAYS, 2)]
    return sess.chain("or", [a & b if k % 2 == 0 else a ^ b
                             for k, (a, b) in enumerate(pairs)])


def time_query(sess, query, iters: int) -> float:
    """Seconds per materialize of ``query``: host clock around ``iters``
    calls, ending in a synchronize."""
    sess.materialize(query)
    sync()
    t = time.perf_counter()
    for _ in range(iters):
        sess.materialize(query)
    sync()
    return (time.perf_counter() - t) / iters


def kernel_overlap(fn, what: str) -> "dict | None":
    """One call of ``fn`` under ``torch.profiler``: the card's kernel time
    summed over kernels, the time in which any kernel ran (the union of
    their intervals), the share of kernel time that overlapped another
    kernel, and the streams the kernels ran on; None when no session
    recorded a kernel."""
    from torch.autograd import DeviceType

    fn()
    sync()
    prof = card_profile(fn, what)
    if prof is None:
        return None
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy = sum(end - start for start, end in spans)
    union, (lo, hi) = 0.0, spans[0]
    for start, end in spans[1:]:
        if start > hi:
            union, lo = union + hi - lo, start
        hi = max(hi, end)
    union += hi - lo
    return {"kernels": len(kernels), "kernel_ms": busy / 1e3,
            "union_ms": union / 1e3, "overlap_share": 1 - union / busy,
            "streams": len({e.device_resource_id for e in kernels})}


def placed_phase(errs: dict, gpu: str, device: str = "cuda", config=None,
                 pairs: int = PLACED_PAIRS, query_pairs: int = QUERY_PAIRS,
                 query_iters: int = QUERY_ITERS) -> dict:
    """``FlashDevice(shard_devices=[device] * 4)`` against the unplaced
    device on the same work: words equal each other and numpy, plan
    counters equal, the placed runner dispatched units on their shards'
    streams (at least two streams on a card), every recorded kernel call
    equals its plain version; then placed and unplaced timed in
    alternating pairs (the whole workload on fresh devices, and the fold
    query on the written ones)."""
    from repro_torch.kernels import cuda

    t0 = time.perf_counter()
    shards = [device] * PLACED_SHARDS
    ref_words: dict = {}
    plain = placed_session(None, device, config)
    placed_workload(plain, words=ref_words)
    placed = placed_session(shards, device, config)
    placed_words: dict = {}
    cuda.reset_launches()
    with recording(placed.backend) as rec:
        _, query = placed_workload(placed, words=placed_words)
        if device == "cuda":
            sync()
    launches = dict(cuda.launches)
    if placed_words.keys() != ref_words.keys() or any(
            not np.array_equal(placed_words[k], ref_words[k])
            for k in ref_words):
        fail("placed: words differ from the unplaced session's")
    if placed.placed_unit_dispatches <= 0 or plain.placed_unit_dispatches:
        fail(f"placed: placed_unit_dispatches {placed.placed_unit_dispatches}"
             f" (unplaced {plain.placed_unit_dispatches})")
    streams = {k: len(v) for k, v in rec.streams.items()}
    n_streams = len(set().union(*rec.streams.values()))
    if device == "cuda" and n_streams < 2:
        fail(f"placed: kernel calls on {n_streams} stream(s), want >= 2")
    checked = hold_recorded(rec.calls)
    del rec
    fold_errs(errs, checked, launches, "placed")
    counters = ("sense_items", "sense_batches", "sense_waves",
                "megakernel_calls")
    pst, ust = placed.stats(), plain.stats()
    if any(pst[k] != ust[k] for k in counters):
        fail("placed: plan counters differ from the unplaced run: "
             + json.dumps({k: [pst[k], ust[k]] for k in counters}))
    out = {"shards": len(shards), "checks": len(ref_words),
           "placed_unit_dispatches": placed.placed_unit_dispatches,
           "streams": n_streams, "streams_per_kernel": streams,
           "launches": launches, "kernel_checks": sorted(checked),
           **{k: pst[k] for k in counters}}
    plain_query = fold_query(plain)
    plan = placed.lower(query)
    if len(plan.waves[0].groups) != BITMAP_DAYS // 2:
        fail(f"placed: the fold's first wave holds {len(plan.waves[0].groups)}"
             " sense groups, not one per pair")
    if device == "cuda":
        out["fold_profile"] = {
            "placed": kernel_overlap(lambda: placed.materialize(query),
                                     "placed fold"),
            "unplaced": kernel_overlap(lambda: plain.materialize(plain_query),
                                       "unplaced fold")}
    query_s = {"placed": [], "unplaced": []}
    for i in range(query_pairs):
        order = (("placed", placed, query), ("unplaced", plain, plain_query))
        for name, sess, q in (order if i % 2 == 0 else order[::-1]):
            query_s[name].append(time_query(sess, q, query_iters))
    del placed, plain, query, plain_query
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    workload_s = {"placed": [], "unplaced": []}
    for i in range(pairs):
        order = (("placed", shards), ("unplaced", None))
        for name, sh in (order if i % 2 == 0 else order[::-1]):
            sess = placed_session(sh, device, config)
            workload_s[name].append(placed_workload(sess)[0])
            del sess
            gc.collect()
            if device == "cuda":
                torch.cuda.empty_cache()
    out.update(workload_s=workload_s, query_s=query_s,
               seconds=time.perf_counter() - t0)
    print(f"placed ({gpu}): shard_devices={shards}: {out['checks']} results "
          f"bit-exact and equal to the unplaced run's; "
          f"placed_unit_dispatches {out['placed_unit_dispatches']}, kernel "
          f"calls on {n_streams} streams {json.dumps(streams)}; launches "
          + json.dumps(launches), flush=True)
    print(f"placed vs unplaced ({gpu}), alternating pairs, seconds: workload "
          f"(Table-1 x 3 encodings + bitmap index, fresh devices) "
          + json.dumps(workload_s) + f"; fold of 15 pair ANDs / XORs over {BITMAP_USERS} bits"
          f" per materialize ({query_iters} each) " + json.dumps(query_s)
          + f"; phase {out['seconds']:.2f} s", flush=True)
    if "fold_profile" in out:
        print(f"placed vs unplaced ({gpu}), one fold materialize under "
              "torch.profiler: " + json.dumps(out["fold_profile"]),
              flush=True)
    return out


# -- phase 9: the LM serving path at full width --------------------------------------

def lm_times(prefill_fn, decode_fn, on_card: bool, what: str) -> dict:
    """CUDA-event time per call of a prefill and of a decode step, and the
    card's kernel time in each (``torch.profiler``): their ratio is the
    card's busy share of the call (None off the card, or where the
    profiler recorded no kernel)."""
    if not on_card:
        return dict.fromkeys(("prefill_ms", "prefill_device_ms", "decode_ms",
                              "decode_device_ms", "decode_busy_share"))
    prefill_ms, prefill_dev_ms = time_ms(prefill_fn, 5), device_ms(
        prefill_fn, 5, f"{what} prefill")
    decode_ms, decode_dev_ms = time_ms(decode_fn, 20), device_ms(
        decode_fn, 20, f"{what} decode")
    return {"prefill_ms": prefill_ms, "prefill_device_ms": prefill_dev_ms,
            "decode_ms": decode_ms, "decode_device_ms": decode_dev_ms,
            "decode_busy_share": (None if decode_dev_ms is None
                                  else decode_dev_ms / decode_ms)}


def lm_delta(params: dict, device: str, errs: dict, layer) -> dict:
    """The XOR delta of the whole tree ``params`` against a copy with one
    layer perturbed (``layer(tree)`` gives that layer's leaves and whether
    they are stacked, repeat 0 being the layer), applied back: bit-exact,
    ``bitwise_reduce`` launched once per leaf and direction, its recorded
    call equal to the plain version."""
    from repro_torch.checkpoint import delta as delta_mod
    from repro_torch.checkpoint import delta_apply, delta_encode, delta_sparsity
    from repro_torch.kernels import cuda
    from repro_torch.models.specs import flatten, tree_map

    on_card = device == "cuda"
    newer = tree_map(torch.clone, params)
    leaves, is_stacked = layer(newer)
    noise = torch.Generator(device=device)
    noise.manual_seed(LM_SEED + 2)
    touched = 0
    for path, leaf in flatten(leaves):
        row = leaf[0] if is_stacked else leaf          # repeat 0: one layer
        row.add_(torch.randn(row.shape, generator=noise, device=device)
                 * 1e-3)
        touched += row.numel()
    before = cuda.launches["bitwise_reduce"]
    t = time.perf_counter()
    with recording(delta_mod.BACKENDS[torch.device(device).type]) as rec:
        delta = delta_encode(params, newer)
        back = delta_apply(params, delta)
        if on_card:
            sync()
    delta_s = time.perf_counter() - t
    n_leaves = len(flatten(params))
    if on_card and cuda.launches["bitwise_reduce"] - before != 2 * n_leaves:
        fail("lm: the delta did not launch bitwise_reduce once per leaf and "
             "direction")
    if rec.counts["bitwise_reduce"] != 2 * n_leaves:
        fail(f"lm: {rec.counts['bitwise_reduce']} reduce calls for "
             f"{n_leaves} leaves")
    for (path, got), (_, want) in zip(flatten(back), flatten(newer)):
        if got.device != want.device or not torch.equal(
                got.reshape(-1).view(torch.int32),
                want.reshape(-1).view(torch.int32)):
            fail(f"lm: delta round trip of {path} is not bit-exact")
    for path, words in flatten(delta):
        if words.device.type != torch.device(device).type:
            fail(f"lm: delta leaf {path} left the device")
    checked = hold_recorded(rec.calls)
    fold_errs(errs, checked, dict(cuda.launches), "lm")
    return {"delta_s": delta_s, "delta_leaves": n_leaves,
            "perturbed_params": touched,
            "delta_zero_word_share": delta_sparsity(delta),
            "kernel_checks": sorted(checked)}


def lm_phase(errs: dict, gpu: str, device: str = "cuda", cfg=None,
             batch: int = LM_BATCH, prompt: int = LM_PROMPT,
             new: int = LM_NEW, max_seq: int = LM_MAX_SEQ,
             archs: "dict | None" = None) -> dict:
    """``Engine.from_seed`` at the arch's full width on the card: two greedy
    ``generate`` calls give equal tokens, the prompts come back unchanged,
    ``decode_calls`` counts ``new - 1`` per call, each decode step's logits
    equal a full prefill's over the same prefix within ``LM_TOL`` of the
    logits' scale; then the XOR delta of the whole parameter tree against a
    copy with one layer perturbed round-trips bit for bit through the
    ``bitwise_reduce`` kernel; then the ring-wrap run and the runs of
    ``archs`` (``LM_ARCHS``).  The kernel counts span all of them."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import cuda
    from repro_torch.models import lm
    from repro_torch.models.specs import count_params
    from repro_torch.serve import Engine, ServeConfig

    on_card = device == "cuda"
    if on_card:
        # float32 products in full float32 (the defaults, stated)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.reset_peak_memory_stats()
    cfg = cfg or get_config(LM_ARCH)
    t0 = time.perf_counter()
    cuda.reset_launches()
    eng = Engine.from_seed(cfg, seed=LM_SEED, device=device,
                           serve_cfg=ServeConfig(max_seq=max_seq))
    gen = torch.Generator(device=device)
    gen.manual_seed(LM_SEED + 1)
    prompts = torch.randint(1, cfg.vocab, (batch, prompt), generator=gen,
                            device=device)
    kept = prompts.clone()
    if on_card:
        sync()
    init_s = time.perf_counter() - t0
    gen_s = []
    outs = []
    for _ in range(2):
        t = time.perf_counter()
        outs.append(eng.generate(prompts, new))
        if on_card:
            sync()
        gen_s.append(time.perf_counter() - t)
    out = outs[1]
    if not torch.equal(outs[0], out):
        fail("lm: two greedy generate calls gave different tokens")
    if not (torch.equal(prompts, kept) and torch.equal(out[:, :prompt], kept)):
        fail("lm: the prompts did not come back unchanged")
    if out.shape != (batch, prompt + new) or eng.decode_calls != 2 * (new - 1):
        fail(f"lm: shape {tuple(out.shape)}, decode_calls {eng.decode_calls}")
    compute = eng._compute
    caches = lm.init_cache(cfg, batch, max_seq, device)
    _, caches = lm.prefill(compute, cfg, {"tokens": out[:, :prompt]}, caches)
    worst = 0.0
    for i in range(new - 1):
        pos = prompt + i
        logits, caches = lm.decode_step(compute, cfg, out[:, pos:pos + 1],
                                        caches, pos)
        full, _ = lm.prefill(compute, cfg, {"tokens": out[:, :pos + 1]},
                             lm.init_cache(cfg, batch, max_seq, device))
        err = float((logits.float() - full.float()).abs().max()
                    / full.float().abs().max())
        worst = max(worst, err)
        if not torch.equal(logits.argmax(-1)[:, 0], out[:, pos + 1]):
            top = full.float()[:, 0].topk(2, dim=-1).values
            gap = float((top[:, 0] - top[:, 1]).min()
                        / full.float().abs().max())
            if gap > LM_TOL:
                fail(f"lm: decode step {i} picked another token than "
                     f"generate at a top-2 gap of {gap:.3g}")
    if not worst <= LM_TOL:
        fail(f"lm: decode logits differ from a full prefill's by {worst:.3g}"
             f" of the logits' scale (tolerance {LM_TOL})")
    tokens = {"tokens": out[:, :prompt]}
    step_tok = out[:, prompt:prompt + 1]
    times = lm_times(
        lambda: lm.prefill(compute, cfg, tokens,
                           lm.init_cache(cfg, batch, max_seq, device)),
        lambda: lm.decode_step(compute, cfg, step_tok, caches, prompt),
        on_card, cfg.name)
    delta = lm_delta(eng.params, device, errs,
                     lambda tree: (tree["pattern"]["b0"], True))
    launches = dict(cuda.launches)
    n_params = count_params(lm.build_specs(cfg))
    res = {"arch": cfg.name, "params": n_params, "layers": cfg.n_layers,
           "batch": batch, "prompt": prompt, "new_tokens": new,
           "max_seq": max_seq, "init_s": init_s, "generate_s": gen_s,
           "tokens_per_s": batch * new / gen_s[1],
           "prefill_ms": times["prefill_ms"],
           "decode_ms_per_step": times["decode_ms"],
           "prefill_device_ms": times["prefill_device_ms"],
           "decode_device_ms_per_step": times["decode_device_ms"],
           "decode_vs_prefill": worst, **delta, "launches": launches,
           "peak_allocated_gib": (torch.cuda.max_memory_allocated() / 2 ** 30
                                  if on_card else None),
           "seconds": time.perf_counter() - t0}
    print(f"lm ({gpu}): {cfg.name} ({n_params} parameters, {cfg.n_layers} "
          f"layers, d_model {cfg.d_model}, vocab {cfg.vocab}) from seed "
          f"{LM_SEED}: {batch} prompts of "
          f"{prompt} tokens + {new} new, max_seq {max_seq}: tokens equal over "
          f"two calls, decode_calls {eng.decode_calls}, decode within "
          f"{worst:.3g} of a full prefill (tolerance {LM_TOL}); prefill "
          f"{res['prefill_ms']} ms (card busy {res['prefill_device_ms']} ms), "
          f"decode {res['decode_ms_per_step']} ms per step of {batch} tokens "
          f"(card busy {res['decode_device_ms_per_step']} ms), generate "
          f"{gen_s[1]:.3f} s ({res['tokens_per_s']:.1f} "
          f"tokens/s); peak allocated {res['peak_allocated_gib']} GiB; XOR "
          f"delta of {res['delta_leaves']} leaves bit-exact in "
          f"{res['delta_s']:.2f} s, zero words "
          f"{res['delta_zero_word_share']:.6f}; phase {res['seconds']:.2f} s;"
          f" launches " + json.dumps(launches), flush=True)
    res["ring_wrap"] = lm_ring_wrap(eng, gpu, batch)
    del eng, compute, caches
    runs = {}
    for name, spec in (LM_ARCHS if archs is None else archs).items():
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        runs[name] = lm_arch_run(errs, gpu, device, name, **spec)
    res["archs"] = runs
    res["launches"] = dict(cuda.launches)
    return res


def lm_inputs(cfg, device: str, batch: int, length: int) -> torch.Tensor:
    """A request batch from seed ``LM_SEED + 1``: ``length`` prompt tokens,
    patch embeddings (at the embedding table's scale, 0.02) or encoder
    frames (N(0, 1)) per sequence."""
    gen = torch.Generator(device=device)
    gen.manual_seed(LM_SEED + 1)
    if cfg.encdec:
        return torch.randn(batch, length, cfg.d_model, generator=gen,
                           device=device)
    if not cfg.uses_tokens:
        return torch.randn(batch, length, cfg.d_model, generator=gen,
                           device=device) * 0.02
    return torch.randint(1, cfg.vocab, (batch, length), generator=gen,
                         device=device)


def lm_steps(params: dict, cfg, inputs: torch.Tensor, new: int, max_seq: int,
             *, feed: "torch.Tensor | None" = None,
             dtype: torch.dtype = torch.bfloat16):
    """``new`` steps through the public entry points in ``dtype``: a
    ``prefill`` of the prompt tokens or patch embeddings ``inputs``, then
    ``decode_step``s; for the encoder-decoder, ``encdec_prefill`` of the
    frames ``inputs``, then decode steps from token 1 at position 0.  Each
    step's token is its logits' argmax, or ``feed[:, i]`` when ``feed``
    (B, new) is given.  Returns the tokens (B, new) and each step's logits
    (B, V)."""
    from repro_torch.models import lm

    b, s0 = inputs.shape[:2]
    if cfg.encdec:
        caches = lm.encdec_prefill(params, cfg, {"frames": inputs},
                                   lm.init_cache(cfg, b, s0, inputs.device,
                                                 dtype), dtype=dtype)
        tok = torch.ones((b, 1), dtype=torch.long, device=inputs.device)
        logits, _ = lm.decode_step(params, cfg, tok, caches, 0, dtype=dtype)
        pos0 = 1
    else:
        key = "tokens" if cfg.uses_tokens else "embeds"
        logits, caches = lm.prefill(params, cfg, {key: inputs},
                                    lm.init_cache(cfg, b, max_seq,
                                                  inputs.device, dtype),
                                    dtype=dtype)
        pos0 = s0
    steps, toks = [logits[:, -1]], []
    while True:
        toks.append(steps[-1].argmax(-1, keepdim=True) if feed is None
                    else feed[:, len(toks):len(toks) + 1])
        if len(toks) == new:
            return torch.cat(toks, dim=1), steps
        logits, caches = lm.decode_step(params, cfg, toks[-1], caches,
                                        pos0 + len(steps) - 1, dtype=dtype)
        steps.append(logits[:, -1])


def lm_full(params: dict, cfg, inputs: torch.Tensor, out: torch.Tensor,
            max_seq: int, dtype: torch.dtype) -> list:
    """What each of ``lm_steps``'s steps should give, teacher-forced on
    ``out`` (B, new), from passes over the whole prefix in ``dtype``: a
    ``prefill`` of the prompt and the tokens before the step (patch
    embeddings followed by the tokens' embedding rows); for the
    encoder-decoder, one pass of the decoder over token 1 and ``out``
    (``_encdec_forward``, non-causal encoder and causal decoder)."""
    from repro_torch.models import lm

    compute = lm.cast_params(params, dtype)
    if cfg.encdec:
        seq = torch.cat([torch.ones_like(out[:, :1]), out[:, :-1]], dim=1)
        enc = lm._encdec_encode(compute, cfg, inputs)
        return list(lm._encdec_forward(compute, cfg, enc, seq).unbind(1))
    steps = []
    for i in range(out.shape[1]):
        if cfg.uses_tokens:
            batch = {"tokens": torch.cat([inputs, out[:, :i]], dim=1)}
        else:
            batch = {"embeds": torch.cat([inputs.to(dtype), lm.embed_lookup(
                compute["embed"], out[:, :i]).to(dtype)], dim=1)}
        logits, _ = lm.prefill(compute, cfg, batch, lm.init_cache(
            cfg, out.shape[0], max_seq, inputs.device, dtype), dtype=dtype)
        steps.append(logits[:, -1])
    return steps


def share(got: list, want: list) -> float:
    """The largest gap between two lists of logits, step by step, as a
    share of ``want``'s largest magnitude at the step."""
    return max(float((a.float() - b.float()).abs().max()
                     / b.float().abs().max()) for a, b in zip(got, want))


def lm_gap(params: dict, cfg, inputs: torch.Tensor, out: torch.Tensor,
           max_seq: int, dtype: torch.dtype):
    """``lm_steps``' steps teacher-forced on ``out`` against ``lm_full``'s:
    their largest gap (``share``) and the full pass's logits."""
    _, steps = lm_steps(params, cfg, inputs, out.shape[1], max_seq, feed=out,
                        dtype=dtype)
    if not all(bool(torch.isfinite(s.float()).all()) for s in steps):
        fail(f"lm {cfg.name}: {dtype} decode logits are not finite")
    full = lm_full(params, cfg, inputs, out, max_seq, dtype)
    return share(steps, full), full


def fan_in_attention(tree: dict) -> int:
    """Scale every attention query and key projection of ``tree`` (leaves
    ``wq``/``wk`` of shape (..., D, heads, head_dim)), in place, from the
    reference initializer's std ``1/sqrt(heads)`` to ``1/sqrt(D)``, the
    fan-in of the width (ROADMAP R9); returns the leaves scaled."""
    from repro_torch.models.specs import flatten

    n = 0
    for path, leaf in flatten(tree):
        if path.rsplit("/", 1)[-1] in ("wq", "wk"):
            leaf.mul_((leaf.shape[-2] / leaf.shape[-3]) ** 0.5)
            n += 1
    return n


def lm_drops(compute: dict, cfg, inputs: torch.Tensor, new: int,
             max_seq: int) -> dict:
    """The share of (token, expert) assignments past their expert's
    capacity at ``cfg.capacity_factor``, in a greedy prefill and in its
    decode steps (``moe.route``'s destinations, counted per call)."""
    from repro_torch.models import moe

    counts = {"prefill": [0, 0], "decode": [0, 0]}
    real = moe.route

    def route(p, xt, **kw):
        routed = real(p, xt, **kw)
        dest, cap = routed[2], routed[3]
        part = counts["prefill" if xt.shape[0] > inputs.shape[0]
                      else "decode"]
        part[0] += int((dest >= p["router"].shape[-1] * cap).sum())
        part[1] += dest.numel()
        return routed

    moe.route = route
    try:
        lm_steps(compute, cfg, inputs, new, max_seq)
    finally:
        moe.route = real
    return {part: {"dropped": n, "assigned": total, "share": n / total}
            for part, (n, total) in counts.items()}


def lm_arch_run(errs: dict, gpu: str, device: str, arch: str, *, batch: int,
                new: int, prompt: int = 0, max_seq: int = 0, frames: int = 0,
                patches: int = 0, repeats: int = 0,
                capacity_factor: float = 0.0, drops_at: float = 0.0,
                delta: bool = False, bf16_gated: bool = True) -> dict:
    """One config of ``LM_ARCHS`` at its published widths (depth cut to
    ``repeats`` where given), from a fresh ``Engine.from_seed`` on the
    card: greedy serving twice with equal tokens (``Engine.generate``, or
    ``lm_steps`` for patch embeddings and frames), prefill and decode
    times with the card's busy share of a decode step, tokens/s, peak
    allocated memory; the MoE drop shares at ``drops_at``; the XOR delta
    of the whole tree where ``delta``.  Then the decode gates, with the
    query and key projections at the width's fan-in (``fan_in_attention``):
    every float32 decode step within ``LM_F32_TOL`` of a float32 full pass
    over the same prefix, and every bfloat16 one (the served dtype) within
    ``LM_TOL`` of a bfloat16 full pass, or reported only where not
    ``bf16_gated``."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.models.specs import count_params
    from repro_torch.serve import Engine, ServeConfig

    on_card = device == "cuda"
    cfg = get_config(arch)
    published_layers = cfg.n_layers
    if repeats:
        cfg = dataclasses.replace(cfg, repeats=repeats)
    if capacity_factor:
        cfg = dataclasses.replace(cfg, capacity_factor=capacity_factor)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = Engine.from_seed(cfg, seed=LM_SEED, device=device,
                           serve_cfg=ServeConfig(max_seq=max_seq))
    compute = eng._compute
    inputs = lm_inputs(cfg, device, batch, prompt or patches or frames)
    kept = inputs.clone()
    if on_card:
        sync()
    init_s = time.perf_counter() - t0
    tokens = cfg.uses_tokens and not cfg.encdec
    outs, gen_s = [], []
    for _ in range(2):
        t = time.perf_counter()
        outs.append(eng.generate(inputs, new)[:, prompt:] if tokens
                    else lm_steps(compute, cfg, inputs, new, max_seq)[0])
        if on_card:
            sync()
        gen_s.append(time.perf_counter() - t)
    out = outs[1]
    if not torch.equal(outs[0], out) or out.shape != (batch, new):
        fail(f"lm {arch}: two greedy runs gave different tokens")
    if not torch.equal(inputs, kept):
        fail(f"lm {arch}: the prompts did not come back unchanged")
    if eng.decode_calls != (2 * (new - 1) if tokens else 0):
        fail(f"lm {arch}: decode_calls {eng.decode_calls}")

    # timing: a prefill (encoder-decoder: encode and stage the cross K/V)
    # and one decode step on its caches
    if cfg.encdec:
        def prefill_fn():
            return lm.encdec_prefill(compute, cfg, {"frames": inputs},
                                     lm.init_cache(cfg, batch, frames, device))
        caches, pos = prefill_fn(), 0
    else:
        key = "tokens" if cfg.uses_tokens else "embeds"

        def prefill_fn():
            return lm.prefill(compute, cfg, {key: inputs},
                              lm.init_cache(cfg, batch, max_seq, device))
        caches, pos = prefill_fn()[1], inputs.shape[1]
    times = lm_times(
        prefill_fn, lambda: lm.decode_step(compute, cfg, out[:, :1], caches,
                                           pos), on_card, arch)
    del caches
    res = {"arch": arch, "params": count_params(lm.build_specs(cfg)),
           "layers": cfg.n_layers, "published_layers": published_layers,
           "d_model": cfg.d_model, "batch": batch, "prompt": prompt,
           "frames": frames, "patches": patches, "new_tokens": new,
           "max_seq": max_seq, "capacity_factor": cfg.capacity_factor,
           "init_s": init_s, "serve_s": gen_s,
           "tokens_per_s": batch * new / gen_s[1], **times}
    if drops_at:
        res["drops"] = lm_drops(compute, dataclasses.replace(
            cfg, capacity_factor=drops_at), inputs, new, max_seq)
        res["drops"]["capacity_factor"] = drops_at
    res["peak_allocated_gib"] = (torch.cuda.max_memory_allocated() / 2 ** 30
                                 if on_card else None)
    if delta:
        res.update(lm_delta(eng.params, device, errs, lambda tree: (
            (tree["pattern"]["b0"], True) if "pattern" in tree
            else (tree["decoder"]["d0"], False))))

    # the gates, on the query and key projections at the width's fan-in
    res["fan_in_leaves"] = fan_in_attention(eng.params)
    fan_in_attention(compute)
    with torch.no_grad():
        res["f32_decode_vs_full"], full32 = lm_gap(
            eng.params, cfg, inputs, out, max_seq, torch.float32)
        res["bf16_decode_vs_full"], full16 = lm_gap(
            compute, cfg, inputs, out, max_seq, torch.bfloat16)
    res["bf16_full_vs_f32"] = share(full16, full32)
    if not res["f32_decode_vs_full"] <= LM_F32_TOL:
        fail(f"lm {arch}: float32 decode steps differ from a float32 full "
             f"pass by {res['f32_decode_vs_full']:.3g} of the logits' scale "
             f"(tolerance {LM_F32_TOL})")
    if bf16_gated and not res["bf16_decode_vs_full"] <= LM_TOL:
        fail(f"lm {arch}: bfloat16 decode steps differ from a bfloat16 full "
             f"pass by {res['bf16_decode_vs_full']:.3g} of the logits' scale "
             f"(tolerance {LM_TOL})")
    del eng, compute, outs, out, inputs, kept, full32, full16
    res["seconds"] = time.perf_counter() - t0
    cut = ("" if cfg.n_layers == published_layers else
           f" (depth cut: {cfg.n_layers} of its {published_layers} layers)")
    unit = "tokens" if prompt else "patch embeddings" if patches else "frames"
    print(f"lm {arch} ({gpu}): {res['params']} parameters, {cfg.n_layers} "
          f"layers{cut}, d_model {cfg.d_model}, from seed {LM_SEED}; "
          f"{batch} x {prompt or patches or frames} {unit} + {new} new: "
          f"tokens equal over two runs; prefill {res['prefill_ms']} ms (card "
          f"busy {res['prefill_device_ms']} ms), decode {res['decode_ms']} ms "
          f"per step (card busy {res['decode_device_ms']} ms, share "
          f"{res['decode_busy_share']}), {res['tokens_per_s']:.1f} tokens/s, "
          f"peak allocated {res['peak_allocated_gib']} GiB"
          + (f"; dropped at capacity factor {drops_at}: "
             + json.dumps(res["drops"]) if drops_at else "")
          + (f"; XOR delta of {res['delta_leaves']} leaves bit-exact in "
             f"{res['delta_s']:.2f} s" if delta else "")
          + f"; with {res['fan_in_leaves']} wq/wk leaves at the width's "
          f"fan-in, decode against a full pass: float32 "
          f"{res['f32_decode_vs_full']:.3g} (tolerance {LM_F32_TOL}), "
          f"bfloat16 {res['bf16_decode_vs_full']:.3g} ("
          + (f"tolerance {LM_TOL}" if bf16_gated else "reported") + f"; the "
          f"bfloat16 full pass {res['bf16_full_vs_f32']:.3g} from the "
          f"float32 one); {res['seconds']:.2f} s", flush=True)
    return res


def lm_ring_wrap(eng, gpu: str, batch: int,
                 steps: int = LM_WRAP_STEPS) -> dict:
    """A second engine over ``eng``'s weights whose ``max_seq`` (twice the
    sliding window) lets each ``swa`` layer's KV ring wrap: a prompt of
    ``window - steps`` tokens and ``2 * steps`` new ones, so the last
    ``steps`` decode steps overwrite the ring's oldest slots.  Teacher-forced
    on the generated tokens, each decode step's logits must equal the
    logits at the same position of one causal forward pass over the tokens
    (padded to a multiple of the window, which the banded prefill needs;
    the padding comes after every position compared), within ``LM_TOL`` of
    the logits' scale."""
    from repro_torch.models import lm
    from repro_torch.models.layers import embed_lookup
    from repro_torch.serve import Engine, ServeConfig

    cfg, device = eng.cfg, eng.device
    window = max(b.window for b in cfg.pattern + cfg.tail if b.kind == "swa")
    prompt, new, max_seq = window - steps, 2 * steps, 2 * window
    t0 = time.perf_counter()
    wrap = Engine(cfg, eng.params, ServeConfig(max_seq=max_seq))
    gen = torch.Generator(device=device)
    gen.manual_seed(LM_SEED + 3)
    prompts = torch.randint(1, cfg.vocab, (batch, prompt), generator=gen,
                            device=device)
    out = wrap.generate(prompts, new)
    if (out.shape != (batch, prompt + new) or wrap.decode_calls != new - 1
            or not torch.equal(out[:, :prompt], prompts)):
        fail(f"lm ring wrap: shape {tuple(out.shape)}, decode_calls "
             f"{wrap.decode_calls}")
    compute = wrap._compute
    seq = -(-out.shape[1] // window) * window
    padded = torch.nn.functional.pad(out, (0, seq - out.shape[1]))
    with torch.no_grad():
        x = embed_lookup(compute["embed"], padded).to(torch.bfloat16)
        x, _ = lm._run_stack(compute, x, cfg,
                             positions=torch.arange(seq, device=device),
                             caches=lm.init_cache(cfg, batch, seq, device))
        full = lm._logits(compute, cfg, x[:, prompt:prompt + new - 1]).float()
    caches = lm.init_cache(cfg, batch, max_seq, device)
    _, caches = lm.prefill(compute, cfg, {"tokens": out[:, :prompt]}, caches)
    worst = {"before_wrap": 0.0, "after_wrap": 0.0}
    for i in range(new - 1):
        pos = prompt + i
        logits, caches = lm.decode_step(compute, cfg, out[:, pos:pos + 1],
                                        caches, pos)
        want = full[:, i]
        err = float((logits[:, 0].float() - want).abs().max()
                    / want.abs().max())
        part = "after_wrap" if pos >= window else "before_wrap"
        worst[part] = max(worst[part], err)
        if not torch.equal(logits.argmax(-1)[:, 0], out[:, pos + 1]):
            top = want.topk(2, dim=-1).values
            gap = float((top[:, 0] - top[:, 1]).min() / want.abs().max())
            if gap > LM_TOL:
                fail(f"lm ring wrap: decode step {i} picked another token "
                     f"than generate at a top-2 gap of {gap:.3g}")
    if not max(worst.values()) <= LM_TOL:
        fail(f"lm ring wrap: decode logits differ from the forward pass's "
             f"by {worst} of the logits' scale (tolerance {LM_TOL})")
    res = {"window": window, "prompt": prompt, "new_tokens": new,
           "max_seq": max_seq, "decode_steps_after_wrap": prompt + new - 1
           - window, "decode_vs_forward": worst,
           "seconds": time.perf_counter() - t0}
    print(f"lm ring wrap ({gpu}): {cfg.name}, window {window}: {batch} "
          f"prompts of {prompt} tokens + {new} new at max_seq {max_seq}, "
          f"{res['decode_steps_after_wrap']} decode steps past the wrap; "
          f"decode within {worst['before_wrap']:.3g} / "
          f"{worst['after_wrap']:.3g} (before / after the wrap) of one "
          f"forward pass (tolerance {LM_TOL}); {res['seconds']:.2f} s",
          flush=True)
    return res


# -- phase 10: LM training at full width -----------------------------------------

def train_flops(cfg, n_params: int, tokens: int, seq: int) -> float:
    """Model FLOPs of one training step: 6 * parameters * tokens plus the
    attention term 12 * layers * heads * head_dim * context per token (the
    PaLM convention; remat's extra forward pass is not counted)."""
    ctx = sum(min(b.window, seq) if b.kind == "swa" else seq
              for b in cfg.pattern * cfg.repeats + cfg.tail
              if b.kind in ("attn", "swa"))
    return 6.0 * n_params * tokens + 12.0 * cfg.n_heads * cfg.head_dim * ctx \
        * tokens


def step_profile(fn, what: str) -> dict:
    """One call of ``fn`` under ``torch.profiler``: the card's kernel ms,
    the kernels launched and the six that took longest (None when no
    session recorded a kernel)."""
    prof = card_profile(fn, what)
    if prof is None:
        return {"device_ms": None, "kernels": None, "top": None}
    rows = [(e.self_device_time_total, e.count, e.key)
            for e in prof.key_averages() if e.self_device_time_total > 0]
    rows.sort(reverse=True)
    return {"device_ms": sum(us for us, _, _ in rows) / 1e3,
            "kernels": sum(n for _, n, _ in rows),
            "top": [{"kernel": key[:60], "ms": us / 1e3, "count": n}
                    for us, n, key in rows[:6]]}


@contextlib.contextmanager
def timing_checkpoints(ckpt_lib):
    """While the block runs, the seconds of each ``save`` and ``restore``
    of ``ckpt_lib`` (the training loop's checkpoint module), by name."""
    spent: dict = {"save": [], "restore": []}

    def wrap(name: str):
        real = getattr(ckpt_lib, name)

        def call(*args, **kwargs):
            t = time.perf_counter()
            out = real(*args, **kwargs)
            spent[name].append(time.perf_counter() - t)
            return out
        return real, call

    reals = {}
    for name in spent:
        reals[name], call = wrap(name)
        setattr(ckpt_lib, name, call)
    try:
        yield spent
    finally:
        for name, real in reals.items():
            setattr(ckpt_lib, name, real)


def train_filter(device: str) -> dict:
    """The training example's in-flash data filter: the quality and dedup
    bitmaps of TRAIN_SHARDS corpus shards (numpy seed 0) ANDed and counted
    by ``BitmapFilter``, equal to numpy's count; every recorded kernel call
    held against its plain version."""
    from repro_torch.api.session import ComputeSession
    from repro_torch.data import BitmapFilter

    rng = np.random.default_rng(0)
    quality = (rng.random(TRAIN_SHARDS) < 0.95).astype(np.uint8)
    dedup = (rng.random(TRAIN_SHARDS) < 0.98).astype(np.uint8)
    sess = ComputeSession(device, seed=17)
    bf = BitmapFilter(TRAIN_SHARDS, session=sess)
    with recording(sess.backend) as rec:
        bf.add_pair("quality", quality, "dedup", dedup)
        kept = bf.count([("quality", "dedup")])
        sync()
    if kept != int((quality & dedup).sum()):
        fail(f"train: the filter kept {kept} shards, numpy counts "
             f"{int((quality & dedup).sum())}")
    return {"kept": kept, "calls": dict(rec.counts),
            "checks": hold_recorded(rec.calls)}


def train_unit_f32(cfg, device: str) -> dict:
    """One full-width pattern unit (``repeats=1``, no tail) in float32: the
    loss and every gradient of ``forward_loss`` on 1 x TRAIN_F32_SEQ tokens
    on ``device`` against the CPU's on the same weights (drawn on the CPU:
    a card's generator draws other values from the same seed)."""
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.models import lm
    from repro_torch.models.specs import flatten, init_tree, tree_map

    unit = dataclasses.replace(cfg, repeats=1, tail=())
    tokens = TokenPipeline(DataConfig(unit.vocab, TRAIN_F32_SEQ, 1,
                                      TRAIN_SEED)).batch_at(0)["tokens"]

    weights = init_tree(TRAIN_SEED, lm.build_specs(unit), "cpu")

    def run(dev):
        params = tree_map(lambda t: t.to(dev).requires_grad_(), weights)
        loss, _ = lm.forward_loss(params, unit, {"tokens": tokens.to(dev)},
                                  dtype=torch.float32)
        loss.backward()
        return float(loss.detach()), {k: t.grad for k, t in flatten(params)}

    t = time.perf_counter()
    loss, grads = run(device)
    cpu_loss, cpu_grads = run("cpu")
    loss_err = abs(loss - cpu_loss) / abs(cpu_loss)
    worst, where = 0.0, None
    for path, want in cpu_grads.items():
        got = grads[path].cpu()
        err = float((got - want).abs().max() / want.abs().max())
        if where is None or not err <= worst:
            worst, where = err, path
    if not loss_err <= TRAIN_F32_LOSS_TOL:
        fail(f"train: float32 loss of one unit on the card {loss} against "
             f"the CPU's {cpu_loss} ({loss_err:.3g} relative)")
    if not worst <= TRAIN_F32_GRAD_TOL:
        fail(f"train: float32 gradient {where} on the card lies {worst:.3g} "
             f"of its scale from the CPU's (tolerance {TRAIN_F32_GRAD_TOL})")
    return {"layers": unit.n_layers, "tokens": TRAIN_F32_SEQ, "loss": loss,
            "loss_rel_err": loss_err, "worst_grad_err": worst,
            "worst_grad_leaf": where, "seconds": time.perf_counter() - t}


def train_ssm(device: str, ckpt_dir: Path) -> dict:
    """mamba2-130m at its published widths and depth, SSM_TRAIN_STEPS steps
    of 4 x SSM_TRAIN_SEQ tokens: finite losses and the step times."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.models.specs import count_params
    from repro_torch.optim import AdamWConfig
    from repro_torch.train.loop import LoopConfig, TrainLoop

    cfg = get_config(SSM_TRAIN_ARCH)
    on_card = device == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    loop = TrainLoop(cfg, LoopConfig(total_steps=SSM_TRAIN_STEPS,
                                     ckpt_every=SSM_TRAIN_STEPS,
                                     ckpt_dir=str(ckpt_dir), log_every=0,
                                     seed=TRAIN_SEED),
                     opt_cfg=AdamWConfig(lr=TRAIN_LR,
                                         warmup_steps=TRAIN_WARMUP,
                                         total_steps=SSM_TRAIN_STEPS),
                     global_batch=TRAIN_BATCH, seq_len=SSM_TRAIN_SEQ,
                     device=device)
    res = loop.run()
    losses = [m["loss"] for m in res["metrics"]]
    if len(losses) != SSM_TRAIN_STEPS or not all(np.isfinite(losses)):
        fail(f"train: {cfg.name} losses {losses}")
    batch = loop.batch_fn(SSM_TRAIN_STEPS)

    def step():
        loop.step_fn(res["params"], res["opt"], batch)

    step_ms = time_ms(step, 3, warmup=1) if on_card else None
    prof = step_profile(step, f"{cfg.name} train step") if on_card else {}
    n_params = count_params(lm.build_specs(cfg))
    tokens = TRAIN_BATCH * SSM_TRAIN_SEQ
    flops = train_flops(cfg, n_params, tokens, SSM_TRAIN_SEQ)
    dev_ms = prof.get("device_ms")
    return {"arch": cfg.name, "params": n_params, "layers": cfg.n_layers,
            "losses": losses,
            "step_s": [m["step_time_s"] for m in res["metrics"]],
            "grad_norm": [m["grad_norm"] for m in res["metrics"]],
            "step_ms": step_ms, "step_device_ms": dev_ms,
            "step_kernels": prof.get("kernels"), "step_top": prof.get("top"),
            "busy_share": (None if dev_ms is None or step_ms is None
                           else dev_ms / step_ms),
            "tokens_per_s": tokens / step_ms * 1e3 if step_ms else None,
            "model_flops": flops,
            "flops_share": (flops / (step_ms * 1e-3) / BF16_PEAK_FLOPS
                            if step_ms else None),
            "peak_allocated_gib": (torch.cuda.max_memory_allocated() / 2 ** 30
                                   if on_card else None)}


def train_phase(errs: dict, gpu: str, device: str = "cuda", cfg=None,
                ckpt_dir: "Path | None" = None, steps: int = TRAIN_STEPS,
                ckpt_every: int = TRAIN_CKPT_EVERY,
                preempt: int = TRAIN_PREEMPT, batch: int = TRAIN_BATCH,
                seq: int = TRAIN_SEQ) -> dict:
    """The training example's MCFlash filter, then ``TrainLoop`` over
    gemma3-1b at full width: preempted after step ``preempt``, restarted
    from its checkpoint (the restored state bit-exact, the first resumed
    loss the uninterrupted run's), run to ``steps``; the losses finite,
    the first near ln(vocab), the last four below the first four; one
    step with microbatches=2 against one batch; the step timed; the XOR
    delta of the whole tree between checkpoints ``ckpt_every`` and
    ``steps`` bit-exact through ``bitwise_reduce``; then one full-width
    pattern unit's float32 gradients on the card against the CPU's, and
    mamba2-130m's SSD stack trained at its published widths."""
    from repro_torch.checkpoint import ckpt as ckpt_lib
    from repro_torch.checkpoint import delta as delta_mod
    from repro_torch.checkpoint import delta_apply, delta_encode, delta_sparsity
    from repro_torch.configs import get_config
    from repro_torch.kernels import cuda
    from repro_torch.models import lm
    from repro_torch.models.specs import count_params, flatten
    from repro_torch.optim import AdamWConfig
    from repro_torch.train.loop import LoopConfig, TrainLoop
    from repro_torch.train.step import make_train_step

    on_card = device == "cuda"
    if on_card:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cfg = cfg or get_config(TRAIN_ARCH)
    ckpt_dir = ckpt_dir or ROOT / "build" / "chip_smoke_train"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    t0 = time.perf_counter()
    cuda.reset_launches()
    calls = dict.fromkeys(KERNELS, 0)
    checked: dict = {}

    def fold(counts: dict, checks: dict) -> None:
        for name, n in counts.items():
            calls[name] += n
        for name, err in checks.items():
            checked[name] = max(checked.get(name, 0), err)

    filt = train_filter(device)
    fold(filt["calls"], filt["checks"])
    filter_s = time.perf_counter() - t0

    opt_cfg = AdamWConfig(lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                          total_steps=steps)

    def make_loop():
        return TrainLoop(cfg, LoopConfig(total_steps=steps,
                                         ckpt_every=ckpt_every,
                                         ckpt_dir=str(ckpt_dir), log_every=0,
                                         seed=TRAIN_SEED),
                         opt_cfg=opt_cfg, global_batch=batch, seq_len=seq,
                         device=device)

    if on_card:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    first = make_loop()
    data_at = first.batch_fn

    def preempting(step):
        if step == preempt - 1:
            first.request_preemption()
        return data_at(step)

    first.batch_fn = preempting
    with timing_checkpoints(ckpt_lib) as io_s:
        res1 = first.run()
    run1_s = time.perf_counter() - t
    if res1["last_step"] != preempt or \
            ckpt_lib.latest_step(ckpt_dir) != preempt:
        fail(f"train: the preempted run stopped at {res1['last_step']}, "
             f"checkpoint {ckpt_lib.latest_step(ckpt_dir)}")
    # the uninterrupted run's next step, from the state the first run saved
    cont_loss = float(first.step_fn(res1["params"], res1["opt"],
                                    data_at(preempt))[2]["loss"])

    second = make_loop()
    saved = {"state": (res1["params"], res1["opt"])}
    restore_or_init = second.restore_or_init
    resumed: dict = {}

    def bits(t: torch.Tensor) -> torch.Tensor:
        return t.view(torch.int32) if t.dtype == torch.float32 else t

    def restore_checked():
        """The restart's restore, its state held bit for bit against the
        state the first run saved."""
        params, opt, step = restore_or_init()
        want_p, want_o = saved.pop("state")
        pairs = [(opt.step, want_o.step)]
        for got, want in ((params, want_p), (opt.m, want_o.m),
                          (opt.v, want_o.v)):
            pairs += [(a, b) for (_, a), (_, b) in zip(flatten(got),
                                                       flatten(want))]
        resumed["step"] = step
        resumed["bit_exact"] = all(
            a.dtype == b.dtype and torch.equal(bits(a), bits(b))
            for a, b in pairs)
        return params, opt, step

    second.restore_or_init = restore_checked
    del res1
    t = time.perf_counter()
    with timing_checkpoints(ckpt_lib) as io2_s:
        res2 = second.run()
    run2_s = time.perf_counter() - t
    ckpt_s = {k: io_s[k] + io2_s[k] for k in io_s}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 if on_card else None
    if resumed.get("step") != preempt or not resumed["bit_exact"]:
        fail(f"train: the restart resumed at {resumed.get('step')}, state "
             f"bit-exact {resumed.get('bit_exact')}")
    losses = [m["loss"] for m in first.metrics_log + second.metrics_log]
    resume_err = abs(second.metrics_log[0]["loss"] - cont_loss) / cont_loss
    if len(losses) != steps or not all(np.isfinite(losses)):
        fail(f"train: losses {losses}")
    if abs(losses[0] - float(np.log(cfg.vocab))) > TRAIN_FIRST_LOSS_TOL:
        fail(f"train: first loss {losses[0]:.4f}, ln(vocab) "
             f"{np.log(cfg.vocab):.4f}")
    if not np.mean(losses[-4:]) < np.mean(losses[:4]):
        fail(f"train: the loss did not fall ({losses})")
    if not resume_err <= TRAIN_RESUME_TOL:
        fail(f"train: the resumed loss {second.metrics_log[0]['loss']} "
             f"against the uninterrupted run's {cont_loss}")

    # one more step on the trained state: one batch against two
    # microbatches, then timed and profiled
    params, opt = res2["params"], res2["opt"]
    probe = second.batch_fn(steps)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    one = second.step_fn(params, opt, probe)[2]
    two = make_train_step(cfg, opt_cfg, microbatches=2)(params, opt,
                                                        probe)[2]
    mb_err = abs(float(two["grad_norm"]) / float(one["grad_norm"]) - 1)
    if not mb_err <= TRAIN_MB_TOL:
        fail(f"train: microbatches=2 grad_norm {float(two['grad_norm'])} "
             f"against {float(one['grad_norm'])}")

    def step():
        second.step_fn(params, opt, probe)

    step_ms = time_ms(step, 3, warmup=1) if on_card else None
    prof = step_profile(step, "train step") if on_card else {}
    with FlopCounterMode(display=False) as flop_mode:   # the cost phase's
        step()                                          # cross-check
    counted_flops = flop_mode.get_total_flops()
    step_dev_ms = prof.get("device_ms")
    step_peak = (torch.cuda.max_memory_allocated() / 2 ** 30 if on_card
                 else None)
    n_params = count_params(lm.build_specs(cfg))
    tokens = batch * seq
    flops = train_flops(cfg, n_params, tokens, seq)

    # the XOR delta of the whole tree, checkpoint ckpt_every -> steps
    base = ckpt_lib.restore(ckpt_dir, (params, opt), ckpt_every)[0][0]
    t = time.perf_counter()
    with recording(delta_mod.BACKENDS[torch.device(device).type]) as rec:
        delta = delta_encode(base, params)
        back = delta_apply(base, delta)
        sync()
    delta_s = time.perf_counter() - t
    for (path, got), (_, want) in zip(flatten(back), flatten(params)):
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            fail(f"train: delta round trip of {path} is not bit-exact")
    zero_share = delta_sparsity(delta)
    fold(rec.counts, hold_recorded(rec.calls))
    del base, delta, back, params, opt, res2, second, first, step
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    launches = dict(cuda.launches)
    fold_errs(errs, checked, launches, "train")
    if on_card and launches != calls:
        fail(f"train: launches {launches} differ from the backends' kernel "
             f"calls {calls}")
    if calls != TRAIN_LAUNCHES:
        fail(f"train: kernel calls {calls} differ from the CPU rehearsal's "
             f"{TRAIN_LAUNCHES}")
    main_s = time.perf_counter() - t0
    res = {"arch": cfg.name, "params": n_params, "layers": cfg.n_layers,
           "batch": batch, "seq": seq, "steps": steps, "losses": losses,
           "resume_step": resumed["step"], "resume_rel_err": resume_err,
           "mb2_grad_norm_rel_err": mb_err,
           "filter_kept": filt["kept"], "filter_s": filter_s,
           "run1_s": run1_s, "run2_s": run2_s, "checkpoint_s": ckpt_s,
           "step_ms": step_ms, "step_device_ms": step_dev_ms,
           "step_kernels": prof.get("kernels"), "step_top": prof.get("top"),
           "busy_share": (None if step_dev_ms is None or step_ms is None
                          else step_dev_ms / step_ms),
           "tokens_per_s": (tokens / step_ms * 1e3 if step_ms else None),
           "model_flops": flops, "flop_counter_mode_flops": counted_flops,
           "flops_share": (flops / (step_ms * 1e-3) / BF16_PEAK_FLOPS
                           if step_ms else None),
           "peak_allocated_gib": peak, "step_peak_allocated_gib": step_peak,
           "delta_s": delta_s, "delta_zero_word_share": zero_share,
           "kernel_calls": calls, "launches": launches,
           "kernel_checks": sorted(checked), "seconds_main": main_s}
    print(f"train ({gpu}): {cfg.name} ({n_params} parameters, "
          f"{cfg.n_layers} layers) from seed {TRAIN_SEED}, {steps} steps of "
          f"{batch} x {seq} tokens, preempted after {preempt} and resumed "
          f"there bit-exact (first resumed loss {resume_err:.3g} from the "
          f"uninterrupted run's); losses {[round(x, 4) for x in losses]}; "
          f"microbatches=2 grad_norm within {mb_err:.3g}; step "
          f"{step_ms} ms (card busy {step_dev_ms} ms in "
          f"{res['step_kernels']} kernels, share {res['busy_share']}; top "
          + json.dumps(res["step_top"]) + f"), {res['tokens_per_s']} "
          f"tokens/s, "
          f"{flops:.4g} model FLOPs per step, {res['flops_share']} of the "
          f"bf16 peak; peak allocated {step_peak} GiB in the steps, {peak} "
          f"GiB over the runs and the restart; filter kept "
          f"{filt['kept']}/{TRAIN_SHARDS} shards in {filter_s:.2f} s; XOR "
          f"delta of checkpoints {ckpt_every} -> {steps} bit-exact in "
          f"{delta_s:.2f} s, zero words {zero_share:.6f}; runs "
          f"{run1_s:.2f} s + {run2_s:.2f} s (checkpoint saves "
          f"{[round(x, 2) for x in ckpt_s['save']]} s, restores "
          f"{[round(x, 2) for x in ckpt_s['restore']]} s); {main_s:.2f} s; "
          "launches "
          + json.dumps(launches), flush=True)

    unit = res["unit_f32"] = train_unit_f32(cfg, device)
    gc.collect()
    ssm = res["ssm"] = train_ssm(device, ckpt_dir / "ssm")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    res["seconds"] = time.perf_counter() - t0
    print(f"train ({gpu}): one {cfg.name} pattern unit ({unit['layers']} "
          f"layers, full width) in float32 on 1 x {unit['tokens']} tokens: "
          f"loss {unit['loss']:.6f} within {unit['loss_rel_err']:.3g} of the "
          f"CPU's, gradients within {unit['worst_grad_err']:.3g} of their "
          f"scale ({unit['worst_grad_leaf']}) in {unit['seconds']:.2f} s; "
          f"{ssm['arch']} ({ssm['params']} parameters, {ssm['layers']} "
          f"layers) {SSM_TRAIN_STEPS} steps of {batch} x {SSM_TRAIN_SEQ}: "
          f"losses {[round(x, 4) for x in ssm['losses']]}, grad norms "
          f"{[round(x, 4) for x in ssm['grad_norm']]}, loop step s "
          f"{[round(x, 4) for x in ssm['step_s']]}; step {ssm['step_ms']} "
          f"ms (card busy {ssm['step_device_ms']} ms in "
          f"{ssm['step_kernels']} kernels, share {ssm['busy_share']}; top "
          + json.dumps(ssm["step_top"]) + f"), {ssm['tokens_per_s']} "
          f"tokens/s, {ssm['model_flops']:.4g} model FLOPs, "
          f"{ssm['flops_share']} of the bf16 peak, peak allocated "
          f"{ssm['peak_allocated_gib']} GiB; phase {res['seconds']:.2f} s",
          flush=True)
    return res


def pipeline_phase(errs: dict, gpu: str, device: str = "cuda", cfg=None,
                   batch: int = PIPE_BATCH, seq: int = PIPE_SEQ,
                   microbatches=PIPE_MICROBATCHES) -> dict:
    """``parallel.pipeline.pipeline_apply`` over gemma3-1b's stacked
    pattern units at full width, one unit per stage, the stages on their
    own streams of one card: each microbatch's output equal bit for bit to
    the sequential pass over that microbatch (the same kernels on the same
    shapes), the whole within ``PIPE_TOL`` of one full-batch sequential
    pass; the float32 gradients through the pipeline (one unit per stage,
    1 x ``seq`` tokens) within ``PIPE_GRAD_TOL`` of the sequential pass's.
    Times the pipeline at each microbatch count and the sequential pass
    (CUDA events), and measures the kernels' overlap across the stage
    streams (``torch.profiler``) beside GPipe's bubble formula."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import cuda
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import lm
    from repro_torch.models.specs import flatten, init_tree, tree_map
    from repro_torch.parallel.pipeline import bubble_fraction, pipeline_apply

    on_card = device == "cuda"
    cfg = cfg or get_config(PIPE_ARCH)
    t0 = time.perf_counter()
    cuda.reset_launches()
    n_stages = cfg.repeats
    mesh = Mesh(("pod",), (n_stages,))
    devices = [device] * n_stages
    masters = init_tree(PIPE_SEED, lm.build_specs(cfg)["pattern"], device)
    gen = torch.Generator().manual_seed(PIPE_SEED)

    def stage(p, x):
        return lm.apply_unit(p, x, cfg)[0]

    def unit(tree, r):
        return {k: unit(v, r) if isinstance(v, dict) else v[r]
                for k, v in tree.items()}

    def sequential(params, x):
        for r in range(n_stages):
            x = stage(unit(params, r), x)
        return x

    params = lm.cast_params(masters)
    x = torch.randn(batch, seq, cfg.d_model, generator=gen) \
        .to(torch.bfloat16).to(device)
    runs = {}
    with torch.no_grad():
        full = sequential(params, x)
        scale = float(full.float().abs().max())
        for m in microbatches:
            got = pipeline_apply(stage, params, x, mesh=mesh,
                                 microbatches=m, devices=devices)
            per_mb = [sequential(params, xm) for xm in x.split(batch // m)]
            exact = all(torch.equal(a, b) for a, b in
                        zip(got.split(batch // m), per_mb))
            gap = float((got.float() - full.float()).abs().max()) / scale
            if not exact:
                fail(f"pipeline: M={m} differs from the sequential pass per "
                     "microbatch")
            if not gap <= PIPE_TOL:
                fail(f"pipeline: M={m} lies {gap:.3g} of the scale from the "
                     "full-batch pass")
            runs[m] = {"bit_exact_per_microbatch": exact,
                       "gap_to_full_batch": gap,
                       "bubble": bubble_fraction(n_stages, m)}
        if on_card:
            seq_ms = time_ms(lambda: sequential(params, x), 3, warmup=1)
            for m in microbatches:
                def piped(m=m):
                    pipeline_apply(stage, params, x, mesh=mesh,
                                   microbatches=m, devices=devices)
                runs[m]["ms"] = time_ms(piped, 3, warmup=1)
                runs[m]["overlap"] = kernel_overlap(piped, f"pipeline M={m}")
        else:
            seq_ms = None
    del full

    # float32 gradients: one unit per stage, one sequence
    xg = torch.randn(1, seq, cfg.d_model, generator=gen).to(device)
    cot = torch.randn(1, seq, cfg.d_model, generator=gen).to(device)

    def grads(run):
        tree = tree_map(lambda t: t.detach().clone().requires_grad_(),
                        masters)
        xi = xg.clone().requires_grad_()
        (run(tree, xi) * cot).sum().backward()
        return [("x", xi.grad)] + [(k, t.grad) for k, t in flatten(tree)]

    want = grads(sequential)
    got = grads(lambda p, xi: pipeline_apply(stage, p, xi, mesh=mesh,
                                             microbatches=1, devices=devices))
    worst, worst_leaf = 0.0, None
    for (path, a), (_, b) in zip(got, want):
        err = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
        if err > worst:
            worst, worst_leaf = err, path
    if not worst <= PIPE_GRAD_TOL:
        fail(f"pipeline: float32 gradient of {worst_leaf} lies {worst:.3g} "
             "of its scale from the sequential pass's")
    del masters, params, x, got, want
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    launches = dict(cuda.launches)
    res = {"arch": cfg.name, "stages": n_stages,
           "layers_per_stage": len(cfg.pattern), "batch": batch, "seq": seq,
           "sequential_ms": seq_ms, "runs": runs,
           "grad_worst_rel_err": worst, "grad_worst_leaf": worst_leaf,
           "launches": launches, "seconds": time.perf_counter() - t0}
    print(f"pipeline ({gpu}): {cfg.name}, {n_stages} stages of "
          f"{len(cfg.pattern)} layers on {n_stages} streams, {batch} x {seq} "
          f"bfloat16 tokens: sequential {seq_ms} ms; " + "; ".join(
              f"M={m}: {r.get('ms')} ms, bubble {r['bubble']:.4f}, kernel "
              f"overlap {json.dumps(r.get('overlap'))}, bit-exact per "
              f"microbatch, {r['gap_to_full_batch']:.3g} of the scale from "
              f"the full batch" for m, r in runs.items())
          + f"; float32 gradients within {worst:.3g} ({worst_leaf}); "
          f"{res['seconds']:.2f} s", flush=True)
    return res


def cost_phase(gpu: str, train: dict, device: str = "cuda", cfg=None,
               batch: int = TRAIN_BATCH, seq: int = TRAIN_SEQ,
               cells: bool = True) -> dict:
    """The dry run's counter (``launch.cost_analysis``): ``dryrun.run_cell``
    for ``COST_CELL`` on both production meshes, on the meta device; then
    the training phase's step (gemma3-1b, ``batch`` x ``seq``) counted on
    meta tensors, its product FLOPs equal to ``FlopCounterMode``'s on the
    real step on the card (``train["flop_counter_mode_flops"]``), beside
    ``train_flops``, the JAX package's 6·N·D and the step's measured ms
    against the roofline's lower bound."""
    from repro_torch.configs import ShapeCfg, get_config
    from repro_torch.launch import cost_analysis, dryrun
    from repro_torch.models import lm
    from repro_torch.models.specs import abstract_tree
    from repro_torch.optim import AdamWConfig, adamw
    from repro_torch.train.step import make_train_step

    t0 = time.perf_counter()
    cfg = cfg or get_config(TRAIN_ARCH)
    records = {}
    if cells:
        for multi in (False, True):
            rec = dryrun.run_cell(*COST_CELL, multi, verbose=False)
            records[rec["mesh"]] = rec
    params = abstract_tree(lm.build_specs(cfg))
    tokens = torch.empty(batch, seq, dtype=torch.int32, device="meta")
    _, cost = cost_analysis.count_cost(
        make_train_step(cfg, AdamWConfig()), params,
        adamw.abstract_state(params), {"tokens": tokens})
    roof = cost_analysis.roofline(cost)
    if cost.product_flops != train["flop_counter_mode_flops"]:
        fail(f"cost: the counter's product FLOPs {cost.product_flops} on "
             f"meta tensors differ from FlopCounterMode's "
             f"{train['flop_counter_mode_flops']} on the real step")
    step_ms = train["step_ms"]
    bound_ms = roof.step_time_s * 1e3
    res = {"cells": records, "step_product_flops": cost.product_flops,
           "step_flops": cost.flops, "step_bytes": cost.bytes,
           "step_peak_live_bytes": cost.peak_live_bytes,
           "step_aten_ops": cost.ops, "roofline": roof.to_dict(),
           "flop_counter_mode_flops": train["flop_counter_mode_flops"],
           "train_flops": train["model_flops"],
           "model_flops_6nd": dryrun.model_flops(
               cfg, ShapeCfg("chip_smoke", seq, batch, "train")),
           "step_ms": step_ms, "bound_ms": bound_ms,
           "step_over_bound": step_ms / bound_ms if step_ms else None,
           "seconds": time.perf_counter() - t0}
    print(f"cost ({gpu}): " + "; ".join(
        f"{name}: peak/dev (temps split evenly) "
        f"{r['peak_bytes_per_device_temps_split_evenly'] / 2 ** 30:.3f} GiB, "
        f"temps {r['memory']['temp_bytes_global'] / 2 ** 30:.1f} GiB global, "
        f"{r['flops_global']:.4g} FLOPs and {r['bytes_global']:.4g} bytes "
        f"global, {r['microbatches']} microbatches, fits 80 GiB "
        f"{r['fits_80GiB']}" for name, r in records.items())
        + f"; the training step ({cfg.name}, {batch} x {seq}): product FLOPs "
        f"{cost.product_flops:.6g} on meta = FlopCounterMode's on the card; "
        f"all FLOPs {cost.flops:.6g}, bytes {cost.bytes:.6g} in "
        f"{cost.ops} aten ops, live peak {cost.peak_live_bytes / 2 ** 30:.2f}"
        f" GiB; train_flops {train['model_flops']:.6g}, 6ND "
        f"{res['model_flops_6nd']:.6g}; step {step_ms} ms against the "
        f"roofline's {bound_ms:.3f} ms ({roof.bottleneck}-bound): "
        f"{res['step_over_bound']}x; {res['seconds']:.2f} s", flush=True)
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import cuda

    gpu = gpu_line()
    print(gpu, flush=True)
    record: dict = {"gpu": gpu, "torch": torch.__version__,
                    "cuda": torch.version.cuda}
    t = time.perf_counter()
    build_s = cuda.build()
    cuda._libraries()
    print(f"build: {build_s:.1f} s for {len(cuda.SOURCES)} sources "
          f"(load {time.perf_counter() - t:.1f} s)", flush=True)
    for name, log in cuda.build_log.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    record["build_s"] = build_s
    record["build_log"] = cuda.build_log

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    t = time.perf_counter()
    errs = check_kernels(gen)
    print(f"kernels vs plain versions: bit-exact ({time.perf_counter() - t:.1f} s)",
          flush=True)
    t = time.perf_counter()
    timing = time_kernels(gen, errs, fused_n=BITMAP_DAYS // 2,
                          rows=BITMAP_USERS // COLS)
    print(f"kernels vs plain versions at the main path's shapes: bit-exact; "
          f"timing ({time.perf_counter() - t:.1f} s), device ms per call "
          "(torch.profiler; kernel / plain): " + json.dumps(
              {k: [v["device_ms"], v["plain_device_ms"]] for k, v in timing.items()}),
          flush=True)
    torch.cuda.empty_cache()

    cuda.reset_launches()
    run = main_path()
    launches = dict(cuda.launches)
    # a second, profiled pass (same seed, fresh device) for the breakdown
    gc.collect()
    torch.cuda.empty_cache()
    profiled: dict = {}
    prof = card_profile(lambda: profiled.update(main_path()), "main path")
    if prof is None:
        run["device"] = None
        print("main path, profiled pass: device busy not measured", flush=True)
    else:
        busy = sorted(((e.self_device_time_total, e.count, e.key)
                       for e in prof.key_averages()), reverse=True)
        busy_s = sum(us for us, _, _ in busy) / 1e6
        wall_s = profiled["phases"]["main_path_s"]
        run["device"] = {
            "busy_s": busy_s, "wall_s": wall_s,
            "idle_share": 1 - busy_s / wall_s,
            "top": [{"kernel": key[:80], "ms": us / 1e3, "count": n}
                    for us, n, key in busy[:8]]}
        print(f"main path, profiled pass: device busy {busy_s:.3f} s of "
              f"{wall_s:.3f} s wall (torch.profiler); top kernels "
              + json.dumps(run["device"]["top"][:4]), flush=True)
    print(f"main path ({gpu}): " + json.dumps(
        {k: round(v, 3) for k, v in run["phases"].items()}), flush=True)
    print("stats: " + json.dumps(run["stats"]), flush=True)
    print(f"bitmap index: {json.dumps(run['bitmap'])}; "
          f"{run['checks']} checks bit-exact; launches {json.dumps(launches)}",
          flush=True)
    require_launches(launches, KERNELS, "main path")
    del prof
    gc.collect()
    torch.cuda.empty_cache()

    serve = serving_phase(gen, errs, gpu)
    gc.collect()
    torch.cuda.empty_cache()
    recovery = recovery_phase(gen, errs, gpu)
    gc.collect()
    torch.cuda.empty_cache()
    endurance = endurance_phase(errs, gpu)
    require_launches(endurance["launches"], ("mlc_sense", "bitwise_reduce",
                                             "popcount_rows"), "endurance")
    gc.collect()
    torch.cuda.empty_cache()
    apps = applications_phase(errs, gpu)
    require_launches(apps["launches"], [k for k, n in APPS_LAUNCHES.items()
                                        if n], "applications")
    gc.collect()
    torch.cuda.empty_cache()
    placed = placed_phase(errs, gpu)
    require_launches(placed["launches"], KERNELS, "placed")
    gc.collect()
    torch.cuda.empty_cache()
    lm_run = lm_phase(errs, gpu)
    require_launches(lm_run["launches"], ("bitwise_reduce",), "lm")
    gc.collect()
    torch.cuda.empty_cache()
    train = train_phase(errs, gpu)
    require_launches(train["launches"], [k for k, n in TRAIN_LAUNCHES.items()
                                         if n], "train")
    gc.collect()
    torch.cuda.empty_cache()
    pipe = pipeline_phase(errs, gpu)
    cost = cost_phase(gpu, train)
    per_path = {"main": launches, "serving": serve["launches"],
                "recovery": recovery["launches"],
                "endurance": endurance["launches"],
                "applications": apps["launches"],
                "placed": placed["launches"], "lm": lm_run["launches"],
                "train": train["launches"]}
    total = {k: sum(p[k] for p in per_path.values()) for k in KERNELS}

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        tm = timing[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": total[name],
                        "max_abs_err": errs[name], "ms": tm["ms"],
                        "plain_ms": tm["plain_ms"], "bound_ms": tm["bound_ms"],
                        "bound_by": tm["bound_by"],
                        "library_ms": tm["library_ms"]})
    record.update(main_path=run, launches=per_path, kernels=kernels,
                  timing=timing, serving=serve, recovery=recovery,
                  endurance=endurance, applications=apps, placed=placed,
                  lm=lm_run, train=train, pipeline=pipe, cost=cost)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    print(gpu)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
