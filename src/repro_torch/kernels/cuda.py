"""Build, load and launch the hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` into a shared library with a plain C
interface, loaded with :mod:`ctypes` (no PyTorch headers, so a build takes
seconds).  All sources compile in parallel, one ``nvcc`` each, at the first
launch, into ``build/repro_torch_kernels/`` at the root of the checkout.  A
library's file name carries a hash of its sources and flags, so an edited
source rebuilds and an unchanged one loads as is.

Nothing here runs when the module is imported.  A failed build, or a launch
the CUDA runtime refuses, raises; nothing falls back to the plain versions.

``launches`` counts, per kernel, the launches its wrapper made: a run can
show that its path went through the kernels.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Sequence

import torch

from repro_torch.kernels.ref import MAX_REFS

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("mlc_sense", "fused", "bitops", "popcount")
HEADERS = ("sense.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: launches per kernel wrapper (zero them with :func:`reset_launches`)
launches: Dict[str, int] = {"mlc_sense": 0, "sense_reduce": 0,
                            "sense_reduce_popcount": 0, "bitwise_reduce": 0,
                            "popcount_rows": 0, "sense_popcount": 0,
                            "mlc_sense_multi": 0}
#: per-source ``nvcc`` output (register / spill report) of the last build
build_log: Dict[str, str] = {}

KIND_CODE = {"lsb": 0, "msb": 1, "sbr": 2, "parity": 3}
OP_CODE = {"and": 0, "or": 1, "xor": 2}

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_SIGNATURES = {
    "mcf_mlc_sense": ("mlc_sense", [_P, _P, _P, _I, _P, _I64, _I64, _I, _I,
                                    _I, _P, _P]),
    "mcf_sense_reduce": ("fused", [_P, _P, _I, _P, _I64, _I64, _I, _I, _I,
                                   _I, _I, _P, _P]),
    "mcf_sense_reduce_popcount": ("fused", [_P, _P, _I, _P, _P, _I64, _I64,
                                            _I, _I, _I, _I, _I, _P, _P]),
    "mcf_bitwise_reduce": ("bitops", [_P, _I, _P, _I64, _I, _I, _P]),
    "mcf_popcount_rows": ("popcount", [_P, _P, _P, _I64, _I64, _P]),
    "mcf_sense_popcount": ("mlc_sense", [_P, _P, _P, _I, _P, _I64, _I64,
                                         _I64, _I, _I, _I, _I, _P, _P]),
    "mcf_mlc_sense_drain": ("mlc_sense", [_P, _P, _P, _I, _P, _P, _I64, _I64,
                                          _I64, _P, _I64, _I, _I, _I, _P, _P,
                                          _P]),
    "mcf_mlc_sense_multi": ("mlc_sense", [_P, _P, _P, _I, _P, _I64, _I64,
                                          _I64, _I, _P, _P, _P, _P]),
}

#: operand pointers one ``mcf_bitwise_reduce`` launch takes (``kMaxOperands``
#: in ``csrc/bitops.cu``); a wider fold runs in passes
MAX_OPERANDS = 64
#: the host array of operand pointers the entry point copies into its
#: kernel-parameter struct
Pointers = _P * MAX_OPERANDS


#: slot tables one sense launch takes (``kMaxTables`` in ``csrc/sense.cuh``)
MAX_TABLES = 32
#: the host arrays of base pointers, slot-table pointers and row ends the
#: sense entry points copy into their kernel-parameter struct
TablePointers = _P * MAX_TABLES
TableEnds = _I64 * MAX_TABLES


#: read plans one ``mcf_mlc_sense_multi`` launch takes (``kMaxPlans`` in
#: ``csrc/mlc_sense.cu``); more run in several launches
MAX_PLANS = 8


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for part in (f"{name}.cu", *HEADERS):
        h.update((CSRC / part).read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build() -> float:
    """Compile every source whose library is missing, all in parallel.
    Returns the seconds spent; raises with the compiler's output on failure."""
    t0 = time.perf_counter()
    todo = [(n, _library_path(n)) for n in SOURCES if not _library_path(n).exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name, out in todo:
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        build_log[name] = log
        if proc.returncode != 0:
            failed.append(f"nvcc {name}.cu exited {proc.returncode}:\n{log}")
            continue
        os.replace(tmp, out)        # atomic: a concurrent build sees whole files
    if failed:
        raise RuntimeError("CUDA kernel build failed\n" + "\n".join(failed))
    return time.perf_counter() - t0


@functools.lru_cache(maxsize=None)
def _libraries() -> Dict[str, ctypes.CDLL]:
    build()
    return {name: ctypes.CDLL(str(_library_path(name))) for name in SOURCES}


@functools.lru_cache(maxsize=None)
def _entry(symbol: str):
    lib_name, argtypes = _SIGNATURES[symbol]
    libs = _libraries()
    fn = getattr(libs[lib_name], symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _error_string(err: int) -> str:
    fn = _libraries()["mlc_sense"].mcf_error_string
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_char_p
    return fn(err).decode()


def current_stream() -> int:
    """The current CUDA stream of the current device, as a raw handle:
    PyTorch's own C accessor, which builds no ``torch.cuda.Stream``."""
    return torch._C._cuda_getCurrentRawStream(torch._C._cuda_getDevice())


def launch(kernel: str, symbol: str, *args, count: int = 1) -> None:
    """Call one C entry point on the current stream, count its ``count``
    launches of ``kernel``, and raise if the CUDA runtime refused one."""
    err = _entry(symbol)(*args, current_stream())
    if err != 0:
        raise RuntimeError(f"CUDA kernel {kernel} failed to launch: "
                           f"error {err} ({_error_string(err)})")
    launches[kernel] += count


#: references each read kind compares against (parity: ``n_refs``)
_KIND_REFS = {"lsb": 1, "msb": 2, "sbr": 4}


def sense_args(refs: Sequence[float], kind: str,
               n_refs: int) -> tuple[int, int, ctypes.Array]:
    """(kind code, n_refs, float[8] references) for a sense entry point."""
    vals = [float(r) for r in refs]
    need = n_refs if kind == "parity" else _KIND_REFS.get(kind)
    if need is None:
        raise ValueError(f"unknown read kind {kind!r}")
    if not 1 <= need <= len(vals) <= MAX_REFS:
        raise ValueError(f"{kind} read needs {need} of at most {MAX_REFS} "
                         f"references, got {len(vals)}")
    padded = (ctypes.c_float * MAX_REFS)(*vals, *([0.0] * (MAX_REFS - len(vals))))
    return KIND_CODE[kind], n_refs, padded


def table_args(rows) -> tuple[ctypes.Array, ctypes.Array]:
    """(base pointers, slot-table pointers) of
    :class:`~repro_torch.kernels.rows.Rows` on the card, at most
    :data:`MAX_TABLES` tables; raises on a buffer or table of the wrong
    kind."""
    dev, cols = rows.device, rows.cols
    bases, slots = [], []
    for buf, table in zip(rows.bufs, rows.slots):
        if not (buf.is_cuda and buf.dtype == torch.float32
                and buf.is_contiguous() and buf.device == dev
                and buf.shape[1] == cols):
            raise ValueError("row buffers must be contiguous float32 (slots, "
                             f"{cols}) tensors on {dev}")
        if not (table.dtype == torch.int32 and table.is_contiguous()
                and table.device == dev):
            raise ValueError(f"slot tables must be contiguous int32 on {dev}")
        bases.append(buf.data_ptr())
        slots.append(table.data_ptr())
    return TablePointers(*bases), TablePointers(*slots)


def check_cuda(name: str, t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Validate a kernel input; returns it contiguous (a copy only where
    it is not)."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    return t if t.is_contiguous() else t.contiguous()
