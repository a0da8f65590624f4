"""The port's Fig-10 applications against the JAX package's.

The system model is pure Python in both packages: every projection must be
float-equal.  The functional runs draw their operand bits from the same
numpy generator in both packages, so the result words, popcounts, ledger
summaries and plan counters must be equal too.  The four example scripts
of the port must run on the CPU.
"""
import runpy
import sys
from pathlib import Path

import numpy as np
import torch

from repro.api import ComputeSession as RefSession
from repro.data import BitmapFilter as RefBitmapFilter
from repro.flash import system as ref_system
from repro.flash.geometry import SSDConfig as RefConfig
from repro_torch.api.hostio import to_numpy
from repro_torch.api.session import ComputeSession
from repro_torch.api.workloads import run_workload
from repro_torch.data import BitmapFilter
from repro_torch.flash import system
from repro_torch.flash.geometry import SSDConfig

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
CFG = dict(channels=2, dies_per_channel=4, page_kb=1)
#: session stats both packages keep, from the plan structure down
PLAN_STATS = ("in_flash_senses", "sense_items", "sense_batches",
              "sense_waves", "megakernel_calls", "fused_reduce_calls",
              "tiled_megakernel_splits", "max_concurrent_dies",
              "plan_cache", "plans_verified")


def _workloads(mod):
    return [mod.image_segmentation(), mod.image_segmentation(50),
            mod.image_encryption(), mod.image_encryption(700),
            mod.bitmap_index(1), mod.bitmap_index(6),
            mod.bitmap_index(12, users=1 << 25)]


def _sessions(seed=0):
    return (RefSession(config=RefConfig(**CFG), backend="sim", seed=seed),
            ComputeSession(device="cpu", config=SSDConfig(**CFG), seed=seed))


def test_system_model_matches_reference():
    """Workload definitions, per-wave times of every paradigm and op, and
    the speedup tables of the three Fig-10 workloads are float-equal."""
    ref_model, model = ref_system.SystemModel(), system.SystemModel()
    assert system.PARADIGMS == ref_system.PARADIGMS
    for ref_w, w in zip(_workloads(ref_system), _workloads(system)):
        assert (w.name, w.op, w.k_operands, w.operand_bits, w.items,
                w.result_to_host, w.result_write_back) == \
            (ref_w.name, ref_w.op, ref_w.k_operands, ref_w.operand_bits,
             ref_w.items, ref_w.result_to_host, ref_w.result_write_back)
        assert system.speedup_table(w) == ref_system.speedup_table(ref_w)
    for p in system.PARADIGMS:
        for op in ("and", "or", "xor", "xnor"):
            for k in (2, 3, 16, 30, 360):
                for flags in ((True, False), (False, True), (False, False)):
                    assert model.wave_time_us(p, op, k, *flags) == \
                        ref_model.wave_time_us(p, op, k, *flags)
                assert model.exec_time_us(p, op, k, 3 << 24) == \
                    ref_model.exec_time_us(p, op, k, 3 << 24)


def test_run_workload_matches_reference():
    """The three workloads at 3 pages (+ a ragged tail) per operand, run
    through ``Workload.run_functional`` in the JAX package and
    ``run_workload`` in the port: the same result words, ledger summary,
    plan counters and projection."""
    n = 3 * 8192 + 40
    for ref_w, w in zip(_workloads(ref_system)[0:6:2],
                        _workloads(system)[0:6:2]):
        ref, port = _sessions()
        want = ref_w.run_functional(session=ref, n_bits=n, seed=4)
        got = run_workload(w, session=port, n_bits=n, seed=4)
        np.testing.assert_array_equal(to_numpy(got["result_packed"]),
                                      np.asarray(want["result_packed"]))
        assert got["measured"] == want["measured"], w.name
        assert got["projection"] == want["projection"], w.name
        for key in PLAN_STATS:
            assert got["stats"][key] == want["stats"][key], (w.name, key)
    # a workload's own session: the default SSD on the asked device
    again = system.image_encryption().run_functional(device="cpu", seed=4)
    assert again["stats"]["device"] == "cpu"
    assert again["stats"]["in_flash_senses"] == 1


def test_bitmap_filter_matches_reference():
    """Four pairs of filter bitmaps over 20,000 samples (3 pages, padded):
    the same selection mask and count as numpy and as the JAX package,
    the same ledger summary and plan counters; the chain fuses into one
    sense->reduce pass for the mask and one sense->reduce->popcount pass
    for the count."""
    rng = np.random.default_rng(8)
    n = 20_000
    bitmaps = [(rng.random(n) < 0.8).astype(np.uint8) for _ in range(8)]
    ref_s, port_s = _sessions(seed=17)
    filters = (RefBitmapFilter(n, session=ref_s),
               BitmapFilter(n, session=port_s))
    pairs = [(f"f{i}", f"f{i + 1}") for i in range(0, 8, 2)]
    want = np.logical_and.reduce(bitmaps)
    results = []
    for bf in filters:
        for i in range(0, 8, 2):
            bf.add_pair(f"f{i}", bitmaps[i], f"f{i + 1}", bitmaps[i + 1])
        mask, count = bf.select(pairs), bf.count(pairs[:3])
        results.append((mask, count, bf.session.stats()))
        assert bf.n_bits == 3 * 8192
    (rm, rc, rs), (pm, pc, ps) = results
    np.testing.assert_array_equal(pm, want)
    np.testing.assert_array_equal(rm, want)
    assert pc == rc == int(np.logical_and.reduce(bitmaps[:6]).sum())
    assert ps["ledger"] == rs["ledger"]
    for key in PLAN_STATS:
        assert ps[key] == rs[key], key
    assert ps["megakernel_calls"] == 2


def test_port_examples_run_on_cpu(tmp_path, monkeypatch, capsys):
    """Each ``examples/torch_*.py`` checks itself against numpy and runs
    to its end with ``--device cpu`` (1 kB pages, the kernels' plain
    versions)."""
    monkeypatch.chdir(tmp_path)
    names = ("torch_quickstart", "torch_bitmap_index",
             "torch_image_encryption", "torch_serve_bitmap")
    for name in names:
        extra = (["--trace-out", str(tmp_path / "trace.json")]
                 if name == "torch_serve_bitmap" else [])
        monkeypatch.setattr(sys, "argv", [name, "--device", "cpu", *extra])
        runpy.run_path(str(ROOT / "examples" / f"{name}.py"),
                       run_name="__main__")
    out = capsys.readouterr().out
    assert "bit-exact=True" in out and "bit-exact=False" not in out
    assert "matches host oracle" in out and "bit-exact OK" in out
    assert (tmp_path / "trace.json").exists()
