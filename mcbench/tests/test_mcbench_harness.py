"""The harness on the CPU at a tiny size, and the rules BENCHMARK.json keeps.

    python -m pytest mcbench/tests
"""
import ast
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mcbench import devtrace, harness, loadgen

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "mcbench"
SPEC = harness.load_spec()
#: a tiny deployment of the same shape: 32 dies of 1 KiB pages, 2**15 users
TINY = {"users": 2 ** 15, "ssd": {"channels": 4, "dies_per_channel": 8,
                                  "planes_per_die": 1, "page_kb": 1}}
TINY_RATE = 20.0
CELLS = [w["name"] for w in SPEC["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}


def run_tiny(cell, trace, seed=2 ** 31 + 977, seconds=0.5, **kw):
    return harness.run_cell(SPEC, cell, seed, seconds, trace, "cpu",
                            cfg_override=TINY, rate_per_s=TINY_RATE, **kw)


def test_benchmark_json_keeps_the_rules():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["mcbench"] and SPEC["command"][1] == "mcbench/run.py"
    assert 1 <= SPEC["run_seconds"] <= 51
    for group, keys in KEYS.items():
        names = [e["name"] for e in SPEC[group]]
        assert len(set(names)) == len(names), group
        for e in SPEC[group]:
            extra = {"workloads"} if group in ("end_to_end", "per_layer") else set()
            assert keys <= set(e) <= keys | extra, (group, e["name"])
            assert NAME.match(e["name"]), e["name"]
            for text in ("why", "layer", "source"):
                if text in e:
                    assert 1 <= len(e[text]) <= 200 and "\n" not in e[text] \
                        and "\t" not in e[text]
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert (BENCH / "metrics" / f"{m['name']}.py").exists(), m["name"]
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for c in SPEC["configs"]:
        assert c["file"].startswith("mcbench/") and (ROOT / c["file"]).exists()
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])
        assert all(NAME.match(k) for k in c["reduced"])
        assert any(w["config"] == c["name"] for w in SPEC["workloads"])
    pairs = {(w["config"], w["traffic"]) for w in SPEC["workloads"]}
    assert len(pairs) == len(SPEC["workloads"])
    for w in SPEC["workloads"]:
        assert w["chips"] == 1 and NAME.match(w["traffic"])
        assert (BENCH / "traffic" / f"{w['traffic']}.json").exists()
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_every_cell_reports_what_its_metrics_move():
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    for cell in CELLS:
        reported = {m["name"] for m in harness.cell_metrics(SPEC, cell, False)}
        assert "setup_s" in reported and len(reported) >= 2, cell
        assert harness.cell_metrics(SPEC, cell, True), cell
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            moved = {x["name"] for x in harness.cell_metrics(SPEC, cell, False)}
            assert m["moves"] in moved, (m["name"], cell)
    layers = {}
    for m in SPEC["per_layer"]:
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_jax_or_reference_package_anywhere_in_the_harness():
    for path in BENCH.rglob("*.py"):
        tops = {name.partition(".")[0] for name in _imports(path)}
        assert not tops & set(harness.FORBIDDEN), (path, tops)
    ref_tops = {n.partition(".")[0] for n in _imports(BENCH / "reference.py")}
    assert "repro_torch" not in ref_tops
    # the reference's own inputs, and the query kinds whose answers it
    # computes
    for path in [BENCH / "data.py", BENCH / "loadgen.py",
                 *(BENCH / "queries").glob("*.py")]:
        tops = {n.partition(".")[0] for n in _imports(path)}
        assert "repro_torch" not in tops, path


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_lookalike.sub", sys)
    assert "repro" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.api", sys)
    assert "repro" in harness.forbidden_modules()


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_on_the_cpu_and_is_correct(cell, trace):
    res = run_tiny(cell, trace)
    rec = res.pop("record")
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res) == keys + (["checks"] if not rec.get("device") else
                                ["breakdown", "checks"])
    assert res["correct"] is True and res["failed"] == 0, res["checks"]
    assert res["attempted"] > 0
    assert all(c["limit"] == 0 for c in res["checks"].values())
    assert rec["spans"].get("ftl_spans", 0) == 0     # no copyback realignment
    want = {m["name"] for m in harness.cell_metrics(SPEC, cell, trace)
            if m["source"] != "device_trace"}
    assert want <= set(res["metrics"]), (want, res["metrics"])
    for v in res["metrics"].values():
        assert v["value"] > 0 or v["unit"] == "%"
    # no device trace on the CPU: no device number is written
    assert not any(m["name"] in res["metrics"] for m in SPEC["per_layer"]
                   if m["source"] == "device_trace")


def test_mixes_give_every_seed_the_same_work():
    cfg = json.loads((BENCH / "configs" / "fig10-bitmap-mlc.json").read_text())
    mix = loadgen.load_mix("cohort_scan")
    for seed in (1, 2 ** 31 + 5):
        qs = loadgen.queries(mix, cfg, seed)
        block = [next(qs) for _ in range(8)]
        assert sorted(q[3] for q in block) == list(range(8, 16))
        assert all(q[1] == "and" and 0 <= q[2] <= 15 - q[3] for q in block)
    assert len(loadgen.distinct_queries(mix, cfg)) == 36
    acfg = json.loads((BENCH / "configs" / "ambit-weekly-mlc.json").read_text())
    for name in ("weekly_steady", "weekly_burst"):
        mix = loadgen.load_mix(name)
        a = loadgen.arrivals(mix, 3, 20.0, 50.0)
        b = loadgen.arrivals(mix, 2 ** 40 + 1, 20.0, 50.0)
        assert len(a) == len(b) == 1000
        assert a != b and all(0 <= t < 20.0 for t in a + b)
        if mix["arrivals"] == "on_off":
            assert all(t % 1.0 < 0.25 for t in a)
        sched = loadgen.schedule(mix, acfg, 3, 20.0, 50.0)
        ws = [q[1] for _, q in sched[:300]]
        assert ws.count(2) == ws.count(3) == ws.count(4) == 100
        assert all(28 <= q[2] <= 34 for _, q in sched)


def test_devtrace_reduces_a_window():
    dev = [("k1", 0, 10), ("k1", 5, 20), ("Memcpy DtoH (Device -> Pinned)", 30, 40),
           ("k2", 90, 120), ("outside", 200, 300)]
    host = [("mcbench.window", 0, 100), ("mcbench.session.popcount", 20, 30),
            ("mcbench.build", 40, 60)]
    s = devtrace.summarize(dev, host)
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["busy_s"] == pytest.approx(40e-6)          # 0-20, 30-40, 90-100
    assert s["dtoh_s"] == pytest.approx(10e-6)
    assert s["work_s"] == pytest.approx(35e-6)           # 10 + 15 + 10
    idle = dict(s["idle_gaps"])
    assert idle["mcbench.session.popcount"] == pytest.approx(10e-6)
    assert idle["mcbench.build"] == pytest.approx(20e-6)
    assert idle[devtrace.UNLABELLED] == pytest.approx(30e-6)
    assert devtrace.summarize(dev, []) is None
    assert devtrace.summarize([("k", 200, 300)], host) is None


def test_every_metric_reader_reads_a_record():
    rec = {"loop": "closed", "setup_s": 30.0, "window_s": 20.0,
           "queries": 100, "operand_bits": 10 ** 12,
           "program": {"wordlines": 100, "seconds": 0.1},
           "makespan_us": 5e5, "bytes_needed": 10 ** 12, "result_bytes": 10 ** 10,
           "counters": {"sense_waves": 300}, "spans": {"lower_us": 2e5,
                                                       "lower_spans": 40},
           "device": {"window_s": 20.0, "busy_s": 15.0, "work_s": 14.0,
                      "dtoh_s": 1.0},
           "serve": {"requests": 100, "latencies_ms": list(range(1, 101)),
                     "queue_waits_ms": [1.0] * 100, "tickets_completed": 400,
                     "batches": 50}}
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        value = harness.read_metric(m["name"], rec)
        assert value is not None and value > 0, m["name"]
    rec["device"]["work_s"] = 300.0       # a share never above 100% here
    assert harness.read_metric("sense_roofline.scan", rec) < 100


def test_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for hosts without one")
    got = subprocess.run([sys.executable, "mcbench/run.py", "--workload",
                          CELLS[0], "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert got.returncode != 0 and got.stdout.strip() == ""


@pytest.mark.gpu
def test_run_needs_the_program(tmp_path):
    """In a directory holding only BENCHMARK.json and mcbench/, a run
    fails and prints no result."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: without one every run refuses first")
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "mcbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    got = subprocess.run([sys.executable, "mcbench/run.py", "--workload",
                          CELLS[0], "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300)
    assert got.returncode != 0 and got.stdout.strip() == ""


@pytest.mark.parametrize("bad, why", [
    ({"op": "and"}, "read by nothing"),              # ambit reads no op
    ({"clients": 2}, "read by nothing"),             # an open loop has none
    ({"arrivals": "bursty"}, "arrivals"),
    ({"query": "no_such_kind"}, "no query kind"),
    ({"weeks": {"values": [2], "draw": "zipf", "s": 1.0}}, "block"),
    ({"end_day": {"draw": "sorted"}}, "position choice"),
])
def test_a_mix_setting_nothing_reads_is_refused(bad, why):
    mix = {**loadgen.load_mix("weekly_steady"), **bad}
    with pytest.raises(ValueError, match=why):
        loadgen.check_mix(mix)


@pytest.mark.parametrize("bad", [{"clients": 0}, {"clients": 1.5},
                                 {"op": "nand"},
                                 {"ops": {"values": ["and"]}}])
def test_a_closed_mix_refuses_what_it_cannot_run(bad):
    with pytest.raises(ValueError):
        loadgen.check_mix({**loadgen.load_mix("cohort_scan"), **bad})


def test_size_and_position_choices_are_data():
    assert loadgen.sizes({"range": [2, 4]}) == [2, 3, 4]
    zipf = loadgen.sizes({"values": [2, 3, 4], "draw": "zipf", "s": 1.0,
                          "block": 11})
    assert zipf == [2] * 6 + [3] * 3 + [4] * 2
    rng = np.random.default_rng(0)
    picks = [loadgen.position(rng, 7, {"draw": "zipf", "s": 1.2})
             for _ in range(2000)]
    assert picks.count(0) > 3 * picks.count(6) and max(picks) == 6
    cfg = json.loads((BENCH / "configs" / "ambit-weekly-mlc.json").read_text())
    mix = {**loadgen.load_mix("weekly_steady"),
           "weeks": {"values": [2, 3, 4], "draw": "zipf", "s": 1.0,
                     "block": 11},
           "end_day": {"draw": "zipf", "s": 1.2}}
    for seed in (3, 2 ** 40 + 7):
        sched = loadgen.schedule(loadgen.check_mix(mix), cfg, seed, 11.0, 1.0)
        ws = [q[1] for _, q in sched]
        assert (ws.count(2), ws.count(3), ws.count(4)) == (6, 3, 2)


@pytest.mark.parametrize("cell, override", [
    ("fig10-cohort-scan", {"clients": 3}),
    ("fig10-cohort-scan", {"op": "or", "groups_per_query": {"range": [2, 3]}}),
    ("fig10-daypair-host", {"clients": 2, "ops": {"values": ["xor"]}}),
    ("ambit-weekly-steady", {"weeks": {"values": [2, 3, 4], "draw": "zipf",
                                       "s": 1.0, "block": 11},
                             "end_day": {"draw": "zipf", "s": 1.2}}),
])
def test_a_mix_changed_as_data_runs_and_is_judged(cell, override, monkeypatch):
    """What a later cell would set in its own mix file alone: several
    closed-loop clients, another op, skewed draws.  Each runs correct, and
    an answer altered where it is made still fails it."""
    res = run_tiny(cell, False, mix_override=override)
    assert res["correct"] is True and res["attempted"] > 0, res["checks"]
    from repro_torch.api.executor import Executor
    real = Executor._execute_many
    monkeypatch.setattr(Executor, "_execute_many", lambda self, *a, **k: tuple(
        o ^ 1 if o.dim() else o + 1 for o in real(self, *a, **k)))
    res = run_tiny(cell, False, mix_override=override)
    assert res["correct"] is False and res["failed"] > 0, res["checks"]
