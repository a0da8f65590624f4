"""The bit-sliced range-scan cell on the CPU at a tiny size: its query
kind, configuration and traffic.

    python -m pytest mcbench/tests/test_mcbench_between.py
"""
import json

import pytest

from mcbench import data, harness, loadgen, queries, roofline

from mcbench.tests.test_mcbench_harness import BENCH, run_tiny

CELL = "bitweave-between-count"
CFG = json.loads((BENCH / "configs" / "bitweave-u32-mlc.json").read_text())
KIND = queries.kind("between_count")
MIX = loadgen.load_mix("between_count")


def test_the_configuration_and_mix_keep_the_published_shapes():
    assert CFG["code_bits"] == 32 and CFG["days"] == 0
    assert [c["name"] for c in CFG["extra_columns"]] == \
        [f"v{31 - i}" for i in range(32)]
    assert all(c["p_set"] == 0.5 for c in CFG["extra_columns"])
    assert data.groups(CFG)[3] == ("v25", "v24") and len(data.groups(CFG)) == 16
    assert (CFG["encoding"], CFG["columns_per_wordline"]) == ("mlc", 2)
    page_bits = CFG["ssd"]["page_kb"] * 1024 * 8
    assert CFG["users"] == 2 ** 29 and CFG["users"] // page_bits == 4096
    assert CFG["guarantees"]["results"] == "exact"
    assert sorted(CFG["reduced"]) == ["users"]
    qs = loadgen.distinct_queries(MIX, CFG)
    w = int(0.1 * 2 ** 32)
    assert len(qs) == 64 and all(hi - lo + 1 == w and 0 <= lo
                                 and hi < 2 ** 32 for _, lo, hi in qs)
    assert KIND.operand_bits(qs[0], CFG) == 32 * 2 ** 29
    assert KIND.bytes_needed(qs[0], CFG) == \
        16 * 2 ** 29 * roofline.VTH_BYTES + roofline.COUNT_BYTES
    # the same 64 ranges for every run seed, in another order
    for seed in (1, 2 ** 40 + 3):
        stream = loadgen.queries(MIX, CFG, seed)
        assert sorted(next(stream) for _ in range(64)) == sorted(qs)


def test_a_run_is_correct_pair_local_and_an_altered_predicate_is_not(
        monkeypatch):
    res = run_tiny(CELL, True)
    assert res["correct"] is True and res["failed"] == 0, res["checks"]
    assert res["attempted"] > 0
    rec = res["record"]
    assert rec["spans"]["ftl_spans"] == 0
    assert res["metrics"]["ftl_ms_per_query.range"]["value"] == 0
    assert res["metrics"]["sense_launches_per_query.range"]["value"] > 16
    from repro_torch.api.session import ComputeSession

    between = ComputeSession.between

    def wider(self, slices, lo, hi):
        return between(self, slices, lo, hi + (hi - lo) // 2)

    monkeypatch.setattr(ComputeSession, "between", wider)
    res = run_tiny(CELL, False)
    assert res["correct"] is False, res["checks"]
    assert res["checks"]["wrong_answers"]["value"] == res["attempted"]


@pytest.mark.parametrize("bad", [{"predicates": 0}, {"selectivity": 0},
                                 {"constants_seed": 1.5}, {"op": "and"}])
def test_the_mix_refuses_what_it_cannot_run(bad):
    with pytest.raises(ValueError):
        loadgen.check_mix({**MIX, **bad})


def test_the_cell_s_metric_readers():
    """Each new reader reads its key per query, reads a guard's 0 as 0,
    and gives None (the line leaves the metric out) where a record lacks
    its key, as a parent's would."""
    rec = {"queries": 100,
           "counters": {"sense_batches": 4_800},
           "spans": {"ftl_us": 0.0},
           "device": {"device_ops": [["mlc_sense_kernel<0, 8>", 10.0],
                                     ["bitwise_reduce_kernel<0>", 0.25],
                                     ["bitwise_reduce_kernel<1>", 0.15]]}}
    got = {n: harness.read_metric(n, rec) for n in (
        "sense_launches_per_query.range", "combine_ms_per_query.range",
        "ftl_ms_per_query.range")}
    assert got == pytest.approx({"sense_launches_per_query.range": 48.0,
                                 "combine_ms_per_query.range": 4.0,
                                 "ftl_ms_per_query.range": 0.0})
    rec["spans"]["ftl_us"] = 2_000.0
    assert harness.read_metric("ftl_ms_per_query.range", rec) == 0.02
    bare = {"queries": 100, "counters": {}, "spans": {}, "device": {}}
    assert all(harness.read_metric(n, bare) is None for n in got)
