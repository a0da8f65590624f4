"""The Fig-10 segmentation cell on the CPU at a tiny size: its query kind,
configuration and traffic.

    python -m pytest mcbench/tests/test_mcbench_yuv.py
"""
import json

import pytest

from mcbench import data, harness, loadgen, queries, roofline

from mcbench.tests.test_mcbench_harness import BENCH, SPEC, TINY, run_tiny

CELL = "fig10-yuv-segment"
CFG = json.loads((BENCH / "configs" / "fig10-yuv-tlc.json").read_text())
KIND = queries.kind("yuv_segment")


def test_the_configuration_keeps_the_published_shapes():
    w, h = CFG["frame_px"]
    assert (w, h) == (800, 600) and CFG["image_px"] == w * h
    assert CFG["users"] == CFG["images_per_batch"] * CFG["image_px"]
    batches = CFG["images"] // CFG["images_per_batch"]
    assert CFG["days"] == batches * CFG["classes"] * 3 and CFG["classes"] == 4
    assert (CFG["encoding"], CFG["columns_per_wordline"]) == ("tlc", 3)
    page_bits = CFG["ssd"]["page_kb"] * 1024 * 8
    assert CFG["users"] % page_bits == 0 and CFG["users"] // page_bits == 1875
    assert CFG["guarantees"]["results"] == "exact"
    assert sorted(CFG["reduced"]) == ["images"]
    assert {"p_active", "images_per_batch"} <= set(CFG["assumed"])
    # a query is one batch: its 4 classes' Y, U, V triples, read once each
    groups = data.groups(CFG)
    qs = loadgen.distinct_queries(loadgen.load_mix("yuv_segment"), CFG)
    assert qs == [("yuv_segment", b) for b in range(batches)]
    assert KIND.operand_bits(qs[0], CFG) == 12 * CFG["users"] == 2_949_120_000
    assert KIND.bytes_needed(qs[0], CFG) == \
        4 * CFG["users"] * roofline.VTH_BYTES + 4 * roofline.COUNT_BYTES
    assert KIND._classes(qs[1], CFG) == groups[4:8]
    assert groups[5] == ("day15", "day16", "day17")
    stream = loadgen.queries(loadgen.load_mix("yuv_segment"), CFG, 2 ** 40 + 3)
    assert sorted(next(stream) for _ in range(batches)) == qs


def test_each_class_is_one_single_reference_tlc_sense():
    cell = harness.Cell(SPEC, CELL, 11, False, "cpu", cfg_override=TINY)
    for q in loadgen.distinct_queries(cell.mix, cell.cfg):
        for expr in KIND.roots(cell.sess, q, cell.cfg):
            plan = cell.sess.lower(expr)
            assert not plan.steps and len(plan.groups) == 1
            assert plan.groups[0].plan.op.startswith("tlc:and:")
            assert len(plan.groups[0].plan.refs) == 1
    cell.sess.reset_stats()
    out = cell.measure(0.3)
    sess = cell.sess
    assert sess.encoded_sense_units == sess.sensing_phases == 4 * out["queries"]
    cell.close()


def test_a_run_is_correct_and_one_altered_count_is_not(monkeypatch):
    res = run_tiny(CELL, False)
    assert res["correct"] is True and res["failed"] == 0, res["checks"]
    assert res["attempted"] > 0
    closed = harness.Loop.closed

    def one_count_off(self, *a, **k):
        out = closed(self, *a, **k)
        q, got = out["answers"][0]
        out["answers"][0] = (q, got[:2] + [got[2] + 1] + got[3:])
        return out

    monkeypatch.setattr(harness.Loop, "closed", one_count_off)
    res = run_tiny(CELL, False)
    assert res["correct"] is False, res["checks"]
    assert res["checks"]["wrong_answers"]["value"] == 1


@pytest.mark.parametrize("bad", [{"op": "and"}, {"groups_per_query": {"range": [1, 2]}},
                                 {"rate_per_s": 10}, {"clients": 0}])
def test_the_mix_refuses_what_nothing_reads(bad):
    mix = {**loadgen.load_mix("yuv_segment"), **bad}
    with pytest.raises(ValueError):
        loadgen.check_mix(mix)
