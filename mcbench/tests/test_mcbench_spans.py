"""The span clock on synthetic intervals, and the span runner on the CPU.

    python -m pytest mcbench/tests/test_mcbench_spans.py
"""
import pytest

from mcbench import data, devtrace, harness, spanclock, spanrun

SPEC = harness.load_spec()
#: a tiny deployment of the same shape: 32 dies of 1 KiB pages, 2**15 users
TINY = {"users": 2 ** 15, "ssd": {"channels": 4, "dies_per_channel": 8,
                                  "planes_per_die": 1, "page_kb": 1}}
#: the cells in which each of the runner's metrics has something to read
READS = {"verify_ms_per_query.serve": ["ambit-weekly-steady"],
         "account_ms_per_query.serve": ["ambit-weekly-steady"],
         "gather_ms_per_query.scan": ["fig10-cohort-scan",
                                      "fig10-daypair-host"],
         "drain_wait_ms_per_query.scan": ["fig10-daypair-host"],
         "vth_draw_us_per_wordline.setup": [w["name"]
                                            for w in SPEC["workloads"]]}
#: the harness's calls into the program whose idle a program span holds
#: (at a tiny size a drain's receipt is shorter than the range around it)
CALLS = ("mcbench.session.popcount", "mcbench.session.materialize_async",
         "mcbench.serve.poll")


def test_innermost_span_takes_the_idle_and_the_rest_falls_to_labels():
    # device busy 0-10 and 90-100 of a 0-100 window: idle 10-90
    dev = [("k", 0, 10), ("k", 90, 100)]
    host = [(devtrace.WINDOW, 0, 100), ("mcbench.session.popcount", 5, 60),
            ("mcbench.build", 70, 80)]
    spans = [("dispatch", 20, 50), ("gather", 30, 40), ("lower", 12, 18),
             ("serve", 0, 100),                 # a request: left out
             ("account", 65, 75)]               # across two labels
    got = spanclock.idle_by_span(dev, host, spans, anchors=(0, 100))
    by_span, by_label = got["by_span"], got["by_label"]
    assert by_span == pytest.approx({
        "lower": 6e-6, "dispatch": 20e-6, "gather": 10e-6, "account": 10e-6,
        "mcbench.session.popcount": 14e-6,       # 10-12, 18-20, 50-60
        "mcbench.build": 5e-6, devtrace.UNLABELLED: 15e-6})
    assert by_label["mcbench.session.popcount"] == pytest.approx({
        "lower": 6e-6, "dispatch": 20e-6, "gather": 10e-6, "-": 14e-6})
    assert by_label[devtrace.UNLABELLED] == pytest.approx(
        {"account": 5e-6, "-": 15e-6})
    assert by_label["mcbench.build"] == pytest.approx(
        {"account": 5e-6, "-": 5e-6})
    assert spanclock.covered_share(by_label, "mcbench.session.popcount") == \
        pytest.approx(36 / 50)
    assert sum(by_span.values()) == pytest.approx(80e-6)
    assert spanclock.idle_by_span(dev, host[1:], spans, (0, 100)) is None


def test_two_anchors_recover_an_offset_and_a_skew():
    # the tracer's clock runs 0.1% fast and starts 5e6 us after Kineto's
    true = [(1_000.0, 1_500.0), (20_000.0, 20_250.0)]
    tracer = [(s * 1.001 - 5e6, e * 1.001 - 5e6) for s, e in true]
    to_prof = spanclock.clock_map(0.0 * 1.001 - 5e6, 40_000.0 * 1.001 - 5e6,
                                  0.0, 40_000.0)
    for (s, e), (ts, te) in zip(true, tracer):
        assert to_prof(ts) == pytest.approx(s, abs=1e-6)
        assert to_prof(te) == pytest.approx(e, abs=1e-6)
    # a child the map leaves a hair past its parent stays inside it
    segs = spanclock.innermost([("dispatch", 0.0, 10.0),
                                ("gather", 2.0, 10.0 + 1e-9)])
    assert segs == [("dispatch", 0.0, 2.0), ("gather", 2.0, 10.0)]


def test_totals_differences_read_an_older_program_as_empty():
    class Old:                       # a tracer without running totals
        wall_spans = []

    assert spanclock.totals(Old()) == {}
    before = {"lower": {"count": 2, "us": 10.0, "self_us": 8.0}}
    after = {"lower": {"count": 5, "us": 40.0, "self_us": 30.0},
             "verify": {"count": 1, "us": 3.0, "self_us": 3.0},
             "ftl": {"count": 4, "us": 9.0, "self_us": 9.0}}
    assert spanclock.since(before, after) == {
        "lower": {"count": 3, "us": 30.0, "self_us": 22.0},
        "verify": {"count": 1, "us": 3.0, "self_us": 3.0},
        "ftl": {"count": 4, "us": 9.0, "self_us": 9.0}}
    assert spanclock.since(after, after) == {}


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_a_traced_cpu_run_reports_the_span_metrics(cell):
    line = spanrun.run(SPEC, cell, 2 ** 31 + 977, 0.5, "cpu",
                       cfg_override=TINY, rate_per_s=20.0)
    assert harness.Cell.__name__ == "Cell"           # the hooks are undone
    assert line["correct"] is True and line["spans_dropped"] == 0
    want = {name for name, cells in READS.items() if cell in cells}
    assert want <= set(line["span_metrics"]), line["span_metrics"]
    assert all(v > 0 for v in line["span_metrics"].values())
    assert set(line["end_to_end"]) == {
        m["name"] for m in harness.cell_metrics(SPEC, cell, False)}
    # set-up: one aligned write, one Vth draw and one arena write a group
    setup = line["setup_span_totals"]
    cfg = {**harness.cell_files(SPEC, cell)[1], **TINY}
    groups = len(list(data.groups(cfg)))
    for cat in ("program", "program_draw", "program_store"):
        assert setup[cat]["count"] == groups, cat
    # no device on the CPU: the whole window is idle, and program spans
    # hold nearly all of what the calls into the program took
    idle = line["idle_by_span"]
    assert sum(idle.values()) == pytest.approx(
        line["record"]["window_s"], rel=0.05)
    assert line["spans_collected"] > 0
    calls = [c for c in CALLS if c in line["covered"]]
    assert calls
    for label in calls:
        assert line["covered"][label] > 0.5, line["idle_by_label"][label]
