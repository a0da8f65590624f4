"""``correct`` has to come out false: for the control (the program's own
wear path on, its ladder off) and for each fault a cell can have, planted
under the timed path.  The runs skip the harness's look for a card and
drive the rest of a run on the CPU at a tiny size.

    python -m pytest mcbench/tests
"""
import pytest

from mcbench import harness
from mcbench.tests.test_mcbench_harness import CELLS, run_tiny

CONTROL = "pe=10000,retention_hours=5000"
SERVE = [c for c in CELLS if c.startswith("ambit")]


def _wrong(res) -> bool:
    return res["correct"] is False and res["failed"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_control_comes_out_incorrect(cell):
    res = run_tiny(cell, False, faults=f"{CONTROL},seed=5")
    assert _wrong(res), res["checks"]
    assert res["checks"]["wrong_answers"]["value"] > 0


def _alter_counts(monkeypatch):
    from repro_torch.api.backends import Backend
    fused, count = Backend.sense_reduce_popcount, Backend.popcount
    monkeypatch.setattr(Backend, "sense_reduce_popcount",
                        lambda self, *a, **k: fused(self, *a, **k) + 1)
    monkeypatch.setattr(Backend, "popcount",
                        lambda self, *a, **k: count(self, *a, **k) + 1)


def _alter_words(monkeypatch):
    from repro_torch.api.backends import Backend
    sense = Backend.sense
    monkeypatch.setattr(Backend, "sense",
                        lambda self, *a, **k: sense(self, *a, **k) ^ 1)


@pytest.mark.parametrize("cell", CELLS)
def test_an_answer_altered_where_it_is_made(cell, monkeypatch):
    if cell == "fig10-daypair-host":
        _alter_words(monkeypatch)
    else:
        _alter_counts(monkeypatch)
    assert _wrong(run_tiny(cell, False))


@pytest.mark.parametrize("cell", CELLS)
def test_a_step_that_returns_its_state_unchanged(cell, monkeypatch):
    """The executor hands back the first outputs it ever made."""
    from repro_torch.api.executor import Executor
    real, first = Executor._execute_many, []

    def stale(self, nodes, n_bits, popcounts, rids=None):
        outs = tuple(real(self, nodes, n_bits, popcounts, rids))
        if not first:
            first.extend(outs)
        return tuple(first[i % len(first)].clone() for i in range(len(outs)))

    monkeypatch.setattr(Executor, "_execute_many", stale)
    assert _wrong(run_tiny(cell, False))


@pytest.mark.parametrize("cell", SERVE)
def test_half_of_a_batch_left_out(cell, monkeypatch):
    """From the window's start the engine dispatches the first half of each
    batch and drops the rest; those never resolve, and the wait past the
    window's close runs out."""
    from repro_torch.serve import QueryEngine
    real_form, real_measure = QueryEngine._form_batch, harness.Cell.measure

    def form(self):
        batch = real_form(self)
        dropped = {t.rid for t in batch[(len(batch) + 1) // 2:]}
        self._queue = [t for t in self._queue if t.rid not in dropped]
        return [t for t in batch if t.rid not in dropped]

    def measure(self, *a, **k):
        monkeypatch.setattr(QueryEngine, "_form_batch", form)
        return real_measure(self, *a, **k)

    monkeypatch.setattr(harness.Cell, "measure", measure)
    monkeypatch.setattr(harness, "DRAIN_GRACE_S", 2.0)
    res = run_tiny(cell, False)
    assert _wrong(res) and res["checks"]["missing_answers"]["value"] > 0


@pytest.mark.parametrize("cell", ["fig10-cohort-scan"])
def test_half_of_the_operands_left_out(cell, monkeypatch):
    """A range query folds only the first half of its operands."""
    from repro_torch.api.session import ComputeSession
    real = ComputeSession.chain
    monkeypatch.setattr(ComputeSession, "chain", lambda self, op, ops: real(
        self, op, list(ops)[: max(1, len(list(ops)) // 2)]))
    assert _wrong(run_tiny(cell, False))


def test_control_words_differ_in_bits_not_shape():
    """The control's daypair answers keep their shape: wrong words, not a
    missing answer."""
    res = run_tiny("fig10-daypair-host", False, faults=f"{CONTROL},seed=9")
    assert res["checks"]["wrong_words"]["value"] > 0
    assert res["checks"]["missing_answers"]["value"] == 0
