"""With the timed path broken underneath, a run's ``correct`` comes out
false: each fault a cell can have (one card, so no exchange between cards
to leave out), planted in the program and driven through the rest of the
run on the CPU."""

import functools

import pytest

from portbench import faults


@pytest.mark.parametrize("fault", sorted(faults.TRAIN))
@pytest.mark.parametrize("workload", ["bst-train-short", "bst-train-longhist"])
def test_train_fault_is_caught(small_run, monkeypatch, workload, fault):
    faults.TRAIN[fault](monkeypatch.setattr)
    _, res = small_run(workload)
    assert not res.correct, res.checks


@pytest.mark.parametrize("fault", sorted(faults.SERVE))
@pytest.mark.parametrize("workload", ["din-serve-rank", "din-serve-single"])
def test_serve_fault_is_caught(small_run, monkeypatch, workload, fault):
    faults.SERVE[fault](monkeypatch.setattr)
    _, res = small_run(workload)
    assert not res.correct, res.checks


def test_unanswered_request_is_not_correct(small_run, monkeypatch):
    """A candidate whose answer never comes fails its request and the run."""
    from portbench.kinds import serve

    monkeypatch.setattr(serve, "drive", functools.partial(serve.drive, drain=0.0))
    from recalgorithm_tpu_torch.serving.server import BatchingPredictor

    inner = BatchingPredictor._flush

    def drop_last(self, pending):
        return inner(self, pending[:-1]) if len(pending) > 1 else inner(self, pending)

    monkeypatch.setattr(BatchingPredictor, "_flush", drop_last)
    _, res = small_run("din-serve-single")
    assert not res.correct and res.failed > 0
