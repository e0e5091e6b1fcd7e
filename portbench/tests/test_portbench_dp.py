"""The data-parallel cell (``kinds/train_dp.py``): its files resolve, its
reference on one rank is BST's, a 4-rank run on the CPU (gloo) is correct,
a fault planted under rank 0's timed path makes it incorrect, and a rank
that fails ends the run with an error, not a hang."""

import sys
import time

import pytest
import torch

from portbench import harness
from portbench.trace import Trace

CELL = "bst-train-dp4"


def test_cell_files_resolve():
    """The cell's file and its reader (``BENCHMARK.json`` leaves the cell out
    while its runs spread over the driver's cut: PERF.md §7)."""
    cell = harness.cell(CELL)
    assert cell["kind"] == "train_dp" and cell["chips"] == 4
    assert cell["config"] == "bst-wechat" and len(cell["why"]) <= 200
    harness.config(cell["config"])
    assert set(cell["limits"]) == {"loss_gap", "grad_gap", "grad_gap_median", "change_gap",
                                   "change_gap_worst"}
    module = harness.metric_module("nccl_ms.train")
    assert (module.UNIT, module.SOURCE, module.MOVES, module.KIND) == (
        "ms/step", "device_trace", "train_ex_s", cell["kind"])


def test_nccl_reader_on_a_synthetic_trace():
    events = [("ncclDevKernel_AllReduce_Sum_f32_RING_LL", 0, 300.0),
              ("ncclDevKernel_AllGather_RING_LL", 5, 100.0), ("sgemm", 9, 900.0)]
    trace = Trace(kind="train", cfg={}, window_s=1.0, busy_s=0.5, events=events,
                  breakdown={}, data={"steps": 4, "examples": 4})
    read = harness.metric_module("nccl_ms.train").read
    assert read(trace) == pytest.approx(0.1)
    trace.events = events[2:]
    assert read(trace) is None


def test_reference_on_one_rank_is_bst():
    """One rank's stream is the single-card reference's, draw for draw."""
    from portbench import weights
    from portbench.kinds import train as base
    from portbench.reference import bst, bst_dp
    from portbench.traffic import train as traffic

    cfg = harness.config("bst-wechat")
    tr = harness.cell(CELL)["traffic"]
    batches = [base.device_batch(b, "cpu")
               for b in traffic.batches(cfg["schema"], {**tr, "num_batches": 2}, 32, 7)]
    init = weights.trainable(cfg, weights.make(cfg, 7, "cpu"))
    a = bst.train({k: v.clone() for k, v in init.items()}, cfg, batches, 8, "cpu")
    b = bst_dp.train({k: v.clone() for k, v in init.items()}, cfg, batches, 8, 1, "cpu")
    assert a[0] == b[0]
    assert all(torch.equal(a[2][k], b[2][k]) for k in init)


def _small_run(monkeypatch, tmp_path, seconds=1.0):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    from portbench.kinds import kind

    cell = harness.cell(CELL)
    cfg = harness.config(cell["config"])
    cfg["batch_size"] = 64
    cell["traffic"]["num_batches"] = 4
    # ten times the card's limits, as the single-card cells' CPU runs take
    # them (portbench/tests/conftest.py)
    cell["limits"] = {k: 10 * v for k, v in cell["limits"].items()}
    run = harness.Run(CELL, cell, cfg, 2147483999, seconds, False, device="cpu",
                      started=time.perf_counter())
    return kind(cell["kind"]).run(run)


def test_small_run_is_correct(monkeypatch, tmp_path):
    res = _small_run(monkeypatch, tmp_path)
    assert res.correct, res.checks
    assert res.attempted > 0 and res.attempted % 8 == 0
    assert set(res.e2e) == {"train_ex_s", "setup_s"}


@pytest.mark.parametrize("fault", ["half_batch", "unchanged_state"])
def test_fault_on_rank_0_is_caught(monkeypatch, tmp_path, fault):
    from portbench import faults

    faults.TRAIN[fault](monkeypatch.setattr)
    res = _small_run(monkeypatch, tmp_path)
    assert not res.correct, res.checks


def exit_at_once(rank, world, address, run):
    """A rank that fails before it meets the others."""
    sys.exit(1)


def test_failing_rank_ends_the_run(monkeypatch, tmp_path):
    import torch.multiprocessing as mp

    from portbench.kinds import train_dp

    spawn = mp.get_context("spawn")

    class FirstChildFails:
        def __init__(self):
            self.made = 0

        def Process(self, target, args, daemon):  # noqa: N802 (multiprocessing's name)
            self.made += 1
            return spawn.Process(target=exit_at_once if self.made == 1 else target,
                                 args=args, daemon=daemon)

    monkeypatch.setattr(mp, "get_context", lambda method: FirstChildFails())
    monkeypatch.setattr(train_dp, "TIMEOUT_S", 15.0)
    t0 = time.perf_counter()
    with pytest.raises(Exception):
        _small_run(monkeypatch, tmp_path)
    assert time.perf_counter() - t0 < 120
