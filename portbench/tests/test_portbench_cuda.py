"""On the card: the control (the reference in TF32, the precision below the
configurations' float32) fails the cells' limits where the program keeps
inside them, at a size a test run holds.  Skips without a card; run with
``python -m pytest portbench/tests -m cuda``."""

import pytest

from portbench import check, control, harness


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["bst-train-short", "bst-train-longhist"])
def test_train_control_fails(cuda_device, workload):
    cell = harness.cell(workload)
    cfg = harness.config(cell["config"])
    cfg["batch_size"] = 1024
    rec = control.train_readings(cell, cfg, 2147484999, cuda_device)
    assert check.judge(rec["program"], cell["limits"])[0], rec["program"]
    assert not check.judge(rec["control"], cell["limits"])[0], rec["control"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["din-serve-rank", "din-serve-single"])
def test_serve_control_fails(cuda_device, workload):
    cell = harness.cell(workload)
    cfg = harness.config(cell["config"])
    rec = control.serve_readings(workload, cell, cfg, 2147484998, 2.0, cuda_device)
    assert check.judge(rec["program"], cell["limits"])[0], rec["program"]
    assert not check.judge(rec["control"], cell["limits"])[0], rec["control"]
