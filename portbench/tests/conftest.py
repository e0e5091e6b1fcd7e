"""Settings of the benchmark's own tests (``python -m pytest portbench/tests``).

Registers the ``cuda`` marker: a test that needs the card takes the
``cuda_device`` fixture, which skips it where there is none.  Adds the
checkout's root to the import path, and gives each test run's files a
directory of its own under pytest's ``tmp_path`` (TMPDIR).
"""

import os
import sys
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA card (skips without one)")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return "cuda"


@pytest.fixture
def small_run(tmp_path, monkeypatch):
    """A cell's run on the CPU at a small size: B=256 and 4 batches for
    training, 20 requests a second for serving; everything else as the
    cell's files have it.  Returns (Run, Result).

    The limits are ten times the card's: the CPU's twin kernels and its
    float32 sums, in another order than the card's, read up to 3.3e-5 on
    ``grad_gap`` at B=256 (a LayerNorm bias's gradient, a sum that cancels),
    against the card's 5.7e-7; every planted fault still reads far above."""
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    from portbench import harness
    from portbench.kinds import kind

    def go(workload: str, seed: int = 2147483999, seconds: float = 2.0):
        cell = harness.cell(workload)
        cfg = harness.config(cell["config"])
        cell["limits"] = {k: 10 * v for k, v in cell["limits"].items()}
        if cell["kind"] == "train":
            cfg["batch_size"] = 256
            cell["traffic"]["num_batches"] = 4
        else:
            cell["traffic"]["rate_rps"] = 20.0 if cell["traffic"]["candidates"]["high"] > 1 else 50.0
        run = harness.Run(workload, cell, cfg, seed, seconds, False, device="cpu",
                          started=time.perf_counter())
        return run, kind(cell["kind"]).run(run)

    return go
