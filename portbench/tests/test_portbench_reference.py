"""The plain references agree with the port on the CPU at a small size,
through the harness's own runs and comparisons, and on a forward alone."""

import numpy as np
import pytest
import torch

from portbench import harness, weights
from portbench.kinds import program_model
from portbench.reference import bst, din
from portbench.traffic import serve as serve_traffic
from portbench.traffic import train as train_traffic


@pytest.mark.parametrize("workload", ["bst-train-short", "bst-train-longhist",
                                      "din-serve-rank", "din-serve-single"])
def test_cell_correct_on_cpu(small_run, workload):
    run, res = small_run(workload)
    assert res.correct, res.checks
    assert res.attempted > 0 and res.failed == 0


def _tensors(batch: dict) -> dict:
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def test_bst_forward_matches_port():
    cfg = harness.config("bst-wechat")
    w = weights.make(cfg, 11, "cpu")
    model, _ = program_model(cfg, w, "cpu")
    model.train()
    for m in model.modules():  # dropout off on both sides
        if type(m).__name__ == "Dropout":
            m.rate = 0.0
    batch = train_traffic.batches(cfg["schema"], harness.cell("bst-train-short")["traffic"],
                                  64, 11)[0]
    got = model(_tensors(batch))[0]["read_comment"].detach()
    want = bst.logits(weights.trainable(cfg, w), cfg, _tensors(batch), None)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_din_forward_matches_port():
    cfg = harness.config("din-wechat")
    w = weights.make(cfg, 12, "cpu")
    model, _ = program_model(cfg, w, "cpu")
    model.eval()
    reqs = serve_traffic.requests(cfg["schema"], dict(harness.cell("din-serve-rank")["traffic"],
                                                      rate_rps=2.0), 1.0, 12)
    rows = _tensors(reqs.rows(np.arange(reqs.candidates)))
    with torch.no_grad():
        got = model(rows)[0]["read_comment"]
    torch.testing.assert_close(got, din.logits(w, cfg, rows), rtol=1e-5, atol=1e-5)
