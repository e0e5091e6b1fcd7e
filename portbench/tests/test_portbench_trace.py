"""The trace arithmetic on made-up events: busy time as a union, idle gaps
named by the innermost host op, and the readers' pairing of kernels with
the steps and calls they belong to."""

import numpy as np
import pytest

from portbench import harness, roofline
from portbench.trace import Trace, _busy_and_gaps, _name_gaps


def test_busy_is_a_union_and_gaps_are_between():
    device = [("a", 0.0, 10.0), ("b", 5.0, 10.0), ("c", 30.0, 5.0)]
    busy, gaps = _busy_and_gaps(device)
    assert busy == 20.0 and gaps == [(15.0, 30.0)]


def test_gap_named_by_innermost_host_op():
    host = [(0.0, 100.0, "step"), (12.0, 40.0, "aten::copy_"), (50.0, 60.0, "later")]
    assert _name_gaps([(15.0, 30.0), (45.0, 49.0)], host) == \
        {"aten::copy_": 15e-6, "step": 4e-6}
    assert _name_gaps([(200.0, 210.0)], host) == {"python": 10e-6}


def _trace(kind, cfg, events, data):
    return Trace(kind=kind, cfg=cfg, window_s=1.0, busy_s=0.25, events=events,
                 breakdown={}, data=data)


def test_train_readers():
    cfg = harness.config("bst-wechat")
    lens = [np.full(8, 6), np.full(8, 9)]
    events = [("void bst_attention_fwd_kernel<true, float>(...)", 0, 40.0),
              ("void bst_attention_fwd_kernel<true, float>(...)", 100, 60.0),
              ("void bst_attention_bwd_kernel<float>(...)", 200, 80.0),
              ("void bst_attention_bwd_kernel<float>(...)", 300, 80.0),
              ("radixSortKernel", 400, 10.0), ("gemm", 500, 10.0)]
    trace = _trace("train", cfg, events, {"steps": 2, "examples": 16, "history_lengths": lens,
                                         "heads": 3, "keys": 51})
    read = {name: harness.metric_module(name).read(trace) for name in (
        "kernels_per_step.train", "table_grad_ms.train", "bst_attn_fwd_save_roofline",
        "device_idle.train", "serve_p99_ms")}
    assert read["kernels_per_step.train"] == 3.0
    assert read["table_grad_ms.train"] == pytest.approx(0.005)
    want = sum(roofline.bst_bound_ms(x + 1, 3, 51, "forward_save")[0] for x in lens)
    assert read["bst_attn_fwd_save_roofline"] == pytest.approx(100 * want / 0.1)
    assert read["device_idle.train"] == pytest.approx(75.0)
    assert read["serve_p99_ms"] is None  # a serving metric reads nothing here


@pytest.mark.parametrize("kernels", [2, 3])
def test_din_roofline_is_a_ratio_of_means(kernels):
    cfg = harness.config("din-wechat")
    calls = [(0.0, 1.0, np.full(4, 5)), (1.0, 2.0, np.full(6, 7)), (2.0, 3.0, np.full(2, 3))]
    events = [("void din_attention_kernel<false>(...)", i * 10, 10.0) for i in range(kernels)]
    trace = _trace("serve", cfg, events, {"calls": calls, "traced_calls": 2,
                                         "requests": 12, "batches": 3})
    value = harness.metric_module("din_attn_roofline").read(trace)
    want = sum(roofline.din_attention_bound_ms(c[2], 50, False)[0] for c in calls[:2]) / 2
    assert value == pytest.approx(100 * want / 0.01)
    assert harness.metric_module("serve_rows_per_batch").read(trace) == 4.0


def test_quiet_part_readers():
    trace = _trace("serve", harness.config("din-wechat"), [("k", 0, 1.0)], {
        "quiet_latency_ms": np.arange(1, 101, dtype=float), "quiet_gc_share": 0.05})
    assert harness.metric_module("serve_p99_ms").read(trace) == pytest.approx(99.01)
    assert harness.metric_module("gc_pause_share.serve").read(trace) == pytest.approx(5.0)
