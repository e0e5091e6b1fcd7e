"""The frozen bound arithmetic equals the port's own, and the FLOP counts
equal what the plain references' products count."""

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import flops, harness, roofline, weights
from portbench.reference import bst, din
from portbench.traffic import serve as serve_traffic
from portbench.traffic import train as train_traffic

chip_smoke = pytest.importorskip("chip_smoke")


@pytest.mark.parametrize("kind", ["forward", "forward_save", "backward"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bst_bound_equals_chip_smoke(kind, seed):
    lengths = np.random.default_rng(seed).integers(0, 52, size=4096)
    for p_bytes in (2, 4):
        assert roofline.bst_bound_ms(lengths, 3, 51, kind, p_bytes) == \
            chip_smoke.bst_bound_ms(lengths, 3, 51, kind, p_bytes)


@pytest.mark.parametrize("softmax", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_din_bound_equals_chip_smoke(softmax, seed):
    lengths = np.random.default_rng(seed).integers(0, 51, size=256)
    assert roofline.din_attention_bound_ms(lengths, 50, softmax) == \
        chip_smoke.din_attention_bound_ms(lengths, 50, softmax)


def _counted(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


def _device(batch: dict) -> dict:
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def test_bst_flops_equal_reference_products():
    """Every history full: the reference attends over all T+1 slots, which
    is then the count of valid keys."""
    cfg = harness.config("bst-wechat")
    hist = cfg["schema"]["history"]
    tr = dict(harness.cell("bst-train-short")["traffic"], num_batches=1,
              history={"law": "uniform", "low": hist["max_length"], "high": hist["max_length"]})
    batch = train_traffic.batches(cfg["schema"], tr, 32, 7)[0]
    params = weights.make(cfg, 7, "cpu")
    counted = _counted(lambda: bst.logits(params, cfg, _device(batch), None))
    assert counted == int(flops.bst_forward(cfg, batch[hist["field"] + "_len"]).sum())


def test_din_flops_equal_reference_products():
    cfg = harness.config("din-wechat")
    hist = cfg["schema"]["history"]
    tr = dict(harness.cell("din-serve-rank")["traffic"], rate_rps=4.0,
              history={"law": "uniform", "low": hist["max_length"], "high": hist["max_length"]})
    reqs = serve_traffic.requests(cfg["schema"], tr, 1.0, 7)
    rows = reqs.rows(np.arange(reqs.candidates))
    params = weights.make(cfg, 7, "cpu")
    counted = _counted(lambda: din.logits(params, cfg, _device(rows)))
    assert counted == flops.forward(cfg, rows[hist["field"] + "_len"])
