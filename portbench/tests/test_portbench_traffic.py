"""The generators are bitwise reproducible from the seed alone, give every
seed the same work, and give the two training cells the densities their
files promise against the program's compaction cap."""

import numpy as np
import pytest

from portbench import harness
from portbench.traffic import serve, train

SEED = 2**31 + 12345  # the driver's seeds exceed 32 signed bits


def _equal(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("workload", ["bst-train-short", "bst-train-longhist"])
def test_train_batches_reproducible(workload):
    cell = harness.cell(workload)
    cfg = harness.config(cell["config"])
    tr = dict(cell["traffic"], num_batches=2)
    one = train.batches(cfg["schema"], tr, 512, SEED)
    two = train.batches(cfg["schema"], tr, 512, SEED)
    other = train.batches(cfg["schema"], tr, 512, SEED + 1)
    assert all(_equal(a, b) for a, b in zip(one, two))
    assert not _equal(one[0], other[0])
    hist = cfg["schema"]["history"]
    ids, lens = one[0][hist["field"]], one[0][hist["field"] + "_len"]
    live = np.arange(hist["max_length"])[None, :] < lens[:, None]
    assert (ids[live] > 0).all() and (ids[~live] == 0).all()
    assert ids.max() <= cfg["schema"]["vocab_sizes"][hist["vocab"]]


@pytest.mark.parametrize("workload", ["din-serve-rank", "din-serve-single"])
def test_serve_requests_reproducible(workload):
    cell = harness.cell(workload)
    cfg = harness.config(cell["config"])
    tr = dict(cell["traffic"], rate_rps=40.0)
    one = serve.requests(cfg["schema"], tr, 2.0, SEED)
    two = serve.requests(cfg["schema"], tr, 2.0, SEED)
    other = serve.requests(cfg["schema"], tr, 2.0, SEED + 1)
    assert np.array_equal(one.arrivals, two.arrivals) and _equal(one.item, two.item)
    assert _equal(one.user, two.user) and np.array_equal(one.offsets, two.offsets)
    # the same work in another order: the same gaps and sizes, shuffled
    assert np.allclose(np.sort(np.diff(one.arrivals, prepend=0)),
                       np.sort(np.diff(other.arrivals, prepend=0)))
    assert np.array_equal(np.sort(np.diff(one.offsets)), np.sort(np.diff(other.offsets)))
    assert one.arrivals[-1] == pytest.approx(2.0)
    feats = one.features(0)
    assert len(feats) == one.offsets[1]
    rows = one.rows(np.arange(one.offsets[1]))
    for key, col in rows.items():
        assert np.array_equal(np.stack([np.asarray(f[key]) for f in feats]), col)


@pytest.mark.parametrize("workload,fits", [("bst-train-short", True),
                                           ("bst-train-longhist", False)])
def test_compaction_cap(workload, fits):
    """The short histories fit the compact buffer of B*T/4 live entries and
    the long ones overflow it, so the program takes each cell's path."""
    from recalgorithm_tpu_torch.features.schema import wechat_schema
    from recalgorithm_tpu_torch.ops.compact_scatter import batch_fits_compact

    cell = harness.cell(workload)
    cfg = harness.config(cell["config"])
    b, t = cfg["batch_size"], cfg["schema"]["history"]["max_length"]
    cap = b * t // 4
    schema = wechat_schema(cfg["schema"]["vocab_sizes"])
    for batch in train.batches(cfg["schema"], dict(cell["traffic"], num_batches=4), b, SEED):
        live = int(batch[cfg["schema"]["history"]["field"] + "_len"].sum())
        assert (live <= cap) == fits
        assert batch_fits_compact(batch, schema) == fits
