"""The one put of a host batch onto a device (``utils/device.to_device``)
and the device rule (``resolve_device``).

On the CPU every case gives the values and dtypes that
``torch.from_numpy(np.asarray(v))`` gives, and copies on the host only an
array torch cannot take as it is.  The staged put a card takes (one packed
pinned buffer, one non-blocking copy, a ring of event-guarded slots) runs
here through ``staged_put`` on the CPU, unpinned and without events; its
reader in the benchmark (``staged_put_share.train``) on spans built by hand.

On the card (``-m cuda``; imports neither JAX nor the JAX package, so it runs
without this directory's conftest)::

    python -m pytest tests/test_torch_device.py -q -m cuda --noconftest

the planted reuse race (copies held back by a queued sleep while the host
puts more batches than a ring has slots) and a staged put under
``torch.cuda.set_sync_debug_mode("error")``.
"""

import threading
import warnings

import numpy as np
import pytest
import torch

from recalgorithm_tpu_torch.utils import device as dv
from recalgorithm_tpu_torch.utils.device import resolve_device, to_device

_BASE = np.arange(24, dtype=np.int32).reshape(4, 6)


def _read_only():
    a = _BASE.copy()
    a.setflags(write=False)
    return a


# name -> (column, whether the put may read the array's own memory)
CASES = {
    "contiguous": (lambda: _BASE.copy(), True),
    "strided": (lambda: _BASE.copy()[:, ::2], True),
    "read_only": (_read_only, False),
    "reversed": (lambda: _BASE.copy()[::-1], False),
    "list": (lambda: [[1, 2], [3, 4]], False),
    "int32": (lambda: np.array([1, 2, 3], np.int32), True),
    "int64": (lambda: np.array([1, 2, 3], np.int64), True),
    "float32": (lambda: np.array([0.5, 1.5], np.float32), True),
}


def _want(v) -> torch.Tensor:
    """What ``torch.from_numpy(np.asarray(v))`` gives (from a copy where it
    refuses the array, as ``np.array`` made it for the ``Predictor``)."""
    return torch.from_numpy(np.array(v))


@pytest.mark.parametrize("mode", ["all", "columns", "out"])
@pytest.mark.parametrize("case", CASES)
def test_put_gives_the_values_and_dtypes_of_from_numpy(case, mode):
    make, shares = CASES[case]
    v = make()
    want = _want(v)
    if case != "reversed":  # torch refuses a negative stride
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # torch's own warning on a read-only array
            assert torch.equal(torch.from_numpy(np.asarray(v)), want)
    batch = {"x": v, "_index": np.arange(3)}
    if mode == "all":
        got = to_device(batch, "cpu")
        assert got.keys() == {"x", "_index"}
    elif mode == "columns":
        got = to_device(batch, "cpu", columns=frozenset({"x", "labels"}))
        assert got.keys() == {"x"}
    else:
        out = {"x": torch.full(want.shape, -1, dtype=want.dtype)}
        got = to_device(batch, "cpu", out=out)
        assert got is out and got["x"].data_ptr() == out["x"].data_ptr()
    x = got["x"]
    assert x.dtype == want.dtype and x.device.type == "cpu"
    assert torch.equal(x, want)
    if mode != "out":
        a = np.asarray(v)
        assert (x.data_ptr() == a.ctypes.data) is shares  # no host copy unless it must
        if case == "read_only":
            assert not a.flags.writeable  # the caller's array is left as it was


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            resolve_device(None)


# ---------------------------------------------------------------------------
# the staged put (on a card; here through ``staged_put`` on the CPU, whose
# ring is unpinned and has no events)
# ---------------------------------------------------------------------------

CPU = torch.device("cpu")


def _schema_batch(schema, rows, seed):
    """A host batch of every column ``schema`` makes, plus ``_weights`` and
    ``_index``, with values from the seed."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, (shape, dtype) in schema.batch_spec(rows).items():
        out[name] = (rng.integers(-(2 ** 31), 2 ** 31 - 1, size=shape).astype(dtype)
                     if dtype.kind == "i" else rng.normal(size=shape).astype(dtype))
    out["_weights"] = rng.random(rows).astype(np.float32)
    out["_index"] = np.arange(rows, dtype=np.int64)
    return out


def _schemas():
    from recalgorithm_tpu_torch.features import schema as S

    return {"wechat": S.wechat_schema(), "criteo": S.criteo_schema()}


@pytest.mark.parametrize("rows", [1, 7, 4096])
@pytest.mark.parametrize("name", ["wechat", "criteo"])
def test_packed_layout_round_trips_the_schemas(name, rows):
    """Every column the BST and DIN (WeChat) and DLRM-DCNv2 (Criteo)
    schemas make comes back with its values, dtype and shape, from its own
    16-byte-aligned bytes of one buffer."""
    batch = _schema_batch(_schemas()[name], rows, seed=rows)
    got = dv.staged_put(batch, CPU)
    assert list(got) == list(batch)  # the caller's order
    lay = dv.layout(dv._key({k: np.asarray(v) for k, v in batch.items()}))
    assert [c[0] for c in lay.columns] == sorted(batch)
    flat = got["dense"].untyped_storage()
    end = 0
    for col, o, n, _, tdt, shape in lay.columns:
        x = got[col]
        assert o % dv.ALIGN == 0 and o >= end  # aligned, no overlap
        end = o + n
        assert x.untyped_storage().data_ptr() == flat.data_ptr()
        assert x.data_ptr() - flat.data_ptr() == o and x.is_contiguous()
        assert x.dtype == tdt == torch.from_numpy(batch[col]).dtype and x.shape == shape
        assert torch.equal(x, torch.from_numpy(batch[col])), col
    assert lay.nbytes % dv.ALIGN == 0 and end <= lay.nbytes == flat.nbytes()


@pytest.mark.parametrize("mode", ["all", "columns", "out"])
@pytest.mark.parametrize("case", CASES)
def test_staged_put_of_every_kind_of_column(case, mode):
    """Read-only, negative-stride, strided and list columns staged: the
    values and dtypes of ``from_numpy``, always from a copy, the caller's
    array left as it was."""
    make, _ = CASES[case]
    v = make()
    want = _want(v)
    batch = {"x": v, "_index": np.arange(3)}
    if mode == "all":
        got = dv.staged_put(batch, CPU)
        assert got.keys() == {"x", "_index"}
    elif mode == "columns":
        got = dv.staged_put(batch, CPU, columns=frozenset({"x", "labels"}))
        assert got.keys() == {"x"}
    else:
        out = dv.empty_batch({"x": v}, CPU)
        got = dv.staged_put(batch, CPU, out=out)
        assert got is out and got["x"].data_ptr() == out.flat.data_ptr()
    x = got["x"]
    assert x.dtype == want.dtype and torch.equal(x, want)
    a = np.asarray(v)
    assert x.data_ptr() != a.ctypes.data
    if case == "read_only":
        assert not a.flags.writeable


@pytest.mark.parametrize("to", ["new", "out"])
def test_an_array_changed_between_puts_gives_each_puts_bytes(to):
    """The same arrays, changed after every put, over more puts than a ring
    has slots: each put holds the bytes its call saw (nothing is cached by
    array identity or address)."""
    a = np.zeros((5, 3), np.int32)
    b = np.zeros(5, np.float32)
    batch = {"a": a, "b": b}
    out = dv.empty_batch(batch, CPU) if to == "out" else None
    for i in range(2 * dv.SLOTS + 1):
        a[:] = i
        b[:] = -i
        got = dv.staged_put(batch, CPU, out=out)
        a[:] = 100 + i  # the caller reuses its array once the put returns
        b[:] = 100 + i
        assert torch.equal(got["a"], torch.full((5, 3), i, dtype=torch.int32))
        assert torch.equal(got["b"], torch.full((5,), -i, dtype=torch.float32))


def test_out_must_be_empty_batch_of_the_batch_layout():
    batch = {"x": np.arange(4, dtype=np.int32)}
    with pytest.raises(ValueError, match="layout"):
        dv.staged_put(batch, CPU, out={"x": torch.zeros(4, dtype=torch.int32)})
    with pytest.raises(ValueError, match="layout"):
        dv.staged_put(batch, CPU, out=dv.empty_batch({"x": np.arange(5, dtype=np.int32)}, CPU))
    with pytest.raises(ValueError, match="layout"):
        dv.staged_put(batch, CPU, out=dv.empty_batch({"x": np.arange(4, dtype=np.int64)}, CPU))


def test_rings_are_per_thread_and_bounded():
    """A thread keeps at most LAYOUTS_KEPT rings, the most recently used;
    another thread stages through rings of its own."""
    dv._local.rings = None
    for n in range(dv.LAYOUTS_KEPT + 3):
        dv.staged_put({"x": np.zeros(n + 1, np.int32)}, CPU)
    dv.staged_put({"x": np.zeros(4, np.int32)}, CPU)  # seen again: kept, moved last
    rings = dv._local.rings
    assert len(rings) == dv.LAYOUTS_KEPT
    assert next(reversed(rings))[1] == (("x", (4,), "<i4"),)
    assert (CPU, (("x", (1,), "<i4"),)) not in rings
    seen = []
    worker = threading.Thread(
        target=lambda: (dv.staged_put({"x": np.zeros(4, np.int32)}, CPU),
                        seen.append(dict(dv._local.rings))))
    worker.start()
    worker.join(timeout=30)
    assert not worker.is_alive()
    ((key, ring),) = seen[0].items()
    assert ring is not rings[key]
    dv._local.rings = None


def test_a_cpu_target_takes_the_columns_as_before(monkeypatch):
    """A CPU target never stages: no ring, no ``put.stage`` span; a card
    target stages under that span."""
    from torch.profiler import ProfilerActivity, profile

    from recalgorithm_tpu_torch.utils import summary

    monkeypatch.setattr(dv._local, "rings", None, raising=False)
    calls = []
    monkeypatch.setattr(dv, "staged_put", lambda *a: calls.append(a) or "staged")
    batch = {"x": _BASE.copy()}
    summary.clear()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            got = to_device(batch, "cpu")
            assert got["x"].data_ptr() == batch["x"].ctypes.data
            assert to_device(batch, "cuda", ("x",)) == "staged"
        assert dv._local.rings is None
        assert [r.name for r in summary.spans()] == ["put.stage"]
        ((b, dev, cols, out),) = calls
        assert b is batch and dev == torch.device("cuda") and cols == ("x",) and out is None
    finally:
        summary.clear()


def test_step_graph_inputs_are_views_of_one_buffer():
    from recalgorithm_tpu_torch.train import step_graph

    batch = _schema_batch(_schemas()["wechat"], 9, seed=3)
    graph = step_graph.StepGraph.of(batch, CPU)
    assert isinstance(graph.inputs, dv.Packed) and graph.inputs.keys() == batch.keys()
    flat = graph.inputs.flat
    assert all(x.untyped_storage().data_ptr() == flat.data_ptr()
               for x in graph.inputs.values())
    assert dv.staged_put(batch, CPU, out=graph.inputs) is graph.inputs
    for k, x in graph.inputs.items():
        assert torch.equal(x, torch.from_numpy(batch[k])), k


# ---------------------------------------------------------------------------
# the benchmark's readers: portbench/metrics/staged_put_share.train.py and
# put_wait_ms.train.py
# ---------------------------------------------------------------------------

READERS = ["staged_put_share.train", "put_wait_ms.train"]


def _reader(name="staged_put_share.train"):
    from portbench import harness

    return harness.metric_module(name)


def _trace(kind="train"):
    from portbench.trace import Trace

    return Trace(kind=kind, cfg={}, window_s=1.0, busy_s=0.5, events=[], breakdown={},
                 data={"steps": 2})


def _steps(staged):
    """One ``train.step`` a flag, each with a ``train.put`` holding a
    ``put.stage`` where its flag is set, which holds a ``put.wait`` of
    (step + 1) ms; a stray ``put.stage`` and ``put.wait`` outside."""
    from recalgorithm_tpu_torch.utils.summary import SpanRecord

    out, i = [], 0
    for s, flag in enumerate(staged):
        step, put, stage = i + 1, i + 2, i + 3
        out += [SpanRecord("train.step", step, None, s, s + 0.5),
                SpanRecord("train.put", put, step, s, s + 0.1)]
        if flag:
            out += [SpanRecord("put.stage", stage, put, s, s + 0.05),
                    SpanRecord("put.wait", i + 4, stage, s, s + (s + 1) * 1e-3)]
        i += 4
    return out + [SpanRecord("put.stage", 999, None, 0.0, 0.1),
                  SpanRecord("put.wait", 1000, 999, 0.0, 0.1)]


@pytest.mark.parametrize("staged,share,wait", [((True, True, True), 100.0, 2.0),
                                               ((True, False), 50.0, 0.5),
                                               ((False, False), None, None)])
def test_put_readers(monkeypatch, staged, share, wait):
    """``staged_put_share.train``: staged puts under ``train.put`` over the
    steps; ``put_wait_ms.train``: their waits' ms over the steps."""
    from portbench import spans

    monkeypatch.setattr(spans, "recorded", lambda: _steps(staged))
    for name, want in zip(READERS, (share, wait)):
        got = _reader(name).read(_trace())
        assert got == (pytest.approx(want) if want is not None else None), name
        assert _reader(name).read(_trace("serve")) is None
    monkeypatch.setattr(spans, "recorded", lambda: None)
    assert all(_reader(name).read(_trace()) is None for name in READERS)


@pytest.mark.parametrize("name", READERS)
def test_put_reader_agrees_with_its_entry(name):
    from portbench import harness

    entry = next(m for m in harness.benchmark()["per_layer"] if m["name"] == name)
    mod = _reader(name)
    assert (mod.LAYER, mod.UNIT, mod.SOURCE, mod.MOVES) == (
        entry["layer"], entry["unit"], entry["source"], entry["moves"])
    assert entry["workloads"] == ["bst-train-short", "bst-train-longhist"]
    assert entry["better"] == ("higher" if name.startswith("staged") else "lower")
    assert all(harness.cell(w)["kind"] == mod.KIND for w in entry["workloads"])


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the staged put pins memory and records CUDA events")


def _bst_like(i):
    """A BST-sized pair of columns, every value ``i``."""
    return {"hist": np.full((4096, 50), i, np.int32), "dense": np.full((4096, 9), -i, np.float32)}


@pytest.mark.cuda
@pytest.mark.parametrize("to", ["new", "out"])
def test_ring_never_overwrites_a_slot_in_flight(cuda, to):
    """The planted race: a long sleep queued ahead on the stream holds every
    copy back while the host puts more batches of one layout than the ring
    has slots, changing its arrays after each.  Each put's device bytes are
    its own batch's (with the event wait taken out, a later batch's bytes
    reach an earlier put)."""
    host = _bst_like(0)
    out = dv.empty_batch(host, "cuda") if to == "out" else None
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)  # about 0.1 s of the card's cycles
    seen = []
    for i in range(1, 2 * dv.SLOTS + 2):
        for v in host.values():
            v[...] = i if v.dtype == np.int32 else -i
        got = to_device(host, "cuda", out=out)
        # a step graph reads its inputs in stream order, before the next put
        seen.append({k: x.clone() for k, x in got.items()} if to == "out" else got)
    torch.cuda.synchronize()
    for i, got in enumerate(seen, start=1):
        want = _bst_like(i)
        for k, x in got.items():
            assert torch.equal(x.cpu(), torch.from_numpy(want[k])), (i, k)


@pytest.mark.cuda
def test_staged_put_does_not_synchronize(cuda):
    """Under ``set_sync_debug_mode("error")`` no staged put synchronizes the
    stream, over more puts than a ring has slots, new and into ``out``."""
    batch = _schema_batch(_schemas()["wechat"], 4096, seed=5)
    out = dv.empty_batch(batch, "cuda")
    to_device(batch, "cuda")  # first sight: the rings' pinned buffers
    to_device(batch, "cuda", out=out)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2 * dv.SLOTS + 1):
            got = to_device(batch, "cuda")
            to_device(batch, "cuda", out=out)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    for k, v in batch.items():
        assert torch.equal(got[k].cpu(), torch.from_numpy(v)), k
        assert torch.equal(out[k].cpu(), torch.from_numpy(v)), k
        assert got[k].device.type == "cuda" and got[k].data_ptr() % dv.ALIGN == 0


@pytest.mark.cuda
def test_staged_put_records_its_wait_inside_its_span(cuda):
    """Under a profiler a put on the card records ``put.stage`` with one
    ``put.wait`` inside it."""
    from torch.profiler import ProfilerActivity, profile

    from recalgorithm_tpu_torch.utils import summary

    batch = _bst_like(3)
    to_device(batch, "cuda")
    summary.clear()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            to_device(batch, "cuda")
        records = summary.spans()
        (stage,) = [r for r in records if r.name == "put.stage"]
        (wait,) = [r for r in records if r.name == "put.wait"]
        assert wait.parent == stage.id and stage.start <= wait.start <= wait.end <= stage.end
    finally:
        summary.clear()
