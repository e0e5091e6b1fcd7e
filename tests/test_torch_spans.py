"""The port's span recorder (``utils/summary.py``) and its spans in
``Trainer.train_step``, ``BatchingPredictor`` and ``Predictor``: recorded
exactly while a torch profiler runs, nested by thread, mirrored into the
profiler's trace as user annotations; and the batcher's bounded rings behind
``stats()``."""

import json
import threading
import time

import numpy as np
import pytest
import torch
from torch.autograd import profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

from recalgorithm_tpu_torch import convert
from recalgorithm_tpu_torch.data.synthetic import SyntheticConfig, SyntheticWeChat
from recalgorithm_tpu_torch.features.schema import wechat_schema
from recalgorithm_tpu_torch.models.deepfm import DeepFM, DeepFMConfig
from recalgorithm_tpu_torch.serving.predictor import Predictor
from recalgorithm_tpu_torch.serving.server import RING, BatchingPredictor
from recalgorithm_tpu_torch.train import optimizers
from recalgorithm_tpu_torch.train.loop import Trainer, TrainerConfig
from recalgorithm_tpu_torch.utils import summary

TRAIN_PHASES = ("train.put", "train.forward", "train.backward", "train.optimizer",
                "train.metrics")


@pytest.fixture(autouse=True)
def fresh_recorder():
    summary.clear()
    yield
    summary.clear()


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _by_name(records):
    out = {}
    for r in records:
        out.setdefault(r.name, []).append(r)
    return out


def _annotations(prof, names):
    """(name, parent annotation's name) of every user annotation named in
    ``names`` (torch's optimizer annotates its own calls too)."""
    out = []
    for e in prof.events():
        if getattr(e, "is_user_annotation", False) and e.name in names:
            parent = e.cpu_parent
            while parent is not None and not (parent.is_user_annotation
                                              and parent.name in names):
                parent = parent.cpu_parent
            out.append((e.name, parent.name if parent is not None else None))
    return out


def test_recorder_follows_the_profilers_flag():
    """The recorder reads torch's own Python flag: a torch upgrade that
    renames or stops setting it fails here."""
    assert isinstance(autograd_profiler._is_profiler_enabled, bool)
    assert not autograd_profiler._is_profiler_enabled
    with _cpu_profile():
        assert autograd_profiler._is_profiler_enabled
        summary.add_span("on", 0.0, 1.0)
    assert not autograd_profiler._is_profiler_enabled
    summary.add_span("off", 0.0, 1.0)
    with torch.autograd.profiler.profile():
        assert autograd_profiler._is_profiler_enabled
        summary.add_span("legacy", 0.0, 1.0)
    assert not autograd_profiler._is_profiler_enabled
    assert [r.name for r in summary.spans()] == ["on", "legacy"]


def test_off_records_nothing_and_enters_no_record_function(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with the recorder off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert summary.span("a") is summary.span("b")  # one shared object: no allocation
    with summary.span("a") as a:
        with summary.span("b"):
            summary.add_span("c", 0.0, 1.0)
    assert a is None
    with summary.span("timed", timed=True) as t:
        pass
    assert t.id is None and t.end >= t.start > 0
    assert summary.spans() == [] and summary.dropped() == 0


def test_spans_nest_in_memory_and_in_the_profilers_trace():
    with _cpu_profile() as prof:
        with summary.span("outer") as outer:
            with summary.span("mid") as mid:
                with summary.span("inner"):
                    torch.ones(4).add_(1)
                summary.add_span("back", outer.start, mid.start, mid.id)
            with summary.span("second"):
                pass
    rec = {r.name: r for r in summary.spans()}
    assert set(rec) == {"outer", "mid", "inner", "back", "second"}
    assert rec["outer"].parent is None
    assert rec["mid"].parent == rec["second"].parent == rec["outer"].id
    assert rec["inner"].parent == rec["back"].parent == rec["mid"].id
    assert len({r.id for r in rec.values()}) == 5
    for child in ("mid", "inner", "second"):
        parent = next(r for r in rec.values() if r.id == rec[child].parent)
        assert parent.start <= rec[child].start <= rec[child].end <= parent.end
    assert rec["back"].start == rec["outer"].start and rec["back"].end == rec["mid"].start
    # the scoped spans, and not the retroactive one, are the trace's annotations
    assert sorted(_annotations(prof, set(rec))) == sorted([
        ("outer", None), ("mid", "outer"), ("inner", "mid"), ("second", "outer")])


def test_a_span_is_kept_if_the_recorder_was_on_at_its_start():
    prof = _cpu_profile()
    before = summary.span("before")
    before.__enter__()
    prof.__enter__()
    early = summary.span("early")
    early.__enter__()
    summary.span("unused")
    prof.__exit__(None, None, None)
    late = summary.span("late")
    late.__enter__()
    early.__exit__(None, None, None)
    late.__exit__(None, None, None)
    before.__exit__(None, None, None)
    assert [r.name for r in summary.spans()] == ["early"]


def test_threads_keep_their_own_parents():
    barrier = threading.Barrier(2)

    def work(tag):
        with summary.span(f"{tag}.root"):
            barrier.wait(timeout=10)
            with summary.span(f"{tag}.child"):
                barrier.wait(timeout=10)

    with _cpu_profile():
        threads = [threading.Thread(target=work, args=(t,)) for t in ("a", "b")]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    rec = {r.name: r for r in summary.spans()}
    for tag in ("a", "b"):
        assert rec[f"{tag}.root"].parent is None
        assert rec[f"{tag}.child"].parent == rec[f"{tag}.root"].id


def test_the_buffer_is_bounded_and_counts_drops(monkeypatch):
    monkeypatch.setattr(summary, "MAX_SPANS", 3)
    with _cpu_profile():
        for i in range(5):
            with summary.span(f"s{i}"):
                pass
    assert [r.name for r in summary.spans()] == ["s0", "s1", "s2"]
    assert summary.dropped() == 2
    summary.clear()
    assert summary.spans() == [] and summary.dropped() == 0


def test_profile_scope_writes_the_spans_into_its_trace(tmp_path):
    with summary.profile(str(tmp_path)):
        with summary.span("train.step"):
            with summary.span("train.put"):
                torch.ones(3).mul_(2)
    with open(tmp_path / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"train.step", "train.put"} <= names
    assert [r.name for r in summary.spans()] == ["train.put", "train.step"]


@pytest.fixture(scope="module")
def gen():
    return SyntheticWeChat(wechat_schema(), SyntheticConfig(seed=3, vocab_scale=0.005))


def _deepfm(gen):
    return DeepFM(DeepFMConfig(hidden_units=(16, 8), dropout_rate=0.0),
                  wechat_schema(gen.vocab_sizes()), torch.Generator().manual_seed(0))


@pytest.mark.parametrize("grad_accum_steps", [1, 2])
def test_train_step_records_its_five_phases(gen, tmp_path, grad_accum_steps):
    trainer = Trainer(_deepfm(gen), ("read_comment",), optimizers.build("adam", 0.01),
                      TrainerConfig(model_dir=str(tmp_path), save_checkpoints_steps=0,
                                    grad_accum_steps=grad_accum_steps), device="cpu")
    trainer.train_step(gen.batch(32, 0))  # off: nothing recorded
    assert summary.spans() == []
    with _cpu_profile() as prof:
        loss = trainer.train_step(gen.batch(32, 1))
    assert torch.isfinite(loss) and trainer.step == 2
    rec = _by_name(summary.spans())
    assert sorted(rec) == sorted(("train.step",) + TRAIN_PHASES)
    assert all(len(v) == 1 for v in rec.values())
    step = rec["train.step"][0]
    assert step.parent is None
    phases = [rec[name][0] for name in TRAIN_PHASES]
    for a, b in zip(phases, phases[1:]):
        assert a.end <= b.start  # in order, one after another
    for p in phases:
        assert p.parent == step.id and step.start <= p.start <= p.end <= step.end
    assert sorted(_annotations(prof, set(rec))) == sorted(
        [("train.step", None)] + [(name, "train.step") for name in TRAIN_PHASES])


class _Stub:
    """A predictor with one span of its own; doubles ``dense``'s first column."""

    def __init__(self):
        self.rows = []

    def predict_batch(self, batch):
        with summary.span("stub.predict"):
            self.rows.append(len(batch["_weights"]))
            return {"p": batch["dense"][:, 0] * 2.0}


def _example(i):
    return {"dense": np.array([float(i), 0.0], np.float32), "id": np.int32(i)}


def test_batcher_records_a_queue_span_per_example_under_its_flush():
    stub = _Stub()
    bp = BatchingPredictor(stub, max_batch_size=8, max_delay_ms=200.0, buckets=(8,))
    try:
        with _cpu_profile():
            futures = [bp.predict_async(_example(i)) for i in range(8)]
            got = [f.result(timeout=30)["p"] for f in futures]
        assert got == [2.0 * i for i in range(8)]
    finally:
        bp.close()  # the flush's rings are fed once its answers are out
    st = bp.stats()
    assert stub.rows == [8]
    rec = _by_name(summary.spans())
    flush, = rec["serve.flush"]
    assert flush.parent is None
    for name in ("serve.stack", "stub.predict", "serve.resolve"):
        child, = rec[name]
        assert child.parent == flush.id
        assert flush.start <= child.start <= child.end <= flush.end
    assert rec["serve.stack"][0].end <= rec["stub.predict"][0].start
    assert rec["stub.predict"][0].end <= rec["serve.resolve"][0].start
    queue = rec["serve.queue"]
    assert len(queue) == 8
    assert all(q.parent == flush.id and q.start <= q.end == flush.start for q in queue)
    assert st["requests"] == 8 and st["batches"] == 1
    assert st["batch_latency_ms_p50"] == pytest.approx(
        round((flush.end - flush.start) * 1e3, 2), abs=0.011)
    assert st["queue_wait_ms_p50"] == pytest.approx(
        round(max(q.end - q.start for q in queue) * 1e3, 2), abs=0.011)
    assert {"batch_latency_ms_p99", "queue_wait_ms_p99"} <= set(st)


class _NoFuture:
    """Takes an answer and forgets it."""

    def set_result(self, value):
        pass

    def done(self):
        return False


def test_batcher_rings_keep_the_last_4096_batches():
    bp = BatchingPredictor(_Stub(), max_batch_size=4, max_delay_ms=1.0, buckets=(4,))
    try:
        for i in range(5000):
            bp._flush([(_example(i), _NoFuture(), time.perf_counter())])
        assert RING == 4096
        assert len(bp._flush_s) == len(bp._wait_s) == 4096
        st = bp.stats()
        assert st["batches"] == 5000 and st["requests"] == 5000
        for key in ("batch_latency_ms_p50", "batch_latency_ms_p99", "queue_wait_ms_p50",
                    "queue_wait_ms_p99"):
            assert st[key] >= 0.0
        assert summary.spans() == []  # no profiler: the rings fill all the same
    finally:
        bp.close()


def test_a_failed_batch_fails_its_futures_and_leaves_the_rings():
    bp = BatchingPredictor(_Stub(), max_batch_size=4, max_delay_ms=1.0, buckets=(4,))
    try:
        bad = bp.predict_async({"other": np.zeros(2, np.float32)})
        with pytest.raises(KeyError):
            bad.result(timeout=30)
        st = bp.stats()
        assert st["errors"] == 1 and "batch_latency_ms_p50" not in st
        assert "queue_wait_ms_p50" not in st
    finally:
        bp.close()


def test_predictor_records_put_then_forward(gen, tmp_path):
    model = _deepfm(gen)
    export_dir = convert.save_export(str(tmp_path), 1, 0.5, model)
    pred = Predictor(_deepfm(gen), export_dir, device="cpu")
    batch = gen.batch(16, 0)
    with _cpu_profile():
        probs = pred.predict_batch(batch)
    assert probs["read_comment"].shape == (16,)
    rec = _by_name(summary.spans())
    put, = rec["predict.put"]
    forward, = rec["predict.forward"]
    assert put.parent is None and forward.parent is None
    assert put.end <= forward.start
