"""The ten span readers on spans the program's recorder kept under a CPU
profiler, against values worked out by hand; and None where there is no
recorder (the program before it had one), where it dropped spans, or where
the trace is of the other kind."""

import sys
import types

import pytest
from torch.profiler import ProfilerActivity, profile

from portbench import harness
from portbench.trace import Trace
from recalgorithm_tpu_torch import utils
from recalgorithm_tpu_torch.utils import summary

TRAIN = {"step_put_ms.train": "train.put", "step_forward_ms.train": "train.forward",
         "step_backward_ms.train": "train.backward",
         "step_optimizer_ms.train": "train.optimizer", "step_metrics_ms.train": "train.metrics"}
SERVE_MEAN = {"batch_stack_ms.serve": "serve.stack", "predict_put_ms.serve": "predict.put",
              "predict_forward_ms.serve": "predict.forward",
              "batch_resolve_ms.serve": "serve.resolve"}
READERS = [*TRAIN, "queue_wait_ms.serve", *SERVE_MEAN]


@pytest.fixture(autouse=True)
def fresh_recorder():
    summary.clear()
    yield
    summary.clear()


def _trace(kind):
    return Trace(kind=kind, cfg={}, window_s=1.0, busy_s=0.5, events=[], breakdown={},
                 data={})


def _read(name, kind):
    return harness.metric_module(name).read(_trace(kind))


def _record_train():
    """Two steps; each phase's children last (step + 1) * (phase + 1) ms, and
    one stray ``train.put`` outside any step."""
    with profile(activities=[ProfilerActivity.CPU]):
        for s in range(2):
            with summary.span("train.step") as step:
                for p, phase in enumerate(TRAIN.values()):
                    summary.add_span(phase, 10.0, 10.0 + (s + 1) * (p + 1) * 1e-3, step.id)
        summary.add_span("train.put", 0.0, 1.0)


def _record_serve():
    """Two batches: stack 1 and 3 ms, put 2 and 4, forward 5 and 7, resolve
    0.5 and 1.5; queue waits 1, 2, 3 ms and 4, 10 ms; strays outside a flush."""
    waits = [[1e-3, 2e-3, 3e-3], [4e-3, 10e-3]]
    took = {"serve.stack": (1e-3, 3e-3), "predict.put": (2e-3, 4e-3),
            "predict.forward": (5e-3, 7e-3), "serve.resolve": (0.5e-3, 1.5e-3)}
    with profile(activities=[ProfilerActivity.CPU]):
        for b in range(2):
            with summary.span("serve.flush") as flush:
                for w in waits[b]:
                    summary.add_span("serve.queue", 20.0 - w, 20.0, flush.id)
                for name, secs in took.items():
                    summary.add_span(name, 30.0, 30.0 + secs[b], flush.id)
        for name in ("serve.queue", *took):
            summary.add_span(name, 0.0, 1.0)


def test_train_readers_by_hand():
    _record_train()
    for p, name in enumerate(TRAIN):
        # (1 + 2) * (p + 1) ms over 2 steps
        assert _read(name, "train") == pytest.approx(1.5 * (p + 1), rel=1e-9)
        assert _read(name, "serve") is None


def test_serve_readers_by_hand():
    _record_serve()
    want = {"batch_stack_ms.serve": 2.0, "predict_put_ms.serve": 3.0,
            "predict_forward_ms.serve": 6.0, "batch_resolve_ms.serve": 1.0,
            "queue_wait_ms.serve": 3.0}
    for name, value in want.items():
        assert _read(name, "serve") == pytest.approx(value, rel=1e-9)
        assert _read(name, "train") is None


def test_readers_on_a_real_train_step(tmp_path):
    """The program's own spans: the five phases a step sum to at most its
    ``train.step`` span."""
    import torch

    from recalgorithm_tpu_torch.data.synthetic import SyntheticConfig, SyntheticWeChat
    from recalgorithm_tpu_torch.features.schema import wechat_schema
    from recalgorithm_tpu_torch.models.deepfm import DeepFM, DeepFMConfig
    from recalgorithm_tpu_torch.train import optimizers
    from recalgorithm_tpu_torch.train.loop import Trainer, TrainerConfig

    gen = SyntheticWeChat(wechat_schema(), SyntheticConfig(seed=1, vocab_scale=0.005))
    model = DeepFM(DeepFMConfig(hidden_units=(16, 8)), wechat_schema(gen.vocab_sizes()),
                   torch.Generator().manual_seed(0))
    trainer = Trainer(model, ("read_comment",), optimizers.build("adam", 0.01),
                      TrainerConfig(model_dir=str(tmp_path), save_checkpoints_steps=0),
                      device="cpu")
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(3):
            trainer.train_step(gen.batch(64, i))
    steps = [r for r in summary.spans() if r.name == "train.step"]
    assert len(steps) == 3
    step_ms = 1e3 * sum(r.end - r.start for r in steps) / 3
    phases = [_read(name, "train") for name in TRAIN]
    assert all(v > 0 for v in phases)
    assert sum(phases) <= step_ms


@pytest.mark.parametrize("name", READERS)
def test_none_without_a_recorder(name, monkeypatch):
    _record_train()
    _record_serve()
    kind = "train" if name in TRAIN else "serve"
    assert _read(name, kind) is not None
    # the program before the recorder: its summary module has no spans()
    monkeypatch.setattr(utils, "summary", types.ModuleType("summary"))
    monkeypatch.setitem(sys.modules, "recalgorithm_tpu_torch.utils.summary",
                        utils.summary)
    assert _read(name, kind) is None


@pytest.mark.parametrize("name", READERS)
def test_none_where_spans_were_dropped_or_none_recorded(name, monkeypatch):
    kind = "train" if name in TRAIN else "serve"
    assert _read(name, kind) is None  # nothing recorded
    monkeypatch.setattr(summary, "MAX_SPANS", 4)
    _record_train()
    _record_serve()
    assert summary.dropped() > 0
    assert _read(name, kind) is None
