"""The train step as a CUDA graph (``train/step_graph.py``, ``Trainer.train_step``).

On the CPU: the rule that engages the graph (eager on the CPU, under a mesh,
with gradient accumulation and with an optimizer that cannot be captured;
replayed with Adam, SGD or LazyAdam on a tensor rate),
the metric state updated in place, and ``Optimizer`` writing a changing
schedule into a tensor rate.

On the card (``-m cuda``; imports neither JAX nor the JAX package, so it runs
where only PyTorch is installed):

    python -m pytest tests/test_torch_graph.py -q -m cuda --noconftest

each test holds the graph path against the eager path of the same weights
and seed (a trainer whose graphs are switched off) with ``chip_smoke.py``
phase 18's gate (``graph_gaps``): every loss, streaming train metric and
parameter bitwise equal, or else the losses and metrics within its own
limits, the rows the metrics counted equal and the parameters' changes
within the benchmark's ``correct`` limits, and prints which.
"""

import dataclasses
import importlib.util
import os

import numpy as np
import pytest
import torch

from recalgorithm_tpu_torch.data.synthetic import SyntheticConfig, SyntheticWeChat
from recalgorithm_tpu_torch.features.schema import wechat_schema
from recalgorithm_tpu_torch.models.bst import SEQ, BST, BSTConfig
from recalgorithm_tpu_torch.models.dien import DIEN, DIENConfig
from recalgorithm_tpu_torch.models.din import DIN, DINConfig
from recalgorithm_tpu_torch.ops import compact_scatter as cs
from recalgorithm_tpu_torch.train import metrics as M
from recalgorithm_tpu_torch.train import optimizers, step_graph
from recalgorithm_tpu_torch.train.loop import Trainer, TrainerConfig, _Checkpointer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

LOSS_GAP = chip_smoke.GRAPH_MEAN_GAP
STEPS = 8


def _schema(gen):
    return wechat_schema(gen.vocab_sizes())


@pytest.fixture(scope="module")
def gen():
    return SyntheticWeChat(wechat_schema(), SyntheticConfig(seed=7, vocab_scale=0.01))


def _trainer(gen, tmp_path, model="BST", device="cpu", optimizer=None, **config):
    """BST or DIN on Adam, or DIEN as its benchmark cell trains it (AUGRU,
    the auxiliary loss) on its LazyAdam."""
    schema = _schema(gen)
    if model == "BST":
        cfg = BSTConfig(hidden_units=(64, 32))
        net = BST(cfg, schema, generator=torch.Generator().manual_seed(0))
    elif model == "DIN":
        cfg = DINConfig(hidden_units=(64, 32))
        net = DIN(cfg, schema, generator=torch.Generator().manual_seed(0))
    else:
        cfg = DIENConfig(hidden_units=(64, 32), custom_gru_type="AUGRU",
                         use_auxiliary_loss=True)
        net = DIEN(cfg, schema, generator=torch.Generator().manual_seed(0))
    return Trainer(net, cfg.task_names,
                   optimizer or optimizers.build(cfg.optimizer, 0.005),
                   TrainerConfig(model_dir=str(tmp_path), **config), device=device)


# -- the engagement rule (CPU) -------------------------------------------------

def _tensor_rate_adam():
    """A graph-safe optimizer with a tensor rate, built here on the CPU."""
    p = torch.nn.Parameter(torch.zeros(3))
    return optimizers.Optimizer(optimizers.Adam([p], lr=torch.tensor(0.01)), lambda n: 0.01)


def _tensor_rate_lazyadam():
    """LazyAdam with a tensor rate, as ``build`` makes it on CUDA parameters,
    built here on the CPU."""
    p = torch.nn.Parameter(torch.zeros(3))
    return optimizers.Optimizer(optimizers.LazyAdam([p], lr=torch.tensor(0.01)), lambda n: 0.01)


def _built(name):
    return optimizers.build(name, 0.01)([torch.nn.Parameter(torch.zeros(3))])


def _dual():
    params = [torch.nn.Parameter(torch.zeros(3)), torch.nn.Parameter(torch.zeros(3))]
    return optimizers.dual_wide_deep(0.01, "adam", 0.01, lambda n: n == "wide",
                                     ["wide", "deep"])(params)


EAGER_CASES = {
    "cpu": lambda: ("cpu", None, 1, _tensor_rate_adam()),
    "mesh": lambda: ("cuda", object(), 1, _tensor_rate_adam()),
    "grad_accum": lambda: ("cuda", None, 2, _tensor_rate_adam()),
    # LazyAdam with a float rate, as build() makes it on CPU parameters
    # (with a tensor rate it replays: the test below)
    "lazyadam": lambda: ("cuda", None, 1, _built("lazyadam")),
    "adagrad": lambda: ("cuda", None, 1, _built("adagrad")),
    "rmsprop": lambda: ("cuda", None, 1, _built("rmsprop")),
    "ftrl": lambda: ("cuda", None, 1, _built("ftrl")),
    "dual_ftrl_adam": lambda: ("cuda", None, 1, _dual()),
}


@pytest.mark.parametrize("case", list(EAGER_CASES))
def test_engagement_rule_stays_eager(case):
    """Each condition alone keeps every step eager."""
    assert step_graph.engaged(*EAGER_CASES[case]()).replay is False


def test_engagement_rule_replays_on_cuda_with_a_graph_safe_optimizer():
    assert step_graph.engaged("cuda", None, 1, _tensor_rate_adam()).replay is True
    assert step_graph.engaged("cuda", None, 1, _tensor_rate_lazyadam()).replay is True
    # the class declares it: torch's Adam and SGD are, and the package's
    # LazyAdam (its count on the device); its Adagrad, RMSProp and FTRL not
    assert optimizers.Adam.graph_safe and optimizers.SGD.graph_safe
    assert optimizers.LazyAdam.graph_safe
    for cls in (optimizers.Adagrad, optimizers.RMSProp, optimizers.Ftrl):
        assert not getattr(cls, "graph_safe", False), cls
    # on CPU parameters build() makes float rates: nothing to capture
    assert not any(_built(name).capturable for name in ("adam", "sgd", "lazyadam"))


def test_cpu_trainer_steps_eagerly(gen, tmp_path):
    from torch.profiler import ProfilerActivity, profile

    from recalgorithm_tpu_torch.utils import summary

    tr = _trainer(gen, tmp_path)
    assert tr._step_graphs is None
    summary.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(3):
            tr.train_step(gen.batch(64, i))
    names = [r.name for r in summary.spans()]
    summary.clear()
    assert tr.replays == 0 and tr.step == 3
    assert names.count("train.forward") == 3 and "train.replay" not in names


# -- metric state in place (CPU) -----------------------------------------------

def _auc_out_of_place(state, labels, predictions, weights):
    """The update as it was before it worked in place."""
    thr = torch.from_numpy(M._thresholds())
    labels = labels.to(torch.float32)
    weights = torch.ones_like(labels) if weights is None else weights.to(torch.float32)
    pred_pos = (predictions[None, :] > thr[:, None]).to(torch.float32)
    pos, neg = (labels * weights)[None, :], ((1.0 - labels) * weights)[None, :]
    return M.AUCState(tp=state.tp + (pred_pos * pos).sum(dim=1),
                      fp=state.fp + (pred_pos * neg).sum(dim=1),
                      fn=state.fn + ((1.0 - pred_pos) * pos).sum(dim=1),
                      tn=state.tn + ((1.0 - pred_pos) * neg).sum(dim=1))


def _mean_out_of_place(state, values, weights):
    weights = torch.ones_like(values) if weights is None else weights
    return M.ScalarMeanState(total=state.total + (values * weights).sum(),
                             count=state.count + weights.sum())


@pytest.mark.parametrize("weighted", [False, True])
def test_metric_updates_in_place_equal_out_of_place(weighted):
    auc, mean = M.AUCState.init(), M.ScalarMeanState.init()
    ids = [id(t) for t in (auc.tp, auc.fp, auc.tn, auc.fn, mean.total, mean.count)]
    want_auc, want_mean = M.AUCState.init(), M.ScalarMeanState.init()
    rng = np.random.default_rng(3)
    for _ in range(5):
        y = torch.from_numpy((rng.random(300) < 0.3).astype(np.float32))
        p = torch.from_numpy(rng.random(300).astype(np.float32))
        w = torch.from_numpy((rng.random(300) < 0.8).astype(np.float32)) if weighted else None
        assert M.auc_update(auc, y, p, w) is auc
        assert M.mean_update(mean, p, w) is mean
        want_auc = _auc_out_of_place(want_auc, y, p, w)
        want_mean = _mean_out_of_place(want_mean, p, w)
    for f in ("tp", "fp", "tn", "fn"):
        assert torch.equal(getattr(auc, f), getattr(want_auc, f)), f
    assert torch.equal(mean.total, want_mean.total) and torch.equal(mean.count, want_mean.count)
    assert ids == [id(t) for t in (auc.tp, auc.fp, auc.tn, auc.fn, mean.total, mean.count)]
    dev = torch.device("cpu")
    assert M._thresholds_on(dev) is M._thresholds_on(dev)


def test_trainer_metrics_update_and_reset_in_place(gen, tmp_path):
    """The train metrics add each step into the same tensors (what a graph
    captures) and are never reset mid-run; evaluate starts from fresh
    state each call, so two equal calls read the same."""
    tr = _trainer(gen, tmp_path)
    tensors = []
    from recalgorithm_tpu_torch.train.loop import _map_tensors

    _map_tensors(tr.metrics, lambda t: tensors.append(t) or t)
    for i in range(5):
        tr.train_step(gen.batch(64, i))
    after = []
    _map_tensors(tr.metrics, lambda t: after.append(t) or t)
    assert [id(t) for t in after] == [id(t) for t in tensors]
    assert float(tr.metrics.loss_mean.count) == 5 * 64
    first = tr.evaluate([gen.batch(64, 10)])
    assert tr.evaluate([gen.batch(64, 10)]) == first
    assert float(tr.metrics.loss_mean.count) == 5 * 64  # evaluate left them alone


def test_graph_inputs_leave_other_columns_on_the_host(gen, tmp_path, monkeypatch):
    """A graph's static inputs are the model's columns; a host batch that
    carries more (``_index``) is put as the eager step puts it."""
    tr = _trainer(gen, tmp_path)
    hb = gen.batch(64, 0)
    hb["_index"] = np.arange(64, dtype=np.int64)
    tr._step_graphs = {}  # as on a card; the graph's inputs on the CPU here
    seen = []
    graph_of = tr._graph_of
    monkeypatch.setattr(tr, "_graph_of", lambda cols, compact: seen.append(cols)
                        or graph_of(cols, compact))
    monkeypatch.setattr(tr, "_warm_up", lambda graph, batch, compact: seen.append(batch))
    tr.train_step(hb)  # the put, then a warm-up that only records its batch
    cols, put = seen
    ((key, graph),) = tr._step_graphs.items()
    assert "_index" not in cols and put is graph.inputs
    assert graph.inputs.keys() == tr._put_batch(hb).keys()
    for k, x in tr._put_batch(hb).items():
        assert torch.equal(put[k], x), k
    assert graph_of(cols, compact=key[0]) is graph
    assert graph_of(cols, compact=not key[0]) is not graph  # another key


def test_graph_gate_passes_twins_and_refuses_a_planted_fault(gen, tmp_path):
    """chip_smoke.py phase 18's gate on two CPU trainers: equal steps are
    bitwise; every parameter moved 1% further on one side fails it."""
    a, b = _trainer(gen, tmp_path / "a"), _trainer(gen, tmp_path / "b")
    init = _init(a)
    batches = [gen.batch(64, i) for i in range(3)]
    la, lb = _run(a, batches), _run(b, batches)
    assert chip_smoke.graph_gaps("twins", la, lb, a, b, init) is True
    # a metric state that counted a batch twice reads the same means: the
    # rows it counted refuse it
    a.metrics.loss_mean.count.mul_(2)
    a.metrics.loss_mean.total.mul_(2)
    with pytest.raises(AssertionError, match="counted other rows"):
        chip_smoke.graph_gaps("planted rows", la, lb, a, b, init)
    a.metrics.loss_mean.count.div_(2)
    a.metrics.loss_mean.total.mul_(0.5 * (1 + 1e-4))
    with pytest.raises(AssertionError, match=r"beyond its limits: \{'metric_gap'"):
        chip_smoke.graph_gaps("planted metric", la, lb, a, b, init)
    a.metrics.loss_mean.total.copy_(b.metrics.loss_mean.total)
    with torch.no_grad():
        for n, p in a.model.named_parameters():
            p.add_(0.01 * (p - init[n]))
    with pytest.raises(AssertionError, match=r"beyond its limits: \{'change_gap'"):
        chip_smoke.graph_gaps("planted", la, lb, a, b, init)


# -- a tensor rate (CPU) -------------------------------------------------------

@pytest.mark.parametrize("name", ["adam", "sgd"])
def test_optimizer_writes_a_changing_schedule_into_a_tensor_rate(name):
    sched = optimizers.make_schedule(0.05, "cosine", warmup_steps=2, decay_steps=5)
    torch.manual_seed(0)
    w0 = torch.randn(4, 3)
    cls = {"adam": optimizers.Adam, "sgd": optimizers.SGD}[name]
    pf, pt = torch.nn.Parameter(w0.clone()), torch.nn.Parameter(w0.clone())
    by_float = optimizers.Optimizer(cls([pf], lr=sched(0)), sched)
    rate = torch.tensor(sched(0))
    by_tensor = optimizers.Optimizer(cls([pt], lr=rate), sched)
    assert by_tensor.capturable and not by_float.capturable
    for n in range(8):
        g = torch.randn(4, 3)
        for p, opt in ((pf, by_float), (pt, by_tensor)):
            p.grad = g.clone()
            opt.step()
        assert by_tensor.opt.param_groups[0]["lr"] is rate
        assert float(rate) == np.float32(sched(n)), n
        assert by_tensor.count == by_float.count == n + 1
        torch.testing.assert_close(pt.detach(), pf.detach(), rtol=1e-6, atol=1e-7)
    # a checkpoint holds the rate as a float; a load keeps the tensor and
    # counts as a new version (a captured update would read replaced state)
    sd = by_tensor.state_dict()
    assert isinstance(sd["opt"]["param_groups"][0]["lr"], float)
    by_tensor.load_state_dict(sd)
    assert by_tensor.opt.param_groups[0]["lr"] is rate and by_tensor.version == 1
    assert by_tensor.count == 8


# -- graph against eager, on the card --------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA graph has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False


def _batches(gen, key: str, n: int = STEPS, rows: int = 512) -> list[dict]:
    """``n`` batches of ``rows``: histories as the generator draws them
    (they fit the compact buffer), or with ``key="full"`` every history full
    (they do not)."""
    out = []
    for i in range(n):
        b = gen.batch(rows, 100 + i)
        if key == "full":
            t = b[SEQ].shape[1]
            rng = np.random.default_rng(i)
            b[SEQ] = rng.integers(1, 50, (rows, t)).astype(np.int32)
            b[SEQ + "_len"] = np.full(rows, t, np.int32)
        out.append(b)
    return out


def _pair(gen, tmp_path, model="BST", optimizer=None, **config):
    """A graph trainer and its eager twin from the same weights and seed."""
    graph = _trainer(gen, tmp_path / "graph", model, "cuda", optimizer, **config)
    eager = _trainer(gen, tmp_path / "eager", model, "cuda", optimizer, **config)
    assert graph._step_graphs is not None
    eager._step_graphs = None
    return graph, eager


def _gaps(label, losses, eager_losses, graph, eager, init, metrics=True):
    """chip_smoke.py phase 18's gate (``graph_gaps``)."""
    chip_smoke.graph_gaps(label, losses, eager_losses, graph, eager, init, metrics)


def _run(trainer, batches):
    return [float(trainer.train_step(b)) for b in batches]


def _init(trainer):
    return {n: p.detach().clone() for n, p in trainer.model.named_parameters()}


@pytest.mark.cuda
@pytest.mark.parametrize("key", ["compact", "full"])
def test_bst_graph_matches_eager(cuda, gen, tmp_path, key):
    graph, eager = _pair(gen, tmp_path)
    batches = _batches(gen, key)
    fits = [cs.batch_fits_compact(b, graph.model.schema) for b in batches]
    assert all(fits) if key == "compact" else not any(fits)
    init = _init(graph)
    losses, eager_losses = _run(graph, batches), _run(eager, batches)
    assert graph.replays == STEPS - 1 and eager.replays == 0
    _gaps(f"BST ({key} key)", losses, eager_losses, graph, eager, init)


@pytest.mark.cuda
def test_din_graph_matches_eager(cuda, gen, tmp_path):
    graph, eager = _pair(gen, tmp_path, "DIN")
    batches = _batches(gen, "compact")
    init = _init(graph)
    losses, eager_losses = _run(graph, batches), _run(eager, batches)
    assert graph.replays == STEPS - 1
    _gaps("DIN", losses, eager_losses, graph, eager, init)


@pytest.mark.cuda
def test_dien_graph_matches_eager(cuda, gen, tmp_path):
    """DIEN with AUGRU and the auxiliary loss on its LazyAdam (the count on
    the card): the replayed steps against the eager steps, under the gate
    the BST and DIN cases pass (on an H100 neither side is bitwise: the
    losses differ in their last bit, and LazyAdam, as Adam, turns a
    near-zero gradient's rounding into a step of the rate's size)."""
    graph, eager = _pair(gen, tmp_path, "DIEN")
    assert torch.is_tensor(graph.optimizer.opt.param_groups[0]["count"])
    batches = _batches(gen, "compact")
    init = _init(graph)
    losses, eager_losses = _run(graph, batches), _run(eager, batches)
    assert graph.replays == STEPS - 1 and eager.replays == 0
    assert int(graph.optimizer.opt.param_groups[0]["count"]) == STEPS
    _gaps("DIEN (AUGRU, auxiliary loss, LazyAdam)", losses, eager_losses, graph, eager, init)


@pytest.mark.cuda
def test_cosine_schedule_takes_effect_under_replay(cuda, gen, tmp_path):
    sched = optimizers.make_schedule(0.01, "cosine", warmup_steps=2, decay_steps=4)
    graph, eager = _pair(gen, tmp_path, optimizer=optimizers.build("adam", sched))
    batches = _batches(gen, "compact")
    init = _init(graph)
    losses, eager_losses = _run(graph, batches), _run(eager, batches)
    assert graph.replays == STEPS - 1
    assert float(graph.optimizer.opt.param_groups[0]["lr"]) == np.float32(sched(STEPS - 1))
    _gaps("BST, cosine schedule", losses, eager_losses, graph, eager, init)


@pytest.mark.cuda
def test_evaluate_between_steps_keeps_the_graph(cuda, gen, tmp_path):
    graph, eager = _pair(gen, tmp_path)
    batches, held = _batches(gen, "compact"), [gen.batch(512, 999)]
    init = _init(graph)
    half = STEPS // 2
    losses = _run(graph, batches[:half])
    ev = graph.evaluate(held)
    losses += _run(graph, batches[half:])
    eager_losses = _run(eager, batches[:half])
    eager_ev = eager.evaluate(held)
    eager_losses += _run(eager, batches[half:])
    assert len(graph._step_graphs) == 1 and graph.replays == STEPS - 1
    assert abs(ev["loss"] - eager_ev["loss"]) <= LOSS_GAP * abs(eager_ev["loss"])
    _gaps("BST, evaluate between steps", losses, eager_losses, graph, eager, init)


@pytest.mark.cuda
def test_checkpoint_restore_mid_run_resumes_the_loss_sequence(cuda, gen, tmp_path):
    graph, eager = _pair(gen, tmp_path)
    batches = _batches(gen, "compact")
    half = STEPS // 2
    ck = _Checkpointer(str(tmp_path / "graph"))
    losses = _run(graph, batches[:half])
    ck.save(graph)
    losses += _run(graph, batches[half:])
    # the same trainer back to the checkpoint: its graph is captured again
    version = graph.optimizer.version
    ck.restore_latest(graph)
    assert graph.optimizer.version == version + 1 and graph.step == half
    resumed = _run(graph, batches[half:])
    # and a fresh trainer from it
    fresh = _trainer(gen, tmp_path / "graph", "BST", "cuda")
    _Checkpointer(str(tmp_path / "graph")).restore_latest(fresh)
    fresh_losses = _run(fresh, batches[half:])
    init = _init(eager)
    eager_losses = _run(eager, batches)
    print(f"restore: resumed {resumed}, fresh {fresh_losses}, first run {losses[half:]}")
    for got in (resumed, fresh_losses):
        assert max(abs(a - b) / abs(b) for a, b in zip(got, losses[half:])) <= LOSS_GAP
    # (its train metrics counted steps 5-8 twice: only losses and parameters)
    _gaps("BST, resumed after a restore", losses[:half] + resumed, eager_losses, graph,
          eager, init, metrics=False)


@pytest.mark.cuda
def test_third_step_of_a_fresh_trainer_is_a_replay(cuda, gen, tmp_path):
    tr = _trainer(gen, tmp_path, "BST", "cuda")
    batches = _batches(gen, "compact", 3)
    tr.train_step(batches[0])
    assert tr.replays == 0  # the warm-up, eager
    tr.train_step(batches[1])
    assert tr.replays == 1  # captured, then replayed
    loss = tr.train_step(batches[2])
    assert tr.replays == 2 and tr.step == 3
    # the returned loss is the caller's: the next replay leaves it alone
    kept = float(loss)
    tr.train_step(batches[0])
    assert float(loss) == kept


@pytest.mark.cuda
def test_card_trace_shows_the_hand_kernels_a_replay_runs(cuda, gen, tmp_path):
    """chip_smoke.py's ``card_kernels`` counts what replayed steps ran on
    the card (the wrappers count the warm-up's call and the capture's)."""
    from recalgorithm_tpu_torch.ops.cuda import bst_attention as bk

    tr = _trainer(gen, tmp_path, "BST", "cuda")
    batches = _batches(gen, "compact", 5)
    _run(tr, batches[:3])
    before = (bk.bst_attention_forward_save.launches, bk.bst_attention_backward.launches)
    with chip_smoke.card_kernels() as ran:
        _run(tr, batches[3:])
    assert tr.replays == 4
    counts = chip_smoke.hand_counts(ran)
    assert (counts["bst_attention_forward_save"], counts["bst_attention_backward"]) == (2, 2)
    assert counts["bst_attention_forward"] == counts["din_attention"] == 0
    assert chip_smoke.compacted_gathers(ran) == 2
    assert (bk.bst_attention_forward_save.launches,
            bk.bst_attention_backward.launches) == before  # no wrapper call


@pytest.mark.cuda
def test_a_batch_with_an_index_column_replays(cuda, gen, tmp_path):
    graph, eager = _pair(gen, tmp_path)
    batches = _batches(gen, "compact")
    for i, b in enumerate(batches):
        b["_index"] = np.arange(i * len(b["labels"]), (i + 1) * len(b["labels"]))
    init = _init(graph)
    losses, eager_losses = _run(graph, batches), _run(eager, batches)
    assert graph.replays == STEPS - 1
    _gaps("BST, batches with _index", losses, eager_losses, graph, eager, init)


@pytest.mark.cuda
def test_sgd_graph_matches_eager(cuda, gen, tmp_path):
    graph, eager = _pair(gen, tmp_path, optimizer=optimizers.build("sgd", 0.05))
    batches = _batches(gen, "compact")
    init = _init(graph)
    losses, eager_losses = _run(graph, batches), _run(eager, batches)
    assert graph.replays == STEPS - 1
    _gaps("BST, SGD", losses, eager_losses, graph, eager, init)


@pytest.mark.cuda
def test_a_non_capturable_optimizer_stays_eager_on_cuda(cuda, gen, tmp_path):
    tr = _trainer(gen, tmp_path, "BST", "cuda", optimizers.build("adagrad", 0.05))
    assert tr._step_graphs is None
    _run(tr, _batches(gen, "compact", 3))
    assert tr.replays == 0


def test_config_has_no_new_field():
    """The graph adapts to what it observes: TrainerConfig gains no field."""
    assert {f.name for f in dataclasses.fields(TrainerConfig)} == {
        "model_dir", "train_steps", "log_every", "eval_every_steps", "eval_throttle_secs",
        "save_checkpoints_steps", "keep_best", "seed", "fuse_optimizer",
        "compact_grad_scatter", "handle_sigterm", "grad_accum_steps"}
