"""Adagrad on the tables' touched rows (``embed/tables.row_sparse_grads``,
``optimizers.Adagrad``'s row path, ``ops/cuda/row_adagrad``) held to the
dense chain on the CPU, where the row path is the kernel's plain twin; the
trainer's engagement rule; and the benchmark's reader of
``train.row_update`` spans.

A row no step touches has a zero gradient and does not move under Adagrad,
so after the same steps both paths hold the same parameters and
accumulators.  Where each row's gradient rows are summed in the same order
(one lookup a table: the dense backward sums into zeros in position order,
the twin in the stable order of equal ids) they are bitwise equal; where
two lookups of a table meet (the dense path adds two dense gradients, the
row path sums one concatenated list) the sums round in another order, so
they agree within 1e-6 of each tensor's norm (float32 rounding of a few
terms, far below a fault such as a row left out or stepped twice).

On the card (``-m cuda``; imports neither JAX nor the JAX package, so it runs
without this directory's conftest)::

    python -m pytest tests/test_torch_row_adagrad.py -q -m cuda --noconftest
"""

import copy

import numpy as np
import pytest
import torch
from torch import nn

from portbench import harness, spans
from portbench.trace import Trace
from recalgorithm_tpu_torch.embed import tables
from recalgorithm_tpu_torch.embed.tables import EmbeddingCollection, TableSpec
from recalgorithm_tpu_torch.features import schema as S
from recalgorithm_tpu_torch.models.dlrm import DLRM, DLRMConfig
from recalgorithm_tpu_torch.ops import compact_scatter as cs
from recalgorithm_tpu_torch.ops.cuda import row_adagrad as ra
from recalgorithm_tpu_torch.train import optimizers, step_graph
from recalgorithm_tpu_torch.train.loop import Trainer, TrainerConfig
from recalgorithm_tpu_torch.utils.summary import SpanRecord

STEPS = 3
DIM = 8
NORM_RTOL = 1e-6
LR = 0.05


class _Tables(nn.Module):
    """Sum-pooled lookups of ``fields`` (field name -> table), a linear
    head, and optionally a dense term on one table."""

    def __init__(self, specs, fields, dense_term=None):
        super().__init__()
        self.embed = EmbeddingCollection(specs, torch.Generator().manual_seed(7))
        self.fields = fields
        self.dense_term = dense_term
        self.head = nn.Linear(DIM * len(fields), 1)
        with torch.no_grad():
            self.head.weight.copy_(torch.linspace(-1.0, 1.0, DIM * len(fields)))
            self.head.bias.fill_(0.25)

    def forward(self, batch):
        parts = [self.embed.embed_pooled(t, batch[f], "sum") if batch[f].dim() == 2
                 else self.embed.embed_scalar(t, batch[f]) for f, t in self.fields.items()]
        out = self.head(torch.cat(parts, dim=1))[:, 0]
        loss = (out - batch["y"]).square().mean()
        if self.dense_term is not None:
            loss = loss + 1e-3 * self.embed.tables[self.dense_term].square().sum()
        return loss


def _ids(rng, shape, low, high):
    return torch.from_numpy(rng.integers(low, high, size=shape).astype(np.int32))


def _case(name):
    """The model's tables and fields, its batches, the accumulator start,
    and whether the two paths sum every row in the same order."""
    rng = np.random.default_rng(3)
    big, small = TableSpec("big", 3000, DIM), TableSpec("small", 40, DIM)
    specs = {"big": big, "small": small}
    fields = {"a": "big", "b": "small"}
    acc0, bitwise, dense_term = 1e-8, True, None

    def batch(i):
        return {"a": _ids(rng, (16, 5), 1, 30),  # repeated ids in every batch
                "b": _ids(rng, (16,), 1, 41),
                "y": torch.from_numpy(rng.normal(size=16).astype(np.float32))}

    make = batch
    if name == "out_of_range":
        def make(i):
            b = batch(i)
            b["a"][:, 0] = torch.from_numpy(rng.integers(-3, 1, 16).astype(np.int32))
            b["a"][:, 1] = big.num_rows + torch.from_numpy(rng.integers(0, 50, 16)
                                                           .astype(np.int32))
            b["b"][:4] = torch.tensor([-1, 0, small.num_rows, small.num_rows + 9])
            return b
    elif name == "two_fields":
        fields = {"a": "big", "b": "small", "c": "big"}
        bitwise = False

        def make(i):
            return batch(i) | {"c": _ids(rng, (16, 3), 1, 30)}
    elif name == "acc_zero":
        acc0 = 0.0
    elif name == "dense_rule":
        specs = {"big": TableSpec("big", 2000, DIM), "small": small}  # 2048 padded rows
        assert specs["big"].num_rows <= tables.DENSE_LOOKUP_MAX_ROWS
    elif name == "mixed_group":
        dense_term, bitwise = "small", False  # the small table's gradient goes dense
    return specs, fields, [make(i) for i in range(STEPS)], acc0, bitwise, dense_term


def _run(name, rows: bool, resume_after: int | None = None):
    specs, fields, batches, acc0, _, dense_term = _case(name)
    model = _Tables(specs, fields, dense_term)
    opt = optimizers.build("adagrad", LR, initial_accumulator_value=acc0, eps=1e-8)(
        model.parameters())
    grads = []
    for i, b in enumerate(batches):
        opt.zero_grad()
        with tables.row_sparse_grads(rows):
            loss = model(b)
        loss.backward()
        grads.append({k: p.grad.is_sparse for k, p in model.named_parameters()})
        opt.step()
        if resume_after is not None and i + 1 == resume_after:
            saved = (copy.deepcopy(model.state_dict()), copy.deepcopy(opt.state_dict()))
            model = _Tables(specs, fields, dense_term)
            model.load_state_dict(saved[0])
            opt = optimizers.build("adagrad", LR, initial_accumulator_value=acc0, eps=1e-8)(
                model.parameters())
            opt.load_state_dict(saved[1])
    state = opt.opt.state
    accs = {k: state[p]["sum_of_squares"].clone() for k, p in model.named_parameters()}
    return {k: p.detach().clone() for k, p in model.named_parameters()}, accs, grads


def _norm_gap(a, b):
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp(min=1e-300))


CASES = ["repeated", "out_of_range", "two_fields", "acc_zero", "acc_1e-8", "dense_rule",
         "mixed_group", "state_dict"]


@pytest.mark.parametrize("case", CASES)
def test_row_path_equals_the_dense_chain(case):
    name = "repeated" if case in ("acc_1e-8", "state_dict") else case
    *_, bitwise, dense_term = _case(name)
    dense_p, dense_acc, dense_grads = _run(name, rows=False)
    row_p, row_acc, row_grads = _run(name, rows=True,
                                     resume_after=1 if case == "state_dict" else None)
    assert not any(any(g.values()) for g in dense_grads)
    for g in row_grads:  # the tables' gradients are rows, unless a dense term meets them
        assert g == {"embed.tables.big": True, "embed.tables.small": dense_term is None,
                     "head.weight": False, "head.bias": False}
    for k in dense_p:
        moved = dense_p[k] - _Tables(*_case(name)[:2], dense_term).state_dict()[k]
        assert float(moved.abs().max()) > 0, k  # every parameter is trained
        if bitwise:
            assert torch.equal(row_p[k], dense_p[k]), k
            assert torch.equal(row_acc[k], dense_acc[k]), k
        else:
            assert _norm_gap(row_p[k], dense_p[k]) < NORM_RTOL, k
            assert _norm_gap(row_acc[k], dense_acc[k]) < NORM_RTOL, k


def test_untouched_rows_do_not_move():
    """The twin writes only the rows its ids name."""
    rng = np.random.default_rng(5)
    p = torch.from_numpy(rng.normal(size=(50, 4)).astype(np.float32))
    acc = torch.zeros_like(p)
    ids = torch.tensor([3, 7, 3, 49, 0])
    values = torch.from_numpy(rng.normal(size=(5, 4)).astype(np.float32))
    p0 = p.clone()
    ra.row_adagrad(p, acc, ids, values, 0.1, 1e-8)
    touched = torch.zeros(50, dtype=torch.bool)
    touched[ids] = True
    assert torch.equal(p[~touched], p0[~touched]) and not acc[~touched].any()
    g3 = values[0] + values[2]
    assert torch.equal(acc[3], g3 * g3)
    assert not torch.equal(p[3], p0[3])


def test_twin_rejects_nothing_but_the_kernel_checks_its_inputs():
    p = torch.zeros(256, 6)
    with pytest.raises(ValueError, match="no kernel"):
        ra.row_adagrad(p.to("meta"), p.to("meta"), torch.zeros(1, dtype=torch.long,
                                                                device="meta"),
                       torch.zeros(1, 6, device="meta"), 0.1, 1e-8)
    with pytest.raises(ValueError, match="columns"):
        ra._check(p, p, torch.zeros(3, dtype=torch.long), torch.zeros(3, 5))
    with pytest.raises(ValueError, match="up to"):
        wide = torch.zeros(4, 130)
        ra._check(wide, wide, torch.zeros(1, dtype=torch.long), torch.zeros(1, 130))
    with pytest.raises(TypeError, match="float32"):
        ra._check(p.double(), p, torch.zeros(1, dtype=torch.long), torch.zeros(1, 6))


# ---------------------------------------------------------------------------
# the trainer: DLRM-DCNv2 at a small size, and the engagement rule
# ---------------------------------------------------------------------------

B = 32
VOCABS = [min(n, 300 + 37 * i) for i, n in enumerate(S.CRITEO_VOCAB_SIZES)]


def _dlrm():
    cfg = DLRMConfig(interaction="dcn", embedding_dim=DIM, bottom_hidden_units=(16, 8),
                     hidden_units=(16, 8, 4), batch_norm=False, dropout_rate=0.0,
                     num_cross_layers=2, cross_low_rank=4, optimizer="adagrad",
                     learning_rate=0.004, adagrad_initial_accumulator_value=0.0,
                     adagrad_eps=1e-8, task_names=("click",), batch_size=B)
    torch.manual_seed(11)
    return DLRM(cfg, S.criteo_schema({f"cat_{i}": n for i, n in enumerate(VOCABS)})), cfg


def _criteo_batches(n=STEPS):
    rng = np.random.default_rng(17)
    out = []
    for _ in range(n):
        b = {"dense": rng.normal(size=(B, 13)).astype(np.float32),
             "labels": rng.integers(0, 2, size=(B, 1)).astype(np.float32)}
        for i, (v, h) in enumerate(zip(VOCABS, S.CRITEO_HOT_SIZES)):
            ids = (np.floor(v * rng.random((B, h)) ** 2) + 1).astype(np.int32)
            b[f"cat_{i}"] = ids[:, 0] if h == 1 else ids
            if h > 1:
                b[f"cat_{i}_len"] = np.full(B, h, np.int32)
        out.append(b)
    return out


def _trainer(tmp_path, tag, optimizer=None, **config):
    model, cfg = _dlrm()
    opt = optimizer or optimizers.build("adagrad", cfg.learning_rate,
                                        **cfg.optimizer_options())
    return Trainer(model, ("click",), opt,
                   TrainerConfig(model_dir=str(tmp_path / tag), save_checkpoints_steps=0,
                                 handle_sigterm=False, **config), device="cpu")


def test_dlrm_trainer_row_path_equals_the_dense_chain(tmp_path):
    """Three ``train_step`` s of DLRM-DCNv2's trainer (Adagrad from 0):
    its tables take row gradients, and end bitwise where the dense chain
    ends; every table and accumulator moved."""
    runs = {}
    for rows in (True, False):
        tr = _trainer(tmp_path, str(rows))
        assert tr.row_grads is True
        tr.row_grads = rows
        losses = [float(tr.train_step(b)) for b in _criteo_batches()]
        sparse = {k for k, p in tr.model.named_parameters() if p.grad.is_sparse}
        state = tr.optimizer.opt.state
        runs[rows] = (losses, sparse,
                      {k: p.detach().clone() for k, p in tr.model.named_parameters()},
                      {k: state[p]["sum_of_squares"].clone()
                       for k, p in tr.model.named_parameters()})
    assert runs[True][0] == runs[False][0]
    assert runs[True][1] == {f"embedder.embed.tables.cat_{i}" for i in range(26)}
    assert runs[False][1] == set()
    for k, p in runs[False][2].items():
        assert torch.equal(runs[True][2][k], p), k
        assert torch.equal(runs[True][3][k], runs[False][3][k]), k
        assert float(runs[False][3][k].max()) > 0, k


def _tensor_rate_adam():
    return optimizers.Optimizer(optimizers.Adam([nn.Parameter(torch.zeros(2))],
                                                lr=torch.tensor(0.1)), lambda s: 0.1)


def _built(name):
    return optimizers.build(name, 0.1)([nn.Parameter(torch.zeros(2))])


def _dual(deep="adagrad"):
    return optimizers.DualOptimizer(wide=_built("ftrl"), deep=_built(deep))


RULE = {
    "adagrad": (None, 1, lambda: _built("adagrad"), True),
    "adam": (None, 1, _tensor_rate_adam, False),
    "adam_host_rate": (None, 1, lambda: _built("adam"), False),
    "sgd": (None, 1, lambda: _built("sgd"), False),
    "rmsprop": (None, 1, lambda: _built("rmsprop"), False),
    "lazyadam": (None, 1, lambda: _built("lazyadam"), False),
    "dual_ftrl_adagrad": (None, 1, _dual, False),
    "mesh": (object(), 1, lambda: _built("adagrad"), False),
    "grad_accum": (None, 2, lambda: _built("adagrad"), False),
}


@pytest.mark.parametrize("case", RULE)
def test_engagement_rule(case):
    mesh, accum, make, want = RULE[case]
    assert step_graph.engaged("cpu", mesh, accum, make()).row_grads is want


def test_captured_body_makes_row_gradients_as_the_eager_step(tmp_path):
    """The step body run as a capture runs it (the optimizer's update
    alone, the rate written first), without a graph: under Adagrad its
    tables take row gradients and it ends bitwise where the eager step
    ends."""
    runs = {}
    for mode in ("eager", "capture"):
        tr = _trainer(tmp_path, mode)
        assert tr.row_grads is True
        for b in _criteo_batches():
            if mode == "eager":
                loss = tr.train_step(b)
            else:
                tr.optimizer.prepare()
                compact = cs.batch_fits_compact(b, tr.model.schema)
                loss = tr._step_body(tr._put_batch(b), compact, tr.optimizer.apply)
            sparse = {k for k, p in tr.model.named_parameters() if p.grad.is_sparse}
            assert sparse == {f"embedder.embed.tables.cat_{i}" for i in range(26)}, mode
        runs[mode] = (float(loss), {k: p.detach().clone()
                                    for k, p in tr.model.named_parameters()})
    assert runs["capture"][0] == runs["eager"][0]
    for k, p in runs["eager"][1].items():
        assert torch.equal(runs["capture"][1][k], p), k


@pytest.mark.parametrize("case", ["adam", "sgd", "dual", "grad_accum"])
def test_bypassed_trainers_make_no_row_gradient(tmp_path, case):
    """Trainers the rule bypasses step with dense gradients only: their
    lookups never enter the row path, so their steps are the ones they had."""
    model, _ = _dlrm()
    names = [n for n, _ in model.named_parameters()]
    opt = {"adam": lambda: optimizers.build("adam", 0.01),
           "sgd": lambda: optimizers.build("sgd", 0.01),
           "dual": lambda: optimizers.dual_wide_deep(
               0.05, "adagrad", 0.01, lambda n: n.endswith("tables.cat_0"), names),
           "grad_accum": lambda: optimizers.build("adagrad", 0.01)}[case]()
    config = {"grad_accum_steps": 2} if case == "grad_accum" else {}
    tr = Trainer(model, ("click",), opt,
                 TrainerConfig(model_dir=str(tmp_path), save_checkpoints_steps=0,
                               handle_sigterm=False, **config), device="cpu")
    assert tr.row_grads is False
    for b in _criteo_batches(4):
        tr.train_step(b)
        assert all(p.grad is None or not p.grad.is_sparse for p in tr.model.parameters())


def test_compacted_branch_not_taken_under_row_gradients(monkeypatch):
    """Inside ``row_sparse_grads`` a long sequence lookup that the compacted
    gradient would take gathers plainly, and its gradient is rows."""
    emb = EmbeddingCollection({"t": TableSpec("t", 5000, 4)}, torch.Generator().manual_seed(1))
    ids = torch.randint(0, 5000, (400, 64), dtype=torch.int32)
    taken = []
    monkeypatch.setattr(tables.cs, "take_compact_bwd",
                        lambda *a: taken.append(1) or (_ for _ in ()).throw(AssertionError))
    with tables.compact_grad_scatter(True), tables.row_sparse_grads(True):
        out = emb.embed_sequence("t", ids)
    out.sum().backward()
    assert not taken and emb.tables["t"].grad.is_sparse
    assert emb.tables["t"].grad._values().shape == (400 * 64, 4)
    with tables.compact_grad_scatter(True), pytest.raises(AssertionError):
        emb.embed_sequence("t", ids)  # outside it, the compacted branch is taken


def test_row_update_span_under_the_optimizer(tmp_path):
    """An eager step on the row path records one ``train.row_update``
    under its ``train.optimizer``; the reader reads 100."""
    from torch.profiler import ProfilerActivity, profile

    from recalgorithm_tpu_torch.utils import summary

    summary.clear()
    tr = _trainer(tmp_path, "spans")
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            for b in _criteo_batches(2):
                tr.train_step(b)
        got, _ = spans.under(summary.spans(), "train.optimizer", "train.row_update")
        assert len(got) == 2
        assert _reader().read(_trace()) == pytest.approx(100.0)
    finally:
        summary.clear()


# ---------------------------------------------------------------------------
# the benchmark's reader: portbench/metrics/row_update_share.train.py
# ---------------------------------------------------------------------------


def _reader():
    return harness.metric_module("row_update_share.train")


def _trace(kind="train", cfg=None):
    return Trace(kind=kind, cfg={"multi_hot_sizes": [1]} if cfg is None else cfg,
                 window_s=1.0, busy_s=0.5, events=[], breakdown={}, data={"steps": 2})


def _steps(updated):
    """One ``train.step`` a flag, each with a ``train.optimizer`` holding a
    ``train.row_update`` where its flag is set, and a stray one outside."""
    out, i = [], 0
    for s, flag in enumerate(updated):
        step, opt = i + 1, i + 2
        out += [SpanRecord("train.step", step, None, s, s + 0.5),
                SpanRecord("train.optimizer", opt, step, s + 0.1, s + 0.2)]
        if flag:
            out.append(SpanRecord("train.row_update", i + 3, opt, s + 0.1, s + 0.15))
        i += 3
    return out + [SpanRecord("train.row_update", 999, None, 0.0, 0.1)]


@pytest.mark.parametrize("updated,want", [((True, True, True), 100.0),
                                          ((True, False), 50.0),
                                          ((False, False), None)])
def test_row_update_share_reader(monkeypatch, updated, want):
    monkeypatch.setattr(spans, "recorded", lambda: _steps(updated))
    got = _reader().read(_trace())
    assert got == (pytest.approx(want) if want is not None else None)
    assert _reader().read(_trace("serve")) is None
    assert _reader().read(_trace(cfg={"model": "BST"})) is None


def test_row_update_share_reader_reads_nothing_without_a_recorder(monkeypatch):
    monkeypatch.setattr(spans, "recorded", lambda: None)
    assert _reader().read(_trace()) is None


def test_row_update_share_reader_agrees_with_its_entry():
    entry = next(m for m in harness.benchmark()["per_layer"]
                 if m["name"] == "row_update_share.train")
    mod = _reader()
    assert (mod.LAYER, mod.UNIT, mod.SOURCE, mod.MOVES, mod.KIND) == (
        entry["layer"], entry["unit"], entry["source"], entry["moves"], "train_dlrm")
    assert entry["workloads"] == ["dlrm-dcnv2-train-multihot"]
    assert entry["better"] == "higher"
    assert harness.cell("dlrm-dcnv2-train-multihot")["kind"] == mod.KIND


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the row kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("dim,rows,n,skew", [(128, 300_000, 40_000, 2.0), (128, 256, 8192, 1.0),
                                             (16, 5000, 3000, 2.0), (6, 700, 2000, 1.0),
                                             (256, 1000, 5000, 3.0)])
def test_kernel_matches_twin(cuda, dim, rows, n, skew):
    """The kernel against its twin on the card: the touched rows within
    float32 rounding of a few summed rows, every other row bitwise."""
    gen = torch.Generator(device="cuda").manual_seed(dim + rows)
    p = torch.randn(rows, dim, device="cuda", generator=gen)
    acc = torch.rand(rows, dim, device="cuda", generator=gen) * (rows % 2)
    u = torch.rand(n, device="cuda", generator=gen)
    ids = (rows * u ** skew).long().clamp(0, rows - 1)
    values = torch.randn(n, dim, device="cuda", generator=gen)
    p2, acc2 = p.clone(), acc.clone()
    launches = ra.row_adagrad.launches
    ra.row_adagrad(p, acc, ids, values, 0.01, 1e-8)
    ra.row_adagrad_reference(p2, acc2, ids, values, 0.01, 1e-8)
    torch.cuda.synchronize()
    assert ra.row_adagrad.launches == launches + 1
    assert _norm_gap(acc, acc2) < 1e-6 and _norm_gap(p, p2) < 1e-6
    untouched = torch.ones(rows, dtype=torch.bool, device="cuda")
    untouched[ids] = False
    assert torch.equal(p[untouched], p2[untouched])
