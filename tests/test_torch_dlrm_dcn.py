"""DLRM-DCNv2 (``DLRMConfig(interaction="dcn")``) on the multi-hot Criteo
schema, held to the benchmark's plain reference (``portbench/reference/
dlrm.py``) on the CPU at a small size: dim 8, the 26 published hot sizes,
small vocabularies, cross rank 4, dense arch 16-8, over arch 16-16-8-4-1.

The reference runs in float64 on the same (float32) weights, so each gap
below is the program's own float32 rounding: a sum of K terms rounds to
about sqrt(K) * 6e-8 of the sum of their magnitudes, with K at most a few
hundred here (the cross's width is 8 + 26 * 8 = 216, a bag at most 100
ids).  Norm-wise gaps of a few 1e-6 of the reference's norm stay well
above that and well below any fault: a leaf's gradient off by one row of
one bag, or a step of the wrong sign, moves its leaf's norm by percent.
Also: the schema's batch spec, the benchmark configuration's slice of the
published tables and its traffic's ids inside it, Adagrad's grouped update,
the spans, and ``cli.main --dataset criteo`` on the CPU."""

import copy
import json
import math
import os

import numpy as np
import pytest
import torch

from portbench import weights_dlrm
from portbench.reference import dlrm as ref_dlrm
from portbench.traffic import criteo as criteo_traffic
from recalgorithm_tpu_torch.features import schema as S
from recalgorithm_tpu_torch.models.dlrm import DLRM, DLRMConfig, dcn_fields
from recalgorithm_tpu_torch.train import optimizers
from recalgorithm_tpu_torch.train.loop import Trainer, TrainerConfig
from recalgorithm_tpu_torch.utils import summary

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "portbench", "configs", "dlrm-dcnv2-criteo1tb.json")
SEED = 2147483999
B = 64
VOCABS = [min(n, 1000 + 37 * i) for i, n in enumerate(S.CRITEO_VOCAB_SIZES)]

# The configuration file's keys, at the small size.
SMALL = {
    "num_dense": 13, "embedding_dim": 8, "num_embeddings_per_feature": VOCABS,
    "multi_hot_sizes": list(S.CRITEO_HOT_SIZES), "dense_arch_layer_sizes": [16, 8],
    "dcn_num_layers": 3, "dcn_low_rank_dim": 4, "over_arch_layer_sizes": [16, 16, 8, 4, 1],
    "optimizer": {"name": "adagrad", "learning_rate": 0.004,
                  "initial_accumulator_value": 0.0, "eps": 1e-8},
    "table_row_align": 256, "batch_size": B,
}
TRAFFIC = {"num_batches": 3, "dense_poisson_lam": 3.0, "label_rate": 0.25}

# Norm-wise gap of a leaf (its gradient or value) over the reference's norm:
# float32 rounding (module docstring).
NORM_RTOL = 1e-5
# Loss and logits: one float32 rounding of sums of at most a few hundred terms.
LOGIT_ATOL = 2e-5


def small_schema():
    return S.criteo_schema({f"cat_{i}": n for i, n in enumerate(VOCABS)})


def small_model(cfg=SMALL, seed=SEED):
    opt = cfg["optimizer"]
    mcfg = DLRMConfig(interaction="dcn", embedding_dim=cfg["embedding_dim"],
                      bottom_hidden_units=tuple(cfg["dense_arch_layer_sizes"]),
                      hidden_units=tuple(cfg["over_arch_layer_sizes"][:-1]),
                      batch_norm=False, dropout_rate=0.0,
                      num_cross_layers=cfg["dcn_num_layers"],
                      cross_low_rank=cfg["dcn_low_rank_dim"], optimizer=opt["name"],
                      learning_rate=opt["learning_rate"],
                      adagrad_initial_accumulator_value=opt["initial_accumulator_value"],
                      adagrad_eps=opt["eps"], task_names=("click",), batch_size=B)
    model = DLRM(mcfg, small_schema())
    weights_dlrm.load_(model, cfg, seed)
    return model, mcfg


@pytest.fixture(scope="module")
def host_batches():
    return criteo_traffic.batches(SMALL, TRAFFIC, B, SEED)


def tensors(batch, dtype=None):
    out = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    if dtype is not None:
        out["dense"], out["labels"] = out["dense"].to(dtype), out["labels"].to(dtype)
    return out


def f64(params):
    return {k: v.detach().double() for k, v in params.items()}


def norm_gap(a, b):
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).norm() / b.norm().clamp(min=1e-300))


# ---------------------------------------------------------------------------
# the schema
# ---------------------------------------------------------------------------


def test_criteo_schema_batch_spec():
    schema = S.criteo_schema()
    spec = schema.batch_spec(7)
    assert spec["dense"] == ((7, 13), np.dtype(np.float32))
    assert spec["labels"] == ((7, 1), np.dtype(np.float32)) and schema.labels == ("click",)
    one_hot = [i for i, h in enumerate(S.CRITEO_HOT_SIZES) if h == 1]
    assert len(one_hot) == 11 and len(schema.sequence) == 15
    for i, h in enumerate(S.CRITEO_HOT_SIZES):
        if h == 1:
            assert spec[f"cat_{i}"] == ((7,), np.dtype(np.int32))
            assert f"cat_{i}_len" not in spec
        else:
            assert spec[f"cat_{i}"] == ((7, h), np.dtype(np.int32))
            assert spec[f"cat_{i}_len"] == ((7,), np.dtype(np.int32))
    assert sum(S.CRITEO_HOT_SIZES) == 214
    assert schema.vocab_sizes["cat_0"] == 40_000_000 and schema.vocab_sizes["cat_25"] == 36
    assert [f[0] for f in dcn_fields(schema)] == [f"cat_{i}" for i in range(26)]


def test_criteo_schema_overrides():
    schema = S.criteo_schema({"cat_0": 5}, hot_sizes=[1] * 26)
    assert schema.vocab_sizes["cat_0"] == 5 and schema.vocab_sizes["cat_1"] == 39060
    assert not schema.sequence and len(schema.categorical) == 26
    with pytest.raises(ValueError, match="26 hot sizes"):
        S.criteo_schema(hot_sizes=[1] * 25)


def test_benchmark_config_slices_the_published_tables():
    """The held rows: an eighth (rounded up) of each table of over 100,000
    rows, every other table whole; ``reduced`` names exactly the sliced
    ones; the traffic's ids lie in [1, held rows] of each table."""
    with open(CONFIG) as f:
        cfg = json.load(f)
    held = cfg["num_embeddings_per_feature"]
    sliced = []
    for i, (pub, n) in enumerate(zip(S.CRITEO_VOCAB_SIZES, held)):
        assert n == (math.ceil(pub / 8) if pub > 100_000 else pub)
        if n != pub:
            sliced.append(f"num_embeddings_per_feature.{i}")
            assert cfg["sliced"][sliced[-1]] == {"published": pub, "held": n}
    assert cfg["reduced"] == sliced and len(sliced) == 8
    assert cfg["multi_hot_sizes"] == list(S.CRITEO_HOT_SIZES)
    rows = sum(weights_dlrm.table_rows(cfg, i) for i in range(26))
    assert 13.0e9 < rows * cfg["embedding_dim"] * 4 < 13.2e9
    batch = criteo_traffic.batches(cfg, {**TRAFFIC, "num_batches": 1}, 512, SEED)[0]
    for i, (n, h) in enumerate(zip(held, cfg["multi_hot_sizes"])):
        ids = batch[f"cat_{i}"]
        assert ids.shape == ((512,) if h == 1 else (512, h)) and ids.dtype == np.int32
        assert ids.min() >= 1 and ids.max() <= n
        if h > 1:
            assert (batch[f"cat_{i}_len"] == h).all()


# ---------------------------------------------------------------------------
# the model against the reference
# ---------------------------------------------------------------------------


def test_weights_spec_is_the_state_dict():
    model, _ = small_model()
    spec = weights_dlrm.spec(SMALL)
    assert [(n, tuple(s)) for n, s, _ in spec] == [
        (k, tuple(v.shape)) for k, v in model.state_dict().items()]


def test_forward_loss_and_gradients_match_reference(host_batches):
    model, _ = small_model()
    batch = tensors(host_batches[0])
    logits, reg = model(batch)
    assert not reg and set(logits) == {"click"}
    loss = torch.nn.functional.binary_cross_entropy_with_logits(
        logits["click"], batch["labels"][:, 0])
    loss.backward()

    params = {k: v.requires_grad_(True) for k, v in f64(dict(model.named_parameters())).items()}
    ref_batch = tensors(host_batches[0], torch.float64)
    ref_logits = ref_dlrm.logits(params, SMALL, ref_batch)
    ref_loss = ref_dlrm.loss(params, SMALL, ref_batch)
    grads = dict(zip(params, torch.autograd.grad(ref_loss, list(params.values()))))

    torch.testing.assert_close(logits["click"].double(), ref_logits.detach(),
                               atol=LOGIT_ATOL, rtol=0)
    assert abs(float(loss.detach()) - float(ref_loss.detach())) < LOGIT_ATOL
    named = dict(model.named_parameters())
    assert set(named) == set(grads)
    for k, g in grads.items():
        assert norm_gap(named[k].grad, g) < NORM_RTOL, k
        assert float(g.norm()) > 0, k  # every leaf is trained


def test_three_adagrad_steps_match_reference(host_batches):
    """Three ``Trainer.train_step`` s with the configuration's Adagrad
    (accumulator from 0, eps 1e-8 inside the root) against the reference's
    three steps: each loss, the accumulators and every leaf after."""
    model, mcfg = small_model()
    trainer = Trainer(model, ("click",),
                      optimizers.build("adagrad", 0.004, **mcfg.optimizer_options()),
                      TrainerConfig(handle_sigterm=False, model_dir="unused"), device="cpu")
    assert mcfg.optimizer_options() == {"initial_accumulator_value": 0.0, "eps": 1e-8}
    losses = [float(trainer.train_step(b)) for b in host_batches]

    params = f64(weights_dlrm.make(SMALL, SEED, "cpu"))
    ref_batches = [tensors(b, torch.float64) for b in host_batches]
    ref_losses, first, after = ref_dlrm.train(params, SMALL, ref_batches)
    np.testing.assert_allclose(losses, ref_losses, atol=LOGIT_ATOL, rtol=0)
    assert len(first) == len(after) == len(weights_dlrm.spec(SMALL))
    state = trainer.optimizer.opt.state
    for k, p in trainer.model.named_parameters():
        assert norm_gap(p, after[k]) < NORM_RTOL, k
        moved = p.detach().double() - weights_dlrm.leaf(SMALL, SEED, k, "cpu").double()
        ref_moved = after[k] - weights_dlrm.leaf(SMALL, SEED, k, "cpu").double()
        assert norm_gap(moved, ref_moved) < 1e-3, k  # three steps of at most lr each
        assert float(ref_moved.norm()) > 0, k
        assert float(state[p]["sum_of_squares"].min()) >= 0.0


def test_adagrad_groups_are_bitwise_one_chain(monkeypatch, host_batches):
    """Cutting the update into groups changes no bit: every op is
    coordinate-wise."""
    def three_steps():
        model, mcfg = small_model()
        trainer = Trainer(model, ("click",),
                          optimizers.build("adagrad", 0.004, **mcfg.optimizer_options()),
                          TrainerConfig(handle_sigterm=False, model_dir="unused"),
                          device="cpu")
        for b in host_batches:
            trainer.train_step(b)
        return {k: v.clone() for k, v in trainer.model.state_dict().items()}

    whole = three_steps()
    monkeypatch.setattr(optimizers, "FOREACH_GROUP_ELEMENTS", 100)
    grouped = three_steps()
    assert all(torch.equal(whole[k], grouped[k]) for k in whole)


def test_groups_cover_every_tensor_once(monkeypatch):
    ts = [torch.zeros(n) for n in (3, 5, 200, 1, 1, 150, 2)]
    monkeypatch.setattr(optimizers, "FOREACH_GROUP_ELEMENTS", 10)
    groups = list(optimizers._groups(ts, list(range(len(ts)))))
    assert [g[1] for g in groups] == [[0, 1], [2], [3, 4], [5], [6]]
    assert list(optimizers._groups([], [])) == []


def test_build_passes_options_to_adagrad_only():
    p = [torch.nn.Parameter(torch.zeros(3))]
    opt = optimizers.build("adagrad", 0.1, initial_accumulator_value=0.0, eps=1e-8)(p).opt
    assert opt.param_groups[0]["initial_accumulator_value"] == 0.0
    assert opt.param_groups[0]["eps"] == 1e-8
    assert optimizers.build("adagrad", 0.1)(p).opt.param_groups[0]["eps"] == 1e-7
    with pytest.raises(ValueError, match="takes no options"):
        optimizers.build("adam", 0.1, eps=1e-3)
    assert DLRMConfig().optimizer_options() == {}


def test_wechat_form_unchanged():
    """The default (dot) form keeps its leaves and never builds a cross."""
    model = DLRM(DLRMConfig(), S.wechat_schema(), torch.Generator().manual_seed(0))
    names = list(model.state_dict())
    assert names[0].startswith("bottom.") and not any(n.startswith("cross.") for n in names)
    assert any(n.startswith("bottom_out.") for n in names)
    with pytest.raises(ValueError, match="unknown interaction"):
        DLRM(DLRMConfig(interaction="cat"), S.wechat_schema())


def test_spans_recorded_in_forward(host_batches):
    model, _ = small_model()
    summary.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        model(tensors(host_batches[0]))
    names = [r.name for r in summary.spans()]
    summary.clear()
    assert names.count("dlrm.embed") == 1 and names.count("dlrm.interaction") == 1


# ---------------------------------------------------------------------------
# the training CLI
# ---------------------------------------------------------------------------


def test_cli_trains_criteo_dcn(tmp_path):
    from recalgorithm_tpu_torch.cli import main as tmain

    final = tmain.main([
        "--model", "DLRM", "--dataset", "criteo", "--synthetic",
        "--synthetic_vocab_scale", "0.0001", "--batch_size", "32", "--train_steps", "3",
        "--log_every", "1", "--interaction", "dcn", "--embedding_dim", "8",
        "--bottom_hidden_units", "16,8", "--hidden_units", "16,8", "--cross_low_rank", "4",
        "--batch_norm", "false", "--dropout_rate", "0", "--optimizer", "adagrad",
        "--learning_rate", "0.004", "--adagrad_initial_accumulator_value", "0",
        "--adagrad_eps", "1e-8", "--task_names", "click", "--device", "cpu",
        "--model_dir", str(tmp_path), "--predictions_csv", str(tmp_path / "p.csv")])
    assert 0.0 <= final["click_auc"] <= 1.0 and math.isfinite(final["loss"])
    with open(tmp_path / "p.csv") as f:
        assert f.readline().strip() == "click_probabilities"


def test_cli_criteo_needs_synthetic(tmp_path):
    from recalgorithm_tpu_torch.cli import main as tmain

    with pytest.raises(SystemExit):
        tmain.main(["--model", "DLRM", "--dataset", "criteo", "--train_data", "a",
                    "--eval_data", "b", "--vocabulary_dir", "c", "--device", "cpu",
                    "--model_dir", str(tmp_path)])


def test_synthetic_criteo_bags_are_full():
    from recalgorithm_tpu_torch.data.synthetic import SyntheticConfig, SyntheticWeChat

    gen = SyntheticWeChat(S.criteo_schema(), SyntheticConfig(vocab_scale=1e-4,
                                                             full_sequences=True))
    batch = gen.batch(16, 0)
    for f in S.criteo_schema().sequence:
        assert (batch[f.name + "_len"] == f.max_length).all() and (batch[f.name] > 0).all()
    assert batch["labels"].shape == (16, 1)


def test_small_config_is_a_copy_of_the_file():
    """SMALL keeps the file's keys (the reference reads only these)."""
    with open(CONFIG) as f:
        cfg = json.load(f)
    small = copy.deepcopy(SMALL)
    assert set(small) <= set(cfg)
    assert cfg["optimizer"] == small["optimizer"]
    assert cfg["dcn_num_layers"] == small["dcn_num_layers"]
