"""Port parity for the multi-task family on ``ops/experts.py``: MMOE, PLE (one
and two extraction networks), ESMM and SharedBottom against the JAX models on
the same seeded batch with the JAX weights carried across (eval and
train-mode logits, BN statistics, every gradient, the gates' summaries);
the ``convert`` round trips (the JAX init loads only if each 3-D expert
kernel keeps its (E, in, H) layout);
every parameter reached by a train step's loss; ESMM's derived ``ctcvr``
label through the port's Trainer against the JAX Trainer; the training CLI
on the CPU.  Tolerances as tests/torch_zoo_common.py states them.  Dropout
is 0 in the parity runs, so neither side draws."""

import csv

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recalgorithm_tpu.features.schema import wechat_schema
from recalgorithm_tpu.train import optimizers as joptimizers
from recalgorithm_tpu.train.loop import Trainer as JaxTrainer, TrainerConfig as JaxTrainerConfig
from recalgorithm_tpu_torch import convert
from recalgorithm_tpu_torch.cli import main as tmain
from recalgorithm_tpu_torch.features.schema import wechat_schema as t_wechat_schema
from recalgorithm_tpu_torch.models import get_model
from recalgorithm_tpu_torch.train import optimizers
from recalgorithm_tpu_torch.train.loop import Trainer, TrainerConfig
from tests.torch_zoo_common import (
    TOL,
    build_pair,
    check_cli_raises_without_a_gpu,
    check_every_parameter_gets_a_gradient,
    check_matches_jax,
    check_round_trips,
    cli_args,
    jax_variables,
    wechat_batch,
)

TOWER = dict(hidden_units=(16, 8), dropout_rate=0.0)
PLE_KW = dict(num_experts_per_task=(2, 3, 2), num_experts_in_shared=3,
              expert_hidden_units=12, **TOWER)
# case -> (registered name, config overrides for both packages).  PLE-2's
# towers have no BN: behind two extraction networks, a train-mode BN over the
# 24 rows scales the f32 rounding up to 6.3e-5 between JAX's forward and an
# f64 one (the port's: 6.6e-6), beyond TOL; without it both are within 2e-7
# of f64.  PLE keeps the BN, so its statistics are held as well.
CASES = {
    "MMOE": ("MMOE", dict(num_experts=3, expert_hidden_units=12, **TOWER)),
    "PLE": ("PLE", PLE_KW),
    "PLE-2": ("PLE", dict(num_extract_network=2, **{**PLE_KW, "batch_norm": False})),
    "ESMM": ("ESMM", dict(TOWER)),
    "SharedBottom": ("SharedBottom", dict(bottom_hidden_units=(24, 12), **TOWER)),
}
MULTI_TASK = ("MMOE", "PLE", "ESMM", "SharedBottom")
# the CLI runs' expert and bottom widths, cut from the config defaults
# (PLE's 25 experts of 256) to keep the CPU runs short
CLI_FLAGS = {"MMOE": dict(expert_hidden_units=16),
             "PLE": dict(expert_hidden_units=16, num_experts_per_task=(2, 2, 2),
                         num_experts_in_shared=2),
             "ESMM": {}, "SharedBottom": dict(bottom_hidden_units=(16, 8))}


@pytest.fixture(scope="module")
def data():
    return wechat_batch()


def models(case, gen):
    name, kw = CASES[case]
    return build_pair(name, kw, {}, wechat_schema(gen.vocab_sizes()),
                      t_wechat_schema(gen.vocab_sizes()))


@pytest.mark.parametrize("case", sorted(CASES))
def test_model_matches_jax(data, case):
    """Eval logits (running statistics), then train-mode logits, every
    parameter's gradient of the mean logits, and the updated BN statistics,
    for every task."""
    gen, hb = data
    check_matches_jax(*models(case, gen), hb)


@pytest.mark.parametrize("case", sorted(CASES))
def test_convert_round_trips_bit_exact(data, case):
    gen, hb = data
    check_round_trips(*models(case, gen), hb)


@pytest.mark.parametrize("case", sorted(CASES))
def test_every_parameter_gets_a_gradient(data, case):
    """The trainer's loss of a train-mode forward reaches every parameter:
    the optimizers step after ``zero_grad(set_to_none=True)``, so a
    parameter without a gradient would not move where optax moves it."""
    gen, hb = data
    check_every_parameter_gets_a_gradient(models(case, gen)[1], hb)


def test_gate_summaries_match_jax(data):
    """In train mode ``model.sown`` holds each gate's batch-mean weights under
    the JAX summaries' tags: PLE-2's extraction gates, all-experts gates and
    final gates."""
    gen, hb = data
    jmodel, model = models("PLE-2", gen)
    variables = jax_variables(jmodel, hb, seed=1)
    _, upd = jax.jit(lambda v, b: jmodel.apply(v, b, train=True, mutable=[
        "batch_stats", "summaries"]))(variables, {k: jnp.asarray(v) for k, v in hb.items()})
    want = {"/".join(p.key for p in path): np.asarray(v) for path, v
            in jax.tree_util.tree_leaves_with_path(jax.device_get(upd["summaries"]))}
    model.load_state_dict(convert.from_flax(variables))
    model.eval()
    with torch.no_grad():
        model({k: torch.from_numpy(v) for k, v in hb.items()})
    assert model.sown == {}  # an eval forward keeps no summaries
    model.train()
    with torch.no_grad():
        model({k: torch.from_numpy(v) for k, v in hb.items()})
    assert set(model.sown) == set(want) and all(k.endswith("/gate_mean") for k in want)
    for tag, w in want.items():
        np.testing.assert_allclose(model.sown[tag].numpy(), w, **TOL)


def test_esmm_trainer_derives_ctcvr_as_jax(data, tmp_path):
    """ESMM's ``ctcvr`` task has no label column: both trainers take
    read_comment x like from the model.  The eval loss (per-task CE summed)
    and the train step's loss of the port's Trainer against the JAX
    Trainer's, from the same weights."""
    gen, hb = data
    jmodel, model = models("ESMM", gen)
    jt = JaxTrainer(jmodel, ("read_comment", "ctcvr"), joptimizers.build("adam", 1e-3),
                    JaxTrainerConfig(model_dir=str(tmp_path / "jax"), compact_grad_scatter=False))
    state = jt.init_state(hb)

    @jax.jit
    def losses(params, batch_stats, jb):
        return (jt._loss_and_logits(params, batch_stats, jb, False, None)[0],
                jt._loss_and_logits(params, batch_stats, jb, True, jax.random.key(0))[0])

    with jax.default_matmul_precision("highest"):
        jeval, jtrain = losses(state.params, state.batch_stats,
                               {k: jnp.asarray(v) for k, v in hb.items()})
    model.load_state_dict(convert.from_flax(jax.device_get(
        {"params": state.params, "batch_stats": state.batch_stats})))
    tt = Trainer(model, ("read_comment", "ctcvr"), optimizers.build("adam", 1e-3),
                 TrainerConfig(model_dir=str(tmp_path / "torch")), device="cpu")
    batch = tt._put_batch(hb)
    labels = hb["labels"]
    idx = {n: i for i, n in enumerate(model.schema.labels)}
    np.testing.assert_array_equal(tt._task_label(batch, "ctcvr").numpy(),
                                  labels[:, idx["read_comment"]] * labels[:, idx["like"]])
    model.eval()
    with torch.no_grad():
        teval, _ = tt._loss_and_logits(batch)
    np.testing.assert_allclose(float(teval), float(jeval), **TOL)
    np.testing.assert_allclose(float(tt.train_step(hb)), float(jtrain), **TOL)
    with pytest.raises(KeyError):
        model.derived_label("like_and_share", batch)


@pytest.mark.parametrize("name", MULTI_TASK)
def test_cli_trains_on_the_cpu(name, tmp_path):
    """4 steps through cli.main on the CPU: every task's final AUC (ESMM's
    ctcvr included), and predictions.csv with one column a task."""
    final = tmain.main(cli_args(name, CLI_FLAGS[name], tmp_path, 4, "--device", "cpu"))
    tasks = get_model(name)[0]().task_names
    for t in tasks:
        assert 0.0 <= final[f"{t}_auc"] <= 1.0, final
    with open(tmp_path / "predictions.csv") as f:
        rows = list(csv.reader(f))
    assert rows[0] == [f"{t}_probabilities" for t in tasks]
    assert len(rows) == 1 + tmain.EVAL_BATCHES * 16


@pytest.mark.parametrize("name", MULTI_TASK)
def test_cli_raises_without_a_gpu(name, tmp_path):
    check_cli_raises_without_a_gpu(name, {}, tmp_path)
