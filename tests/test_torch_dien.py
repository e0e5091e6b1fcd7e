"""Port parity for DIEN and what it runs on: ``ops/recurrent.GRULoop`` (GRU,
AGRU and AUGRU over rows of length 0, T and in between, outputs, final
state and gradients), ``optimizers.LazyAdam`` against the JAX package's
``lazy_adam`` (sparse gradients, a parameter without one, a resume), and
DIEN (AGRU, AUGRU, the auxiliary loss) against the JAX model with its
weights carried across; the ``convert`` round trips; every parameter
reached by a train step; the Trainer on LazyAdam against the JAX Trainer;
the training CLI on the CPU with DIEN's default optimizer.

Tolerances as tests/torch_zoo_common.py states them (the GRU recurrences
run at JAX's "highest" precision and torch's full f32).  The JAX DIEN with
the auxiliary loss takes its parameters from ``init(train=True)``: its
``aux_project_matrix`` is created in train mode only, so the JAX trainer,
which initialises in eval mode, cannot train it (the port creates it with
the model)."""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from recalgorithm_tpu.data.synthetic import SyntheticConfig, SyntheticWeChat
from recalgorithm_tpu.features.schema import wechat_schema
from recalgorithm_tpu.models.dien import DIEN as JaxDIEN, DIENConfig as JaxDIENConfig
from recalgorithm_tpu.ops.recurrent import GRULoop as JaxGRULoop
from recalgorithm_tpu.train import optimizers as joptimizers
from recalgorithm_tpu.train.loop import Trainer as JaxTrainer, TrainerConfig as JaxTrainerConfig
from recalgorithm_tpu_torch import convert
from recalgorithm_tpu_torch.cli import main as tmain
from recalgorithm_tpu_torch.features.schema import wechat_schema as t_wechat_schema
from recalgorithm_tpu_torch.models.dien import DIEN, DIENConfig
from recalgorithm_tpu_torch.ops.recurrent import GRULoop
from recalgorithm_tpu_torch.train import optimizers
from recalgorithm_tpu_torch.train.loop import Trainer, TrainerConfig
from tests.torch_zoo_common import (
    TOL,
    assert_grad_close,
    build_pair,
    check_cli_raises_without_a_gpu,
    check_every_parameter_gets_a_gradient,
    check_matches_jax,
    check_round_trips,
    cli_args,
    wechat_batch,
)

SMALL = dict(hidden_units=(16, 8), gru_output_units=4, dropout_rate=0.0)
# case -> (config overrides for both packages, whether the JAX init runs in train mode)
CASES = {
    "AGRU": (dict(SMALL), False),
    "AUGRU": (dict(custom_gru_type="AUGRU", activation="prelu", **SMALL), False),
    "aux": (dict(use_auxiliary_loss=True, negative_sample_number=2, **SMALL), True),
}


@pytest.fixture(scope="module")
def data():
    return wechat_batch()


def models(case, gen):
    return build_pair("DIEN", CASES[case][0], {}, wechat_schema(gen.vocab_sizes()),
                      t_wechat_schema(gen.vocab_sizes()))


# ---------------------------------------------------------------------------
# GRULoop
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cell", ["GRU", "AGRU", "AUGRU"])
def test_gru_loop_matches_jax(cell):
    """Outputs and final state, then the gradients of a random projection of
    both w.r.t. every parameter, the inputs and the attention scores; rows of
    length 0, T and in between (zero outputs and a carried state past the
    length)."""
    b, t, i, h = 6, 7, 5, 4
    rng = np.random.default_rng(0)
    x = rng.normal(size=(b, t, i)).astype(np.float32)
    lengths = np.array([0, t, 3, 1, 5, t - 1], np.int32)
    att = rng.uniform(size=(b, t)).astype(np.float32) if cell != "GRU" else None
    g_out = rng.normal(size=(b, t, h)).astype(np.float32)
    g_state = rng.normal(size=(b, h)).astype(np.float32)

    jloop = JaxGRULoop(num_units=h, cell_type=cell)
    jatt = None if att is None else jnp.asarray(att)
    params = jloop.init(jax.random.key(0), jnp.asarray(x), jnp.asarray(lengths), jatt)["params"]
    params = jax.tree.map(lambda p: p + rng.uniform(-0.3, 0.3, p.shape).astype(np.float32),
                          jax.device_get(params))  # biases away from their 1 / 0 init

    def jloss(params, x, att):
        out, state = jloop.apply({"params": params}, x, jnp.asarray(lengths), att)
        return jnp.sum(out * g_out) + jnp.sum(state * g_state), (out, state)

    with jax.default_matmul_precision("highest"):
        argnums = (0, 1) if att is None else (0, 1, 2)
        (_, (jout, jstate)), jgrads = jax.jit(jax.value_and_grad(
            jloss, argnums=argnums, has_aux=True))(params, jnp.asarray(x), jatt)

    loop = GRULoop(i, h, cell)
    loop.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in params.items()})
    tx = torch.from_numpy(x).requires_grad_()
    tatt = None if att is None else torch.from_numpy(att).requires_grad_()
    out, state = loop(tx, torch.from_numpy(lengths), tatt)
    np.testing.assert_allclose(out.detach().numpy(), jout, **TOL)
    np.testing.assert_allclose(state.detach().numpy(), jstate, **TOL)
    assert not out[0].any() and not state[0].any()  # len 0: zeros, state 0
    assert not out[2, 3:].any()                     # past the length: zeros
    ((out * torch.from_numpy(g_out)).sum() + (state * torch.from_numpy(g_state)).sum()).backward()
    for name, p in loop.named_parameters():
        assert_grad_close(p.grad.numpy(), jgrads[0][name])
    assert_grad_close(tx.grad.numpy(), jgrads[1])
    if att is not None:
        assert_grad_close(tatt.grad.numpy(), jgrads[2])


def test_gru_loop_init_and_cell_check():
    loop = GRULoop(3, 4, "GRU", torch.Generator().manual_seed(0))
    assert torch.equal(loop.b_gates, torch.ones(8)) and torch.equal(loop.b_cand, torch.zeros(4))
    assert tuple(loop.w_x_gates.shape) == (3, 8) and tuple(loop.w_h_cand.shape) == (4, 4)
    with pytest.raises(ValueError, match="requires att_scores"):
        GRULoop(3, 4, "AGRU")(torch.zeros(2, 5, 3), torch.ones(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="unknown cell_type"):
        GRULoop(3, 4, "LSTM")


# ---------------------------------------------------------------------------
# LazyAdam
# ---------------------------------------------------------------------------


def test_lazy_adam_matches_jax(tmp_path):
    """3 steps of the JAX package's ``lazy_adam`` against the port's on a
    table whose gradient touches a few rows a step (as an embedding
    gradient does) and a vector with no gradient in step 2 (None here, zeros
    there): the parameters and moments after each step, untouched
    coordinates bitwise unchanged; then a resume from the state dict after
    step 2 gives step 3 again."""
    rng = np.random.default_rng(0)
    w0 = {"table": rng.normal(size=(8, 3)).astype(np.float32),
          "vec": rng.normal(size=(4,)).astype(np.float32)}
    grads = []
    for step, rows in enumerate(([1, 4], [4, 6, 7], [0, 1])):
        g_tab = np.zeros((8, 3), np.float32)
        g_tab[rows] = rng.normal(size=(len(rows), 3))
        g_tab[rows[0], 1] = 0.0  # a zero inside a touched row
        g_vec = None if step == 1 else rng.normal(size=(4,)).astype(np.float32)
        grads.append({"table": g_tab, "vec": g_vec})
    sched = optimizers.make_schedule(0.05, "cosine", 1, 3)
    tx = joptimizers.build("lazyadam", joptimizers.make_schedule(0.05, "cosine", 1, 3))
    params = {k: jnp.asarray(v) for k, v in w0.items()}
    state = tx.init(params)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in w0.items()}
    opt = optimizers.build("lazyadam", sched)(list(tparams.values()))
    saved = None
    for step, g in enumerate(grads):
        jg = {k: jnp.asarray(v if v is not None else np.zeros_like(w0[k])) for k, v in g.items()}
        upd, state = tx.update(jg, state, params)
        params = optax.apply_updates(params, upd)
        if step == 2:
            opt = optimizers.build("lazyadam", sched)(list(tparams.values()))
            opt.load_state_dict(saved)
        before = {k: p.detach().clone() for k, p in tparams.items()}
        opt.zero_grad()
        for k, p in tparams.items():
            p.grad = None if g[k] is None else torch.from_numpy(g[k])
        opt.step()
        for k, p in tparams.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(params[k]), **TOL)
            untouched = torch.ones_like(p, dtype=torch.bool) if g[k] is None else \
                torch.from_numpy(g[k] == 0)
            assert torch.equal(p.detach()[untouched], before[k][untouched])
        mu = {k: np.asarray(v) for k, v in state.mu.items()}
        for k, p in tparams.items():
            np.testing.assert_allclose(opt.opt.state[p]["mu"].numpy(), mu[k], **TOL)
        assert opt.opt.param_groups[0]["count"] == int(state.count) == step + 1
        if step == 1:
            saved = torch.load(_save(tmp_path, opt.state_dict()), weights_only=True)


def _save(tmp_path, state_dict):
    path = tmp_path / "opt.pt"
    torch.save(state_dict, path)
    return path


# ---------------------------------------------------------------------------
# DIEN
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", sorted(CASES))
def test_model_matches_jax(data, case):
    """Eval logits, train-mode logits, the auxiliary loss, every gradient and
    the BN statistics."""
    gen, hb = data
    check_matches_jax(*models(case, gen), hb, init_train=CASES[case][1])


@pytest.mark.parametrize("case", sorted(CASES))
def test_convert_round_trips_bit_exact(data, case):
    gen, hb = data
    check_round_trips(*models(case, gen), hb, init_train=CASES[case][1])


@pytest.mark.parametrize("case", sorted(CASES))
def test_every_parameter_gets_a_gradient(data, case):
    """The trainer's loss of a train-mode forward reaches every parameter
    (the optimizers skip a parameter without one); the auxiliary projection
    exists only with its loss."""
    gen, hb = data
    _, model = models(case, gen)
    assert hasattr(model, "aux_project_matrix") == model.config.use_auxiliary_loss
    check_every_parameter_gets_a_gradient(model, hb, "lazyadam")


def test_jax_dien_with_aux_loss_cannot_init_in_eval_mode(data):
    """The reference fault the port does not copy: initialised in eval mode
    (as the JAX Trainer initialises), the JAX DIEN has no
    ``aux_project_matrix``, and its train-mode forward fails."""
    gen, hb = data
    jmodel, model = models("aux", gen)
    jb = {k: jnp.asarray(v) for k, v in hb.items()}
    variables = jax.eval_shape(lambda b: jmodel.init(jax.random.key(0), b, train=False), jb)
    assert "aux_project_matrix" not in variables["params"]
    with pytest.raises(flax.errors.ScopeParamNotFoundError):
        jax.eval_shape(lambda v, b: jmodel.apply(v, b, train=True,
                                                 mutable=["batch_stats", "losses"]),
                       variables, jb)
    assert "aux_project_matrix" in dict(model.named_parameters())


def test_trainer_with_lazyadam_tracks_jax_trainer(tmp_path):
    """The JAX Trainer's init carried across, then 4 train steps on LazyAdam
    with the same batches: the losses, then the eval metrics.  No tower BN:
    Dice starts as the identity, so a tower bias in front of a train-mode BN
    gets a rounding-noise gradient (tests/test_torch_train.py's DIN case)."""
    gen = SyntheticWeChat(wechat_schema(), SyntheticConfig(seed=3, vocab_scale=0.005))
    kw = dict(batch_size=32, batch_norm=False, **SMALL)
    jmodel = JaxDIEN(config=JaxDIENConfig(**kw), schema=wechat_schema(gen.vocab_sizes()))
    jt = JaxTrainer(jmodel, ("read_comment",), joptimizers.build("lazyadam", 0.01),
                    JaxTrainerConfig(model_dir=str(tmp_path / "jax"), seed=0,
                                     compact_grad_scatter=False))
    batches = list(gen.batches(32, 4))
    eval_batches = list(gen.batches(32, 2, start_seed=5000))
    with jax.default_matmul_precision("highest"):
        state = jt.init_state(batches[0])
        init = jax.device_get({"params": state.params, "batch_stats": state.batch_stats})
        jt._compile()
        jlosses = []
        for hb in batches:
            state, loss = jt._train_jit(state, jt._put_batch(hb), jax.random.key(1))
            jlosses.append(float(loss))
        jev = jt.evaluate(state, eval_batches)
    model = DIEN(DIENConfig(**kw), t_wechat_schema(gen.vocab_sizes()))
    model.load_state_dict(convert.from_flax(init))
    tt = Trainer(model, ("read_comment",), optimizers.build(model.config.optimizer, 0.01),
                 TrainerConfig(model_dir=str(tmp_path / "torch")), device="cpu")
    assert isinstance(tt.optimizer.opt, optimizers.LazyAdam)
    tlosses = [float(tt.train_step(hb)) for hb in batches]
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-4)
    tev = tt.evaluate(eval_batches)
    np.testing.assert_allclose(tev["loss"], jev["loss"], rtol=1e-4)
    np.testing.assert_allclose(tev["read_comment_auc"], jev["read_comment_auc"], atol=2e-3)


def test_cli_trains_with_lazyadam_on_the_cpu(tmp_path):
    """cli.main --model DIEN at its config's optimizer (lazyadam): 4 steps,
    the final eval, and a checkpoint holding LazyAdam's count."""
    final = tmain.main(cli_args("DIEN", {}, tmp_path, 4, "--device", "cpu"))
    assert 0.0 <= final["read_comment_auc"] <= 1.0 and np.isfinite(final["loss"])
    ck = torch.load(tmp_path / "checkpoints" / "ckpt_4.pt", weights_only=True)
    assert ck["optimizer"]["count"] == 4
    assert ck["optimizer"]["opt"]["param_groups"][0]["count"] == 4


def test_cli_raises_without_a_gpu(tmp_path):
    check_cli_raises_without_a_gpu("DIEN", {}, tmp_path)
