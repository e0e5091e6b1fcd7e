"""Port parity for training: the metrics and Adam against the JAX package,
the port's Trainer against the JAX Trainer on the same init and batches (BST
and DIN), checkpoint/resume, DIN gradients against the JAX fused-interpret
path, and the training CLI on the CPU.

Tolerances: metrics on the same inputs 1e-6 (f32 counts and sums); Adam
steps 1e-5 (the same update, its f32 operations in another order: torch
folds the bias corrections into the step size and the denominator); trainer
losses rtol 1e-4 over 8 steps and eval loss/logloss/calibration 1e-4 (f32
on both sides, JAX matmuls at "highest" precision; differences compound
through the updates), eval AUC and accuracy within a count (see the test);
gradients rtol 1e-4 and atol 1e-5 * max|g|."""

import csv
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from recalgorithm_tpu.data.synthetic import SyntheticConfig, SyntheticWeChat
from recalgorithm_tpu.features.schema import wechat_schema
from recalgorithm_tpu.models.bst import BST as JaxBST, BSTConfig as JaxBSTConfig
from recalgorithm_tpu.models.din import DIN as JaxDIN, DINConfig as JaxDINConfig
from recalgorithm_tpu.train import metrics as JM
from recalgorithm_tpu.train import optimizers as joptimizers
from recalgorithm_tpu.train.loop import Trainer as JaxTrainer, TrainerConfig as JaxTrainerConfig
from recalgorithm_tpu_torch import convert
from recalgorithm_tpu_torch.cli import main as tmain
from recalgorithm_tpu_torch.features.schema import wechat_schema as t_wechat_schema
from recalgorithm_tpu_torch.models.bst import BST, BSTConfig
from recalgorithm_tpu_torch.models.din import DIN, DINConfig
from recalgorithm_tpu_torch.serving.predictor import Predictor
from recalgorithm_tpu_torch.train import loop as tloop
from recalgorithm_tpu_torch.train import metrics as TM
from recalgorithm_tpu_torch.train import optimizers as toptimizers
from recalgorithm_tpu_torch.train.loop import Trainer, TrainerConfig

SCALE = 0.005
B = 32
STEPS = 8
LR = 0.01


def assert_grad_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * scale)


# ---------------------------------------------------------------------------
# metrics and optimizers
# ---------------------------------------------------------------------------


def _scores(n, seed):
    rng = np.random.default_rng(seed)
    labels = (rng.random(n) < 0.3).astype(np.float32)
    scores = np.clip(rng.random(n) * 0.6 + 0.4 * labels, 0, 1).astype(np.float32)
    scores[:4] = (0.0, 1.0, 0.5, 0.5)  # the edge thresholds and a tie
    weights = (rng.random(n) < 0.8).astype(np.float32)
    return labels, scores, weights


@pytest.mark.parametrize("weighted", [False, True])
def test_binned_auc_matches_jax(weighted):
    jstate, tstate = JM.AUCState.init(), TM.AUCState.init()
    for seed in range(3):
        y, p, w = _scores(500, seed)
        jstate = JM.auc_update(jstate, jnp.asarray(y), jnp.asarray(p),
                               jnp.asarray(w) if weighted else None)
        tstate = TM.auc_update(tstate, torch.from_numpy(y), torch.from_numpy(p),
                               torch.from_numpy(w) if weighted else None)
    for f in ("tp", "fp", "tn", "fn"):
        np.testing.assert_array_equal(getattr(tstate, f).numpy(),
                                      np.asarray(getattr(jstate, f)))
    np.testing.assert_allclose(float(TM.auc_compute(tstate)),
                               float(JM.auc_compute(jstate)), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(TM._thresholds(), JM._thresholds())


def test_exact_and_grouped_auc_match_jax():
    y, p, _ = _scores(400, 7)
    p = np.round(p, 2)  # many ties
    groups = np.random.default_rng(1).integers(0, 12, len(y))
    assert TM.exact_auc(y, p) == pytest.approx(JM.exact_auc(y, p), abs=1e-12)
    assert TM.grouped_auc(y, p, groups) == pytest.approx(JM.grouped_auc(y, p, groups),
                                                        abs=1e-12)
    assert np.isnan(TM.exact_auc(np.ones(4), p[:4]))


def test_scalar_mean_matches_jax():
    v, w = np.arange(6, dtype=np.float32), np.array([1, 0, 1, 1, 0, 1], np.float32)
    js = JM.mean_update(JM.ScalarMeanState.init(), jnp.asarray(v), jnp.asarray(w))
    ts = TM.mean_update(TM.ScalarMeanState.init(), torch.from_numpy(v), torch.from_numpy(w))
    assert float(TM.mean_compute(ts)) == pytest.approx(float(JM.mean_compute(js)))


@pytest.mark.parametrize("schedule,warmup,decay", [
    ("constant", 0, 0), ("constant", 3, 0), ("cosine", 2, 5), ("exponential", 0, 4)])
def test_adam_steps_match_optax(schedule, warmup, decay):
    rng = np.random.default_rng(0)
    w0 = rng.normal(size=(5, 3)).astype(np.float32)
    grads = [rng.normal(size=(5, 3)).astype(np.float32) for _ in range(8)]
    jlr = joptimizers.make_schedule(0.05, schedule, warmup, decay)
    tx = joptimizers.build("adam", jlr)
    params = jnp.asarray(w0)
    state = tx.init(params)
    tlr = toptimizers.make_schedule(0.05, schedule, warmup, decay)
    p = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    opt = toptimizers.build("adam", tlr)([p])
    for i, g in enumerate(grads):
        upd, state = tx.update(jnp.asarray(g), state, params)
        params = optax.apply_updates(params, upd)
        opt.zero_grad()
        p.grad = torch.from_numpy(g)
        opt.step()
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(params),
                                   rtol=1e-5, atol=1e-5)
        want_lr = jlr(i) if callable(jlr) else jlr
        assert tlr(i) == pytest.approx(float(want_lr), rel=1e-6, abs=1e-9)


def test_dropout_is_flax_dropout_on_its_generator():
    from recalgorithm_tpu_torch.ops.activations import Dropout

    drop = Dropout(0.25)
    x = torch.ones(200, 50)
    drop.eval()
    assert drop(x) is x
    drop.train()
    drop.generator = torch.Generator().manual_seed(0)
    a = drop(x)
    assert set(torch.unique(a).tolist()) == {0.0, float(torch.tensor(1.0) / 0.75)}
    assert abs(float((a > 0).float().mean()) - 0.75) < 0.01
    drop.generator = torch.Generator().manual_seed(0)
    assert torch.equal(drop(x), a)  # the generator alone decides the mask


def test_other_optimizers_not_ported_yet():
    with pytest.raises(NotImplementedError, match="adam only"):
        toptimizers.build("ftrl", 0.1)


# ---------------------------------------------------------------------------
# the Trainer against the JAX Trainer
# ---------------------------------------------------------------------------

# The reference towers give some biases a gradient that is zero but for
# rounding: BST's (mlp_activation "none": dense -> BN, no activation) every
# bias in front of a train-mode BN, and DIN's too, because Dice and PReLU
# start as the identity (alpha = 1).  Adam scales that noise up to steps of
# about lr, so both frameworks walk those biases at random, and the eval
# metrics, which read the running statistics, follow the walk.  The parity
# runs take towers where every gradient is real: BST with the relu tower,
# DIN without the tower's BN (Dice keeps its own BN and running statistics).
MODELS = {
    "BST": (JaxBST, JaxBSTConfig, BST, BSTConfig,
            dict(hidden_units=(64, 32), dropout_rate=0.0, mlp_activation="relu")),
    "DIN": (JaxDIN, JaxDINConfig, DIN, DINConfig,
            dict(hidden_units=(64, 32), dropout_rate=0.0, batch_norm=False)),
}


@pytest.fixture(scope="module")
def gen():
    return SyntheticWeChat(wechat_schema(), SyntheticConfig(seed=3, vocab_scale=SCALE))


def _pair(name, gen, tmp_path, model_kw=None):
    jcls, jcfg_cls, tcls, tcfg_cls, kw = MODELS[name]
    kw = {**kw, **(model_kw or {})}
    jmodel = jcls(config=jcfg_cls(batch_size=B, **kw), schema=wechat_schema(gen.vocab_sizes()))
    jt = JaxTrainer(jmodel, ("read_comment",), optax.adam(LR, b1=0.9, b2=0.999, eps=1e-8),
                    JaxTrainerConfig(model_dir=str(tmp_path / "jax"), seed=0,
                                     compact_grad_scatter=False))
    model = tcls(tcfg_cls(batch_size=B, **kw), t_wechat_schema(gen.vocab_sizes()))
    tt = Trainer(model, ("read_comment",), toptimizers.build("adam", LR),
                 TrainerConfig(model_dir=str(tmp_path / "torch")), device="cpu")
    return jt, tt


@pytest.mark.parametrize("name", sorted(MODELS))
def test_trainer_tracks_jax_trainer(name, gen, tmp_path):
    """Same init (the JAX model's, carried across) and the same batches:
    8 train steps' losses, then the eval metrics."""
    batches = list(gen.batches(B, STEPS))
    eval_batches = list(gen.batches(B, 4, start_seed=5000))
    jt, tt = _pair(name, gen, tmp_path)
    with jax.default_matmul_precision("highest"):
        state = jt.init_state(batches[0])
        tt.model.load_state_dict(convert.from_flax(
            {"params": jax.device_get(state.params),
             "batch_stats": jax.device_get(state.batch_stats)}))
        jt._compile()
        rng = jax.random.key(1)
        jlosses = []
        for hb in batches:
            state, loss = jt._train_jit(state, jt._put_batch(hb), rng)
            jlosses.append(float(loss))
        jev = jt.evaluate(state, eval_batches)
    tlosses = [float(tt.train_step(hb)) for hb in batches]
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-4)
    assert tt.step == STEPS
    tev = tt.evaluate(eval_batches)
    assert set(tev) == set(jev)
    # AUC and accuracy count examples on either side of thresholds (200 AUC
    # bins, 0.5): a prediction that rounding moves across one shifts them by
    # a count, about 3.5e-4 for one AUC bin here and 1/128 for accuracy
    n_eval = sum(len(hb["labels"]) for hb in eval_batches)
    atol = {"read_comment_auc": 1e-3, "read_comment_accuracy": 1.0 / n_eval + 1e-7}
    for k in jev:
        np.testing.assert_allclose(tev[k], jev[k], rtol=1e-4, atol=atol.get(k, 1e-4),
                                   err_msg=k)
    # the running BN statistics follow flax's biased update
    got = convert.to_flax(tt.model)["batch_stats"]
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4,
                                                         atol=1e-5),
                 got, jax.device_get(state.batch_stats))


def test_din_gradients_match_jax_fused_interpret(gen):
    """DIN parameter gradients (train mode, dropout 0) against jax.grad of
    the fused-interpret path, whose backward is the recompute the port's
    autograd Function also takes."""
    hb = gen.batch(B, 11)
    jmodel = JaxDIN(config=JaxDINConfig(hidden_units=(32, 16), dropout_rate=0.0,
                                        use_fused_attention="true", attn_interpret=True),
                    schema=wechat_schema(gen.vocab_sizes()))
    jb = {k: jnp.asarray(v) for k, v in hb.items()}
    variables = jmodel.init(jax.random.key(0), jb, train=False)
    with jax.default_matmul_precision("highest"):
        def loss(params):
            out, upd = jmodel.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                    jb, train=True, mutable=["batch_stats", "losses"])
            return jnp.mean(out["read_comment"]) + upd["losses"]["mba_l2"][0]

        jgrads = jax.grad(loss)(variables["params"])
    model = DIN(DINConfig(hidden_units=(32, 16), dropout_rate=0.0),
                t_wechat_schema(gen.vocab_sizes()))
    model.load_state_dict(convert.from_flax(jax.device_get(variables)))
    model.train()
    logits, losses = model({k: torch.from_numpy(v) for k, v in hb.items()})
    (logits["read_comment"].mean() + losses["mba_l2"]).backward()
    grads = {k: p.grad for k, p in model.named_parameters()}
    flat = jax.tree_util.tree_leaves_with_path(jax.device_get(jgrads))
    seen = set()
    for path, g in flat:
        keys = [p.key for p in path]
        tree = {}
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = np.asarray(g)
        (tname, want), = convert.from_flax({"params": tree}).items()
        assert_grad_close(grads[tname].numpy(), want.numpy())
        seen.add(tname)
    assert seen == set(grads)


def test_resume_equals_straight_run(gen, tmp_path):
    """6 steps, then a new trainer resumed from the checkpoint to 10, give the
    same weights, optimizer state and BN statistics as 10 straight; dropout
    on, so the dropout generator's state is part of what is restored."""
    batches = list(gen.batches(B, 10))

    def run(model_dir, steps, feed, init_seed):
        model = BST(BSTConfig(hidden_units=(16, 8), dropout_rate=0.1),
                    t_wechat_schema(gen.vocab_sizes()),
                    torch.Generator().manual_seed(init_seed))
        tt = Trainer(model, ("read_comment",), toptimizers.build("adam", LR),
                     TrainerConfig(model_dir=str(model_dir), train_steps=steps,
                                   log_every=1000, save_checkpoints_steps=0, seed=5),
                     device="cpu")
        tt.train_and_evaluate(feed)
        return tt

    straight = run(tmp_path / "a", 10, batches, init_seed=0)
    run(tmp_path / "b", 6, batches[:6], init_seed=0)
    resumed = run(tmp_path / "b", 10, batches[6:], init_seed=99)  # init overwritten
    assert resumed.step == straight.step == 10
    for (k, a), (_, b) in zip(straight.model.state_dict().items(),
                              resumed.model.state_dict().items()):
        assert torch.equal(a, b), k
    sa, sb = straight.optimizer.state_dict(), resumed.optimizer.state_dict()
    assert sa["count"] == sb["count"] == 10
    for pid, st in sa["opt"]["state"].items():
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(st[key], sb["opt"]["state"][pid][key])
    ckpts = sorted(os.listdir(tmp_path / "b" / "checkpoints"))
    assert ckpts == ["ckpt_10.pt", "ckpt_6.pt"]


def test_checkpoints_and_best_exports_are_trimmed(gen, tmp_path, monkeypatch):
    monkeypatch.setattr(tloop, "BEST_EXPORTS_KEPT", 2)
    model = BST(BSTConfig(hidden_units=(16, 8), dropout_rate=0.0),
                t_wechat_schema(gen.vocab_sizes()), torch.Generator().manual_seed(0))
    tt = Trainer(model, ("read_comment",), toptimizers.build("adam", LR),
                 TrainerConfig(model_dir=str(tmp_path), train_steps=12, log_every=4,
                               eval_every_steps=2, save_checkpoints_steps=2),
                 device="cpu")
    lines = []
    final = tt.train_and_evaluate(gen.batches(B, 12), lambda: gen.batches(B, 2, 5000),
                                  log_fn=lines.append)
    assert sorted(os.listdir(tmp_path / "checkpoints")) == [
        "ckpt_10.pt", "ckpt_12.pt", "ckpt_8.pt"]
    best = convert.read_best(str(tmp_path))
    assert len(best) == 2 and best == sorted(best, reverse=True)
    assert sorted(os.listdir(tmp_path / "export")) == sorted(f"best_{s}" for _, s in best)
    assert set(final) == {"loss", "read_comment_auc", "read_comment_accuracy",
                          "read_comment_logloss", "read_comment_calibration"}
    assert sum(line.startswith("eval @") for line in lines) == 6
    assert os.path.exists(tmp_path / "summaries" / "scalars.jsonl")


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def _cli_args(model_dir, steps, *extra):
    return ["--model", "BST", "--synthetic", "--synthetic_vocab_scale", str(SCALE),
            "--batch_size", "16", "--train_steps", str(steps), "--hidden_units", "16,8",
            "--log_every", "2", "--eval_every_steps", "2", "--model_dir", str(model_dir),
            "--predictions_csv", str(model_dir / "predictions.csv"), *extra]


def test_cli_trains_resumes_and_exports(tmp_path):
    final = tmain.main(_cli_args(tmp_path, 4, "--device", "cpu"))
    assert 0.0 <= final["read_comment_auc"] <= 1.0
    with open(tmp_path / "predictions.csv") as f:
        rows = list(csv.reader(f))
    # the JAX CLI's synthetic layout: one probability column per task, the
    # 16 eval batches' rows
    assert rows[0] == ["read_comment_probabilities"]
    assert len(rows) == 1 + tmain.EVAL_BATCHES * 16
    probs = np.array([float(r[0]) for r in rows[1:]])
    assert ((probs > 0) & (probs < 1)).all()
    tmain.main(_cli_args(tmp_path, 6, "--device", "cpu"))  # resumes at step 4
    assert sorted(os.listdir(tmp_path / "checkpoints")) == ["ckpt_4.pt", "ckpt_6.pt"]
    gen = SyntheticWeChat(wechat_schema(), SyntheticConfig(seed=42, vocab_scale=SCALE))
    pred = Predictor(BST(BSTConfig(hidden_units=(16, 8)), t_wechat_schema(gen.vocab_sizes())),
                     Predictor.latest_best(str(tmp_path)), device="cpu")
    out = pred.predict_batch(gen.batch(8, 1))["read_comment"]
    assert out.shape == (8,) and np.isfinite(out).all()


def test_cli_needs_synthetic(tmp_path):
    with pytest.raises(NotImplementedError, match="TFRecord pipeline is not ported yet"):
        tmain.main(["--model", "BST", "--model_dir", str(tmp_path), "--device", "cpu"])


def test_cli_raises_without_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this box has a GPU: cuda is a valid default here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmain.main(_cli_args(tmp_path, 2))
