"""Port parity for training from TFRecords: ``Trainer.evaluate`` and
``predict(collect=...)`` on padded eval batches against the JAX Trainer
(parameters carried across by convert.py); ``grad_accum_steps`` against the
JAX Trainer's ``optax.MultiSteps``, and a resume in the middle of an
accumulation window; the training CLI on the port's ETL output (BST on the
WeChat split, GenericDNN and DeepFM on the Douban split) against the JAX
CLI's predictions.csv on the same files; a resumed real-data run that sees
the batches of a straight run.

Tolerances as tests/test_torch_train.py states them: losses and eval metrics
rtol 1e-4 (AUC and accuracy within a count), probabilities rtol 1e-4 and
atol 1e-6 (f32 on both sides, JAX matmuls at "highest" precision);
parameters after the accumulated steps rtol 1e-4, atol 1e-6."""

import csv

import jax
import numpy as np
import optax
import pytest
import torch

from recalgorithm_tpu.cli.main import main as jax_cli
from recalgorithm_tpu.features.schema import wechat_schema as jwechat_schema
from recalgorithm_tpu.models.bst import BST as JaxBST, BSTConfig as JaxBSTConfig
from recalgorithm_tpu.train import optimizers as joptimizers
from recalgorithm_tpu.train.loop import Trainer as JaxTrainer, TrainerConfig as JaxTrainerConfig
from recalgorithm_tpu_torch import convert
from recalgorithm_tpu_torch.cli import main as tmain
from recalgorithm_tpu_torch.data import pipeline
from recalgorithm_tpu_torch.data.douban import DoubanETL
from recalgorithm_tpu_torch.data.etl import WeChatETL
from recalgorithm_tpu_torch.features.schema import wechat_schema
from recalgorithm_tpu_torch.features.vocab import VocabularyStore
from recalgorithm_tpu_torch.models.bst import BST, BSTConfig
from recalgorithm_tpu_torch.train import loop as tloop
from recalgorithm_tpu_torch.train import optimizers as toptimizers
from recalgorithm_tpu_torch.train.loop import Trainer, TrainerConfig
from tests.torch_data_common import ensure_jax_native, write_raw_douban, write_raw_wechat

LR = 0.01
# BST with the relu tower and no dropout: every gradient is real (see
# tests/test_torch_train.py's MODELS)
BST_KW = dict(hidden_units=(16, 8), dropout_rate=0.0, mlp_activation="relu")


@pytest.fixture(scope="module")
def wechat(tmp_path_factory):
    """The port's ETL output of tests/test_etl.py's raw CSVs: (tfrecord dir,
    vocabulary dir)."""
    ensure_jax_native()
    root = write_raw_wechat(tmp_path_factory.mktemp("wechat"))
    WeChatETL(str(root) + "/", str(root) + "/").run()
    return root / "tfrecord", root / "vocabulary"


@pytest.fixture(scope="module")
def douban(tmp_path_factory):
    ensure_jax_native()
    root = write_raw_douban(tmp_path_factory.mktemp("douban"))
    DoubanETL(str(root) + "/", str(root) + "/").run()
    return root / "tfrecord", root / "vocabulary"


def _split(wechat, name):
    vocabs = VocabularyStore.from_dir(str(wechat[1]))
    schema = wechat_schema(vocabs.sizes())
    return pipeline.load_dataset(str(wechat[0] / name), schema, vocabs), schema


def _pair(schema, tmp_path, grad_accum_steps=1, eps=1e-8, warmup_steps=0, **model_kw):
    """The JAX and the port's Trainer of one BST, Adam with ``eps`` at LR
    after a linear warmup of ``warmup_steps`` optimizer applications."""
    kw = {**BST_KW, **model_kw}
    jmodel = JaxBST(config=JaxBSTConfig(batch_size=8, **kw),
                    schema=jwechat_schema(dict(schema.vocab_sizes)))
    jt = JaxTrainer(jmodel, ("read_comment",),
                    optax.adam(joptimizers.make_schedule(LR, warmup_steps=warmup_steps),
                               b1=0.9, b2=0.999, eps=eps),
                    JaxTrainerConfig(model_dir=str(tmp_path / "jax"), seed=0,
                                     compact_grad_scatter=False,
                                     grad_accum_steps=grad_accum_steps))
    adam = lambda params: toptimizers.Optimizer(
        torch.optim.Adam(params, lr=0.0, betas=(0.9, 0.999), eps=eps),
        toptimizers.make_schedule(LR, warmup_steps=warmup_steps))
    tt = Trainer(BST(BSTConfig(batch_size=8, **kw), schema), ("read_comment",), adam,
                 TrainerConfig(model_dir=str(tmp_path / "torch"),
                               grad_accum_steps=grad_accum_steps), device="cpu")
    return jt, tt


def _init_from_jax(jt, tt, batch):
    state = jt.init_state(batch)
    tt.model.load_state_dict(convert.from_flax(
        {"params": jax.device_get(state.params),
         "batch_stats": jax.device_get(state.batch_stats)}))
    jt._compile()
    return state


def test_evaluate_and_predict_on_padded_eval_batches(wechat, tmp_path):
    """Eval batches of 8 over the 30-row test split (the last one padded,
    every batch with ``_index``), on the port's parameters and BN statistics
    after 4 train steps, carried across: the eval metrics, the probabilities
    and the collected columns equal the JAX Trainer's."""
    train, schema = _split(wechat, "train.tfrecord")
    test, _ = _split(wechat, "test.tfrecord")
    batches = list(pipeline.batches(train, 8, seed=1, drop_remainder=True, max_steps=4))
    eval_batches = list(pipeline.eval_batches(test, 8))
    assert eval_batches[-1]["_weights"].sum() < 8
    jt, tt = _pair(schema, tmp_path)
    for hb in batches:
        tt.train_step(hb)
    trained = convert.to_flax(tt.model)
    with jax.default_matmul_precision("highest"):
        state = jt.init_state(batches[0]).replace(params=trained["params"],
                                                  batch_stats=trained["batch_stats"])
        jev = jt.evaluate(state, eval_batches)
        jprobs, jcol = jt.predict(state, eval_batches, collect=("labels", "_index", "userid"))
    tev = tt.evaluate(eval_batches)
    n_eval = test.num_examples
    atol = {"read_comment_auc": 1e-3, "read_comment_accuracy": 1.0 / n_eval + 1e-7}
    assert set(tev) == set(jev)
    for k in jev:
        np.testing.assert_allclose(tev[k], jev[k], rtol=1e-4, atol=atol.get(k, 1e-4), err_msg=k)
    probs, col = tt.predict(eval_batches, collect=("labels", "_index", "userid"))
    assert probs["read_comment"].shape == (n_eval,)
    np.testing.assert_allclose(probs["read_comment"], np.asarray(jprobs["read_comment"]),
                               rtol=1e-4, atol=1e-6)
    for k in jcol:
        np.testing.assert_array_equal(col[k], np.asarray(jcol[k]), err_msg=k)
    np.testing.assert_array_equal(col["_index"], np.arange(n_eval))
    assert tt.predict(eval_batches).keys() == {"read_comment"}


def test_grad_accumulation_matches_multisteps(wechat, tmp_path):
    """k=2 over 4 micro-batches: the losses, the parameters and the optimizer
    count (2 applications, so a warmup of 3 gives rates 0 and LR/3) equal
    JAX's MultiSteps; ``step`` counts micro-batches.  Adam's eps is 1e-3,
    and the tower runs without BN: with eps 1e-8 Adam's first step is about
    lr·sign(g), which flips with the f32 summation order of a gradient near
    0, and the biases in front of a BN get such a gradient (a relu unit
    open for all 8 rows).  A micro-batch that applies nothing still updates
    the BN statistics."""
    train, schema = _split(wechat, "train.tfrecord")
    batches = list(pipeline.batches(train, 8, seed=2, drop_remainder=True, max_steps=4))
    jt, tt = _pair(schema, tmp_path, grad_accum_steps=2, eps=1e-3, warmup_steps=3,
                   batch_norm=False)
    with jax.default_matmul_precision("highest"):
        state = _init_from_jax(jt, tt, batches[0])
        jlosses = []
        for hb in batches:
            state, loss = jt._train_jit(state, jt._put_batch(hb), jax.random.key(1))
            jlosses.append(float(loss))
    tlosses = [float(tt.train_step(hb)) for hb in batches]
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-4)
    assert tt.step == 4 and tt.mini_step == 0
    assert tt.optimizer.count == int(state.opt_state.gradient_step) == 2
    assert int(state.opt_state.inner_opt_state[0].count) == 2
    got = convert.to_flax(tt.model)["params"]
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-6),
                 got, jax.device_get(state.params))
    # the first micro-batch of a window leaves the parameters where they are
    # and moves the BN running statistics
    _, tt = _pair(schema, tmp_path, grad_accum_steps=2)
    before = {k: v.clone() for k, v in tt.model.state_dict().items()}
    tt.train_step(batches[0])
    assert tt.mini_step == 1 and tt.optimizer.count == 0
    moved = {k for k, v in tt.model.state_dict().items() if not torch.equal(v, before[k])}
    assert moved and all("running" in k or "num_batches" in k for k in moved), moved


def test_grad_accumulation_resumes_mid_window(wechat, tmp_path):
    """5 micro-batches straight, against 3 and a resume to 5: the restored
    accumulator makes the two runs equal bit for bit."""
    train, schema = _split(wechat, "train.tfrecord")
    batches = list(pipeline.batches(train, 8, seed=3, drop_remainder=True, max_steps=5))

    def run(model_dir, steps, feed):
        tt = Trainer(BST(BSTConfig(batch_size=8, **BST_KW), schema,
                         torch.Generator().manual_seed(0)),
                     ("read_comment",), toptimizers.build("adam", LR),
                     TrainerConfig(model_dir=str(model_dir), train_steps=steps, log_every=100,
                                   save_checkpoints_steps=0, grad_accum_steps=2), device="cpu")
        tt.train_and_evaluate(feed)
        return tt

    straight = run(tmp_path / "a", 5, batches)
    assert run(tmp_path / "b", 3, batches[:3]).mini_step == 1
    resumed = run(tmp_path / "b", 5, batches[3:])
    assert resumed.step == 5 and resumed.optimizer.count == straight.optimizer.count == 2
    assert resumed.mini_step == straight.mini_step == 1
    for (k, a), (_, b) in zip(straight.model.state_dict().items(),
                              resumed.model.state_dict().items()):
        assert torch.equal(a, b), k
    for a, b in zip(straight.accum, resumed.accum):
        assert torch.equal(a, b)


def _read_csv(path):
    with open(path) as f:
        rows = list(csv.reader(f))
    return rows[0], rows[1:]


def _data_args(tfrecords, vocab_dir, model_dir, *extra):
    return ["--train_data", str(tfrecords / "train.tfrecord"),
            "--eval_data", str(tfrecords / "test.tfrecord"),
            "--vocabulary_dir", str(vocab_dir), "--model_dir", str(model_dir),
            "--predictions_csv", str(model_dir / "predictions.csv"),
            "--batch_size", "32", "--hidden_units", "16,8", "--log_every", "100",
            "--save_checkpoints_steps", "0", "--eval_throttle_secs", "0", *extra]


@pytest.fixture(scope="module")
def jax_predictions(wechat, douban, tmp_path_factory):
    """The JAX CLI's predictions.csv of each dataset's eval split, from one
    GenericDNN step: its ids and labels are the data's, whatever the model."""
    out = {}
    for dataset, (tfrecords, vocab_dir) in (("wechat", wechat), ("douban", douban)):
        model_dir = tmp_path_factory.mktemp(f"jax_{dataset}")
        jax_cli(["--model", "GenericDNN", "--dataset", dataset, "--train_steps", "1",
                 "--no_mesh", *_data_args(tfrecords, vocab_dir, model_dir)])
        out[dataset] = _read_csv(model_dir / "predictions.csv")
    return out


@pytest.mark.parametrize("model,dataset", [("BST", "wechat"), ("GenericDNN", "douban"),
                                           ("DeepFM", "douban")])
def test_cli_on_etl_output_matches_jax_cli(wechat, douban, jax_predictions, tmp_path, model,
                                           dataset):
    """The port's CLI on the port's ETL output prints the exact AUC and the
    GAUC, and writes predictions.csv with the JAX CLI's header, row count,
    id tokens and labels on the same files."""
    tfrecords, vocab_dir = wechat if dataset == "wechat" else douban
    final = tmain.main(["--model", model, "--dataset", dataset, "--train_steps", "3",
                        "--device", "cpu", *_data_args(tfrecords, vocab_dir, tmp_path)])
    task = "read_comment" if dataset == "wechat" else "rating_ge_4"
    assert {f"{task}_exact_auc", f"{task}_gauc", f"{task}_auc"} <= set(final)
    header, rows = _read_csv(tmp_path / "predictions.csv")
    jheader, jrows = jax_predictions[dataset]
    assert header == jheader and len(rows) == len(jrows) > 0
    prob = header.index(f"{task}_probabilities")
    assert [r[:prob] + r[prob + 1:] for r in rows] == [r[:prob] + r[prob + 1:] for r in jrows]
    ids = {"wechat": ("feedid", "userid"), "douban": ("MOVIE_ID", "USER_MD5")}[dataset]
    assert tuple(header[:2]) == ids
    assert all(0.0 <= float(r[prob]) <= 1.0 for r in rows)
    users = set(VocabularyStore.from_dir(str(vocab_dir))[ids[1]].tokens())
    assert any(r[1] in users for r in rows)


@pytest.mark.parametrize("stream", [False, True])
def test_resumed_run_sees_the_straight_runs_batches(wechat, tmp_path, monkeypatch, stream):
    """6 steps straight, against 3 and a resume to 6: the resumed run is fed
    the batches after the restored step, and both end on the same weights."""
    seen = []
    real_step = Trainer.train_step
    monkeypatch.setattr(Trainer, "train_step",
                        lambda self, hb: seen.append(hb["dense"].copy()) or real_step(self, hb))
    extra = ["--stream", "--stream_chunk_records", "50"] if stream else []

    def run(model_dir, steps):
        seen.clear()
        tmain.main(["--model", "BST", "--train_steps", str(steps), "--device", "cpu",
                    "--num_epochs", "2", "--shuffle_buffer_size", "64", *extra,
                    *_data_args(*wechat, model_dir)])
        return list(seen)

    straight = run(tmp_path / "a", 6)
    first = run(tmp_path / "b", 3)
    resumed = run(tmp_path / "b", 6)
    assert len(straight) == 6 and len(first) == 3 and len(resumed) == 3
    for a, b in zip(straight, first + resumed):
        np.testing.assert_array_equal(a, b)
    wa = torch.load(tmp_path / "a" / "checkpoints" / "ckpt_6.pt", weights_only=True)["model"]
    wb = torch.load(tmp_path / "b" / "checkpoints" / "ckpt_6.pt", weights_only=True)["model"]
    for k in wa:
        assert torch.equal(wa[k], wb[k]), k
    assert tloop.latest_checkpoint_step(str(tmp_path / "b")) == 6


def test_cli_list_models(capsys):
    """--list_models is a flag of the parser: it needs no --model, prints
    each registered model once, and --help names it."""
    from recalgorithm_tpu_torch.models import MODEL_REGISTRY

    assert tmain.main(["--list_models"]) == {}
    listed = [line.split()[0] for line in capsys.readouterr().out.splitlines()]
    assert listed == sorted(MODEL_REGISTRY)
    with pytest.raises(SystemExit):
        tmain.main(["--help"])
    assert "--list_models" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        tmain.main(["--synthetic"])
    assert "--model is required" in capsys.readouterr().err
