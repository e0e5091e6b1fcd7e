"""Port parity for TwoTower and ``serving/retrieval.py``: the model against
the JAX model with its weights carried across (tower vectors, logits, the
in-batch softmax with and without the log-Q correction, every gradient, the
``feedid_freq`` statistics), the ``convert`` round trips (``feedid_freq`` a
buffer both ways); the cases of tests/test_retrieval.py on the port (the
sharded top-k's are in tests/test_torch_distributed.py): the collision mask and
log-Q against their numpy oracles, the Retriever against numpy and the JAX
Retriever, the int8 corpus's recall, the corpus snapshot, the batching
server, the per-task loss weight, learning and Recall@K; ``cli.main
--eval_recall_at`` on the CPU.

Tolerances: tests/torch_zoo_common.py's; the losses against their numpy
oracles at rtol 1e-4, the JAX test's own bar (float64 numpy against the f32
model); retrieved scores at atol 1e-5 and batched against direct at rtol
1e-4 / atol 1e-5, the JAX tests' bars."""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recalgorithm_tpu.data.synthetic import SyntheticConfig, SyntheticWeChat
from recalgorithm_tpu.features.schema import wechat_schema
from recalgorithm_tpu.models.two_tower import TwoTower as JaxTwoTower
from recalgorithm_tpu.models.two_tower import TwoTowerConfig as JaxTwoTowerConfig
from recalgorithm_tpu.serving import retrieval as jretrieval
from recalgorithm_tpu_torch import convert
from recalgorithm_tpu_torch.cli import main as tmain
from recalgorithm_tpu_torch.features.schema import wechat_schema as t_wechat_schema
from recalgorithm_tpu_torch.models.two_tower import TwoTower, TwoTowerConfig
from recalgorithm_tpu_torch.serving.retrieval import (
    Retriever,
    brute_force_top_k,
    quantized_top_k,
)
from recalgorithm_tpu_torch.serving.server import BatchingPredictor
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
    wechat_batch,
)

B = 32
SMALL = dict(hidden_units=(32,), output_dim=8)
CASES = {"plain": dict(SMALL), "logq": dict(logq_correction=True, freq_decay=0.9, **SMALL)}

_gen = SyntheticWeChat(wechat_schema(), SyntheticConfig(seed=7, vocab_scale=0.002))
JSCHEMA = wechat_schema(_gen.vocab_sizes())
SCHEMA = t_wechat_schema(_gen.vocab_sizes())
BATCH = _gen.batch(B, 0)


@pytest.fixture(scope="module")
def data():
    return wechat_batch()


def _model(seed=0, **kw):
    return TwoTower(TwoTowerConfig(**{**SMALL, **kw}), SCHEMA,
                    torch.Generator().manual_seed(seed))


def _tb(hb):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in hb.items()}


def _vectors(model, hb):
    model.eval()
    with torch.no_grad():
        return model.user_embedding(_tb(hb)).numpy(), model.item_embedding(_tb(hb)).numpy()


def _softmax_oracle(u, v, feed, y, temperature, log_q=0.0):
    scores = (u.astype(np.float64) @ v.T.astype(np.float64)) / temperature - log_q
    same = feed[:, None] == feed[None, :]
    np.fill_diagonal(same, False)
    scores = np.where(same, -1e9, scores)
    m = scores.max(-1, keepdims=True)
    logp = scores - m - np.log(np.sum(np.exp(scores - m), -1, keepdims=True))
    return -np.sum(np.diagonal(logp) * y) / max(y.sum(), 1.0), logp


# ---------------------------------------------------------------------------
# the model against the JAX model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", sorted(CASES))
def test_model_matches_jax(data, case):
    """Eval logits, train-mode logits, the in-batch softmax loss, every
    gradient, and (log-Q) the updated ``feedid_freq`` statistics."""
    gen, hb = data
    check_matches_jax(*build_pair("TwoTower", CASES[case], {}, wechat_schema(gen.vocab_sizes()),
                                  t_wechat_schema(gen.vocab_sizes())), hb)


@pytest.mark.parametrize("case", sorted(CASES))
def test_convert_round_trips_bit_exact(data, case):
    gen, hb = data
    jmodel, model = build_pair("TwoTower", CASES[case], {}, wechat_schema(gen.vocab_sizes()),
                               t_wechat_schema(gen.vocab_sizes()))
    check_round_trips(jmodel, model, hb)
    if case == "logq":
        assert "feedid_freq" in convert.to_flax(model)["batch_stats"]
        assert "feedid_freq" in dict(model.named_buffers())


def test_towers_match_jax_and_are_l2_normalised(data):
    gen, hb = data
    jmodel, model = build_pair("TwoTower", SMALL, {}, wechat_schema(gen.vocab_sizes()),
                               t_wechat_schema(gen.vocab_sizes()))
    jb = {k: jnp.asarray(v) for k, v in hb.items()}
    variables = jax.jit(jmodel.init)(jax.random.key(0), jb)
    model.load_state_dict(convert.from_flax(jax.device_get(variables)))
    u, v = _vectors(model, hb)
    with jax.default_matmul_precision("highest"):
        ju, jv = jax.jit(lambda var, b: (
            jmodel.apply(var, b, method=jmodel.user_embedding),
            jmodel.apply(var, b, method=jmodel.item_embedding)))(variables, jb)
    np.testing.assert_allclose(u, ju, **TOL)
    np.testing.assert_allclose(v, jv, **TOL)
    for vec in (u, v):
        assert vec.shape == (len(hb["labels"]), 8)
        np.testing.assert_allclose(np.linalg.norm(vec, axis=-1), 1.0, atol=1e-5)


@pytest.mark.parametrize("case", sorted(CASES))
def test_every_parameter_gets_a_gradient(data, case):
    gen, hb = data
    check_every_parameter_gets_a_gradient(build_pair(
        "TwoTower", CASES[case], {}, wechat_schema(gen.vocab_sizes()),
        t_wechat_schema(gen.vocab_sizes()))[1], hb)


# ---------------------------------------------------------------------------
# tests/test_retrieval.py's cases on the port
# ---------------------------------------------------------------------------


def test_in_batch_softmax_matches_oracle_with_collision_mask():
    """The loss equals a hand-computed masked softmax, with a duplicate item
    (row 1 has row 0's feedid) masked out of row 0's negatives; a batch
    without labels (serving) returns the logit only."""
    model = _model()
    batch = dict(BATCH)
    feed = batch["feedid"].copy()
    feed[1] = feed[0]
    batch["feedid"] = feed
    model.eval()
    with torch.no_grad():
        _, losses = model(_tb(batch))
    u, v = _vectors(model, batch)
    y = batch["labels"][:, SCHEMA.labels.index("read_comment")].astype(np.float64)
    oracle, logp = _softmax_oracle(u, v, feed, y, model.config.temperature)
    np.testing.assert_allclose(float(losses["in_batch_softmax"]), oracle, rtol=1e-4)
    assert logp[0, 1] < -1e8  # the duplicate is out of row 0's softmax
    with torch.no_grad():
        out, losses = model(_tb({k: x for k, x in batch.items() if k != "labels"}))
    assert losses == {} and out["read_comment"].shape == (B,)


def test_logq_correction_tracks_frequencies_and_matches_oracle():
    """A train-mode forward folds the batch into the EMA (decay * prior +
    histogram), the loss takes -log(p_j) on each candidate column from the
    updated counts, and an eval forward leaves the estimator alone."""
    model = _model(logq_correction=True, freq_decay=0.9)
    vocab = SCHEMA.vocab_sizes["feedid"]
    feed = BATCH["feedid"]
    model.train()
    _, losses = model(_tb(BATCH))
    freq = model.feedid_freq.numpy().copy()
    np.testing.assert_allclose(freq, 0.9 * np.ones(vocab) + np.bincount(feed, minlength=vocab),
                               rtol=1e-6)
    u, v = _vectors(model, BATCH)
    y = BATCH["labels"][:, SCHEMA.labels.index("read_comment")].astype(np.float64)
    oracle, _ = _softmax_oracle(u, v, feed, y, model.config.temperature,
                                np.log(freq[feed] / freq.sum()))
    np.testing.assert_allclose(float(losses["in_batch_softmax"].detach()), oracle, rtol=1e-4)
    model.eval()
    with torch.no_grad():
        model(_tb(BATCH))
    np.testing.assert_array_equal(model.feedid_freq.numpy(), freq)


def _jax_retriever(model, **kw):
    """The JAX Retriever and TwoTower with the port model's weights."""
    jmodel = JaxTwoTower(config=JaxTwoTowerConfig(**SMALL), schema=JSCHEMA)
    return jretrieval.Retriever(jmodel, convert.to_flax(model), **kw)


def test_retriever_topk_matches_numpy_oracle_and_jax():
    model = _model()
    retr = Retriever(model, device="cpu")
    item_batches = [_gen.batch(B, s) for s in (1, 2, 3)]
    n = retr.build_corpus(item_batches)
    assert n == len(set(retr.corpus_ids.tolist()))  # deduped
    ids, scores = retr.retrieve(BATCH, k=5)
    assert ids.shape == scores.shape == (B, 5)
    u, _ = _vectors(model, BATCH)
    full = u @ retr.corpus.numpy().T
    order = np.argsort(-full, axis=-1)[:, :5]
    np.testing.assert_allclose(scores, np.take_along_axis(full, order, -1), atol=1e-5)
    np.testing.assert_array_equal(ids, retr.corpus_ids[order])
    assert np.all(np.diff(scores, axis=-1) <= 1e-6)
    jretr = _jax_retriever(model)
    with jax.default_matmul_precision("highest"):
        assert jretr.build_corpus({k: jnp.asarray(a) for k, a in b.items()}
                                  for b in item_batches) == n
        jids, jscores = jretr.retrieve({k: jnp.asarray(a) for k, a in BATCH.items()}, k=5)
    np.testing.assert_array_equal(retr.corpus_ids, jretr.corpus_ids)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_allclose(scores, jscores, **TOL)


def test_brute_force_top_k_shape_and_exactness():
    rng = np.random.default_rng(0)
    u = rng.normal(size=(4, 8)).astype(np.float32)
    c = rng.normal(size=(50, 8)).astype(np.float32)
    scores, idx = brute_force_top_k(torch.from_numpy(u), torch.from_numpy(c), 3)
    oracle = u @ c.T
    np.testing.assert_array_equal(idx.numpy(), np.argsort(-oracle, -1)[:, :3])
    np.testing.assert_allclose(scores.numpy(), np.sort(oracle, -1)[:, ::-1][:, :3], atol=1e-5)


def test_quantized_top_k_matches_jax():
    """The same user rows and int8 corpus through the port's and the JAX
    package's ``quantized_top_k``: the same rows, the same scores (the int8
    products are exact on both sides)."""
    rng = np.random.default_rng(2)
    u = rng.normal(size=(16, 8)).astype(np.float32)
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    from recalgorithm_tpu_torch.serving.quantize import quantize_table

    q, scale = quantize_table(rng.normal(size=(300, 8)).astype(np.float32))
    s, i = quantized_top_k(torch.from_numpy(u), torch.from_numpy(q), torch.from_numpy(scale),
                           7, overfetch=3)
    with jax.default_matmul_precision("highest"):
        js, ji = jretrieval.quantized_top_k(jnp.asarray(u), jnp.asarray(q), jnp.asarray(scale),
                                            7, overfetch=3)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), **TOL)


def test_retriever_through_batching_server():
    """Single-user retrieval requests co-batch through BatchingPredictor and
    return each row of the direct batched retrieve()."""
    retr = Retriever(_model(), device="cpu", serve_k=5)
    retr.build_corpus(_gen.batch(B, s) for s in (1, 2))
    direct_ids, direct_scores = retr.retrieve(BATCH, k=5)
    server = BatchingPredictor(retr, max_batch_size=16, max_delay_ms=5.0)
    try:
        examples = [{k: np.asarray(v)[i] for k, v in BATCH.items()} for i in range(B)]
        with ThreadPoolExecutor(max_workers=8) as ex:
            results = list(ex.map(server.predict_one, examples))
    finally:
        server.close()
    np.testing.assert_array_equal(np.stack([r["feedids"] for r in results]), direct_ids)
    np.testing.assert_allclose(np.stack([r["scores"] for r in results]), direct_scores,
                               rtol=1e-4, atol=1e-5)


def test_task_loss_weight_scales_sigmoid_ce():
    """tlw = 0 removes exactly the per-task sigmoid CE from the total loss
    (pure in-batch-softmax training)."""
    def total_for(weight):
        model = _model(task_loss_weights=(("read_comment", weight),))
        tr = Trainer(model, ("read_comment",), optimizers.build("adam", 1e-3),
                     TrainerConfig(model_dir="unused"), device="cpu")
        model.eval()
        batch = tr._put_batch(BATCH)
        with torch.no_grad():
            total, logits = tr._loss_and_logits(batch)
            ce = torch.nn.functional.binary_cross_entropy_with_logits(
                logits["read_comment"], tr._task_label(batch, "read_comment"))
        return float(total), float(ce)

    t1, ce1 = total_for(1.0)
    t0, ce0 = total_for(0.0)
    np.testing.assert_allclose(ce0, ce1, rtol=1e-6)  # same init, same CE
    np.testing.assert_allclose(t1 - t0, ce1, rtol=1e-5)


def test_two_tower_learns_and_recall_improves(tmp_path):
    """40 steps: the cosine-logit AUC beats chance, and Recall@20 of the
    trained towers beats the untrained ones' on the same corpus."""
    cfg = TwoTowerConfig(batch_size=128, hidden_units=(64,), output_dim=16)

    def fresh():
        return TwoTower(cfg, SCHEMA, torch.Generator().manual_seed(0))

    model = fresh()
    tr = Trainer(model, cfg.task_names, optimizers.build("adam", 0.005),
                 TrainerConfig(model_dir=str(tmp_path), train_steps=40, log_every=20,
                               save_checkpoints_steps=1000), device="cpu")
    ev = tr.train_and_evaluate(_gen.batches(128, 40),
                               lambda: _gen.batches(128, 8, start_seed=9000),
                               log_fn=lambda line: None)
    assert ev["read_comment_auc"] > 0.55, ev
    assert np.isfinite(ev["loss"])

    def recall(m):
        retr = Retriever(m, device="cpu")
        retr.build_corpus(_gen.batches(128, 4, start_seed=9000))
        return retr.recall_at_k(_gen.batches(128, 4, start_seed=9000), k=20,
                                label_index=SCHEMA.labels.index("read_comment"))

    trained, untrained = recall(model), recall(fresh())
    assert trained > untrained, (trained, untrained)


def test_quantized_corpus_retrieval_recall():
    """The int8 corpus (coarse int8 scoring + exact rescore) recovers the
    exact-f32 top-k with high overlap and close scores, stores the corpus in
    under 0.45 of the f32 bytes and never keeps the f32 matrix."""
    model = _model()
    item_batches = [_gen.batch(B, s) for s in (1, 2, 3, 4)]
    exact = Retriever(model, device="cpu")
    n = exact.build_corpus(item_batches)
    quant = Retriever(model, device="cpu", quantize_corpus=True, overfetch=4)
    assert quant.build_corpus(item_batches) == n
    assert quant.corpus is None and quant.corpus_q.dtype == torch.int8
    assert quant.corpus_q.numel() + quant.corpus_scale.numel() * 4 < 0.45 * n * 8 * 4
    k = 10
    ids_e, scores_e = exact.retrieve(BATCH, k=k)
    ids_q, scores_q = quant.retrieve(BATCH, k=k)
    overlap = np.mean([len(set(ids_e[b]) & set(ids_q[b])) / k for b in range(B)])
    assert overlap >= 0.9, overlap
    np.testing.assert_allclose(scores_q[:, 0], scores_e[:, 0], atol=5e-3)
    assert np.all(np.diff(scores_q, axis=-1) <= 1e-6)


def test_corpus_snapshot_roundtrip(tmp_path):
    """save_corpus / load_corpus (f32 and int8, a path without .npz): a
    replica retrieves identically; a snapshot of the other kind is refused;
    PAD/OOV id 0 never enters a corpus.  The snapshot is the JAX package's:
    its Retriever loads the port's f32 snapshot and retrieves the same ids."""
    model = _model()
    item_batches = [_gen.batch(B, s) for s in (1, 2)]
    for quantize in (False, True):
        published = Retriever(model, device="cpu", quantize_corpus=quantize)
        n = published.build_corpus(item_batches)
        path = str(tmp_path / f"corpus_{quantize}")
        assert published.save_corpus(path).endswith(".npz")
        replica = Retriever(model, device="cpu", quantize_corpus=quantize)
        assert replica.load_corpus(path) == n
        ids_a, scores_a = published.retrieve(BATCH, k=5)
        ids_b, scores_b = replica.retrieve(BATCH, k=5)
        np.testing.assert_array_equal(ids_a, ids_b)
        np.testing.assert_allclose(scores_a, scores_b, rtol=1e-6)
    with pytest.raises(ValueError, match="int8"):
        Retriever(model, device="cpu").load_corpus(str(tmp_path / "corpus_True.npz"))
    jretr = _jax_retriever(model)
    jretr.load_corpus(str(tmp_path / "corpus_False"))
    with jax.default_matmul_precision("highest"):
        jids, _ = jretr.retrieve({k: jnp.asarray(a) for k, a in BATCH.items()}, k=5)
    replica = Retriever(model, device="cpu")
    replica.load_corpus(str(tmp_path / "corpus_False"))
    np.testing.assert_array_equal(jids, replica.retrieve(BATCH, k=5)[0])
    padded = [dict(b) for b in item_batches]
    padded[0]["feedid"] = padded[0]["feedid"].copy()
    padded[0]["feedid"][:3] = 0
    r0 = Retriever(model, device="cpu")
    r0.build_corpus(padded)
    assert 0 not in set(r0.corpus_ids.tolist())


def test_cli_reports_recall_at_k(tmp_path):
    """cli.main --eval_recall_at 10 on the CPU: recall_at_10 in the final
    eval, in [0, 1]."""
    final = tmain.main(cli_args("TwoTower", {}, tmp_path, 4, "--device", "cpu",
                                "--eval_recall_at", "10"))
    assert 0.0 <= final["recall_at_10"] <= 1.0 and 0.0 <= final["read_comment_auc"] <= 1.0


def test_cli_raises_without_a_gpu(tmp_path):
    check_cli_raises_without_a_gpu("TwoTower", {}, tmp_path)


def test_retriever_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("this box has a GPU: cuda is a valid default here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Retriever(_model())
