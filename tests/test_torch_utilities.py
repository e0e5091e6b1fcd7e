"""The port's utilities against the JAX package's: cli/sweep.py (as
tests/test_sweep_cli.py, with --device cpu), the per-model CLI aliases,
data/stats.py (the statistics equal to the JAX reporter's on the same file,
and the EDA plots), the TensorBoard mirror of utils/summary.py,
utils/benchmarking.py (the contract of
test_loop_step_time_stats_reps_and_budget; no assertion on host-clock
timing) and models/common.sigmoid_tasks.  Equalities are exact; sigmoid
within rtol 1e-6 (f32 on both sides)."""

import glob
import json
import os
import runpy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recalgorithm_tpu.data import pipeline as jpipeline
from recalgorithm_tpu.data import stats as jstats
from recalgorithm_tpu.features.schema import wechat_schema as jax_wechat_schema
from recalgorithm_tpu.features.vocab import VocabularyStore as JaxVocabularyStore
from recalgorithm_tpu.models.common import sigmoid_tasks as jax_sigmoid_tasks
from recalgorithm_tpu_torch.cli import main as tmain
from recalgorithm_tpu_torch.data import pipeline, stats
from recalgorithm_tpu_torch.features.schema import wechat_schema
from recalgorithm_tpu_torch.features.vocab import VocabularyStore
from recalgorithm_tpu_torch.models import MODEL_REGISTRY
from recalgorithm_tpu_torch.models.common import sigmoid_tasks
from recalgorithm_tpu_torch.utils import benchmarking
from recalgorithm_tpu_torch.utils.summary import SummaryWriter
from tests.torch_data_common import ensure_jax_native, write_split

CLI_DIR = os.path.join(os.path.dirname(tmain.__file__))
ALIASES = sorted(f[:-3] for f in os.listdir(CLI_DIR)
                 if f.endswith(".py") and f[:-3] not in ("__init__", "main", "serve", "score",
                                                         "sweep"))


def test_sweep_two_point_grid(tmp_path, monkeypatch):
    from recalgorithm_tpu_torch.cli import sweep

    out = str(tmp_path / "result.md")
    monkeypatch.chdir(tmp_path)  # any run artifact stays in tmp
    rows = sweep.main([
        "--model", "DeepCrossing", "--synthetic", "--device", "cpu",
        "--grid", '{"residual_network_num": [1, 2]}', "--out", out, "--",
        "--train_steps", "8", "--batch_size", "32", "--save_checkpoints_steps", "0",
        "--synthetic_vocab_scale", "0.002", "--log_every", "4"])
    assert len(rows) == 2
    lines = [ln for ln in open(out).read().splitlines() if ln.startswith("|")]
    header, _, *body = lines
    assert "residual_network_num" in header and "read_comment_auc" in header
    assert len(body) == 2
    col = header.strip("|").split("|").index(" read_comment_auc ")
    for row, want in zip(body, ("1", "2")):
        cells = [c.strip() for c in row.strip("|").split("|")]
        assert cells[0] == want
        assert 0.0 <= float(cells[col]) <= 1.0


def test_sweep_passes_the_device():
    """Without --device cpu the runs take cuda, which raises without a card."""
    from recalgorithm_tpu_torch.cli import sweep

    if torch.cuda.is_available():
        pytest.skip("this box has a GPU: cuda is a valid default here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sweep.main(["--model", "DeepCrossing", "--synthetic", "--grid",
                    '{"residual_network_num": [1]}', "--", "--train_steps", "2"])


def test_every_registry_name_has_an_alias():
    assert len(ALIASES) == 27
    names = set()
    for mod in ALIASES:
        src = open(os.path.join(CLI_DIR, f"{mod}.py")).read()
        names.add(src.split('model_name="')[1].split('"')[0])
    assert names == set(MODEL_REGISTRY)


@pytest.mark.parametrize("mod", ALIASES)
def test_alias_runs_main_with_its_model(mod, monkeypatch):
    """``python -m recalgorithm_tpu_torch.cli.<mod>`` calls cli.main's main
    with its model, whose parser then defaults --model to it."""
    seen = []
    monkeypatch.setattr(tmain, "main", lambda argv=None, model_name=None: seen.append(model_name))
    runpy.run_module(f"recalgorithm_tpu_torch.cli.{mod}", run_name="__main__")
    (name,) = seen
    assert name in MODEL_REGISTRY
    assert tmain.build_parser(name).parse_args([]).model == name


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    root = tmp_path_factory.mktemp("stats")
    path, vocab_dir = write_split(root, 40, seed=3)
    ensure_jax_native()
    return path, vocab_dir


def test_stats_equal_jax(split, capsys):
    path, vocab_dir = split
    vocabs = VocabularyStore.from_dir(vocab_dir)
    schema = wechat_schema(vocabs.sizes())
    got = stats.compute_stats(pipeline.load_dataset(path, schema, vocabs), schema)
    jvocabs = JaxVocabularyStore.from_dir(vocab_dir)
    jschema = jax_wechat_schema(jvocabs.sizes())
    want = jstats.compute_stats(jpipeline.load_dataset(path, jschema, jvocabs), jschema)
    assert got == want
    assert got["num_examples"] == 40
    printed = stats.main(["--tfrecord", path, "--vocabulary_dir", vocab_dir])
    assert printed == {**want, "vocab_sizes": jvocabs.sizes()}
    assert json.loads(capsys.readouterr().out) == json.loads(json.dumps(printed))


def test_stats_plots_rendered(split, tmp_path):
    pytest.importorskip("matplotlib")
    path, vocab_dir = split
    vocabs = VocabularyStore.from_dir(vocab_dir)
    schema = wechat_schema(vocabs.sizes())
    written = stats.render_plots(pipeline.load_dataset(path, schema, vocabs), schema,
                                 str(tmp_path / "plots"))
    names = {os.path.basename(w) for w in written}
    assert {"behaviour_rates.png", "dense_distributions.png", "userid_skew.png",
            "his_read_comment_7d_seq_lengths.png"} <= names
    for w in written:
        assert os.path.getsize(w) > 5000, w  # a rendered chart


def test_summary_mirrors_to_tensorboard(tmp_path):
    """JSONL always; TensorBoard event files where the package imports
    (not on the card machine, which has none)."""
    pytest.importorskip("tensorboard")
    w = SummaryWriter(str(tmp_path))
    assert w._tb is not None
    w.scalars(3, {"train/loss": 0.5, "train/auc": 0.75})
    w.histogram(3, "summaries/kernel", np.arange(64, dtype=np.float32))
    w.close()
    recs = [json.loads(ln) for ln in open(tmp_path / "scalars.jsonl")]
    assert recs[0]["train/loss"] == 0.5 and recs[1]["histogram"] == "summaries/kernel"
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    (events,) = glob.glob(str(tmp_path / "events.out.tfevents.*"))
    acc = EventAccumulator(events)
    acc.Reload()
    assert {"train/loss", "train/auc"} <= set(acc.Tags()["scalars"])
    (ev,) = acc.Scalars("train/auc")
    assert ev.step == 3 and ev.value == 0.75
    assert "summaries/kernel" in acc.Tags()["histograms"]
    off = SummaryWriter(str(tmp_path / "rank1"), enabled=False)  # another process's
    assert off._tb is None and not os.path.exists(tmp_path / "rank1")


def test_loop_step_time_stats_reps_and_budget():
    a = torch.eye(64) * 0.999

    def step(state, batch, rng):
        s = state @ a
        return s, s[0].sum()

    st = benchmarking.loop_step_time_stats(step, torch.ones(64, 64), {}, reps=3,
                                           k_small=2, k_big=12, repeats=1, device="cpu",
                                           rng_impl="rbg", compiler_options={})
    assert len(st["reps_us"]) == 3
    assert st["median_us"] == sorted(st["reps_us"])[1]
    assert st["sigma_us"] >= 0.0 and all(v > 0 for v in st["reps_us"])
    # a zero budget still keeps two reps
    st2 = benchmarking.loop_step_time_stats(step, torch.ones(64, 64), {}, reps=5,
                                            time_budget_s=0.0, k_small=2, k_big=12, repeats=1,
                                            device="cpu")
    assert len(st2["reps_us"]) == 2


def test_loop_step_time_runs_each_step_on_the_batch():
    """k_small + k_big steps a timed run, after a warm-up run of each, each
    step given the batch and its index from the run's seed."""
    seen = []

    def step(state, batch, rng):
        seen.append((batch, rng))
        return state, torch.zeros(())

    benchmarking.loop_step_time_us(step, None, "b", k_small=2, k_big=5, repeats=1, seed=10,
                                   device="cpu")
    assert [b for b, _ in seen] == ["b"] * (2 * (2 + 5))
    assert [r for _, r in seen] == [10, 11, 11, 12, 10, 11, 12, 13, 14, 11, 12, 13, 14, 15]


def test_sigmoid_tasks_matches_jax():
    logits = {"a": np.linspace(-8, 8, 17).astype(np.float32), "b": np.zeros(3, np.float32)}
    got = sigmoid_tasks({k: torch.from_numpy(v) for k, v in logits.items()})
    want = jax_sigmoid_tasks({k: jnp.asarray(v) for k, v in logits.items()})
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6)
