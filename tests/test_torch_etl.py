"""Port parity for the offline ETLs and the raw-CSV generators: on the same
raw CSVs the port's WeChatETL (whole-RAM and ``chunk_dates``) and DoubanETL
write byte-identical vocabulary/*.txt, dataframe/*.csv and
tfrecord/*.tfrecord to the JAX package's; data/synth_raw.py and
data/synth_douban.py write the JAX generators' bytes for the same config.
Each raw fixture is built once per module, at the JAX tests' sizes
(tests/test_etl.py, tests/test_douban.py)."""

import filecmp
import os

import pandas as pd
import pytest

from recalgorithm_tpu.data import synth_douban as jsynth_douban
from recalgorithm_tpu.data import synth_raw as jsynth_raw
from recalgorithm_tpu.data.douban import DoubanETL as JaxDoubanETL
from recalgorithm_tpu.data.etl import WeChatETL as JaxWeChatETL
from recalgorithm_tpu_torch.data import pipeline, synth_douban, synth_raw
from recalgorithm_tpu_torch.data.douban import DoubanETL
from recalgorithm_tpu_torch.data.etl import WeChatETL
from recalgorithm_tpu_torch.features.schema import douban_schema, wechat_schema
from recalgorithm_tpu_torch.features.vocab import VocabularyStore
from tests.torch_data_common import ensure_jax_native, write_raw_douban, write_raw_wechat


def _artifacts(root):
    """Relative paths of every vocabulary, dataframe and tfrecord file."""
    out = []
    for sub in ("vocabulary", "dataframe", "tfrecord"):
        out += sorted(f"{sub}/{f}" for f in os.listdir(os.path.join(root, sub))
                      if f.endswith((".txt", ".csv", ".tfrecord")))
    return out


def assert_same_bytes(got_root, want_root):
    names = _artifacts(want_root)
    assert names and _artifacts(got_root) == names
    assert any(n.endswith(".tfrecord") for n in names)
    for name in names:
        assert filecmp.cmp(os.path.join(got_root, name), os.path.join(want_root, name),
                           shallow=False), name


@pytest.fixture(scope="module")
def raw_wechat(tmp_path_factory):
    ensure_jax_native()
    return write_raw_wechat(tmp_path_factory.mktemp("raw_wechat"))


@pytest.fixture(scope="module")
def raw_douban(tmp_path_factory):
    ensure_jax_native()
    return write_raw_douban(tmp_path_factory.mktemp("raw_douban"))


@pytest.mark.parametrize("chunk_dates", [False, True])
def test_wechat_etl_is_byte_identical(raw_wechat, tmp_path, chunk_dates):
    raw = str(raw_wechat) + "/"
    JaxWeChatETL(raw, str(tmp_path / "jax") + "/", chunk_dates=chunk_dates).run()
    WeChatETL(raw, str(tmp_path / "torch") + "/", chunk_dates=chunk_dates).run()
    assert_same_bytes(tmp_path / "torch", tmp_path / "jax")
    # and the split reads back through the port's pipeline
    vocabs = VocabularyStore.from_dir(str(tmp_path / "torch" / "vocabulary"))
    data = pipeline.load_dataset(str(tmp_path / "torch" / "tfrecord" / "test.tfrecord"),
                                 wechat_schema(vocabs.sizes()), vocabs)
    assert data.num_examples == len(pd.read_csv(tmp_path / "torch" / "dataframe" / "test.csv"))


def test_douban_etl_is_byte_identical(raw_douban, tmp_path):
    raw = str(raw_douban) + "/"
    JaxDoubanETL(raw, str(tmp_path / "jax") + "/").run()
    DoubanETL(raw, str(tmp_path / "torch") + "/").run()
    assert_same_bytes(tmp_path / "torch", tmp_path / "jax")
    vocabs = VocabularyStore.from_dir(str(tmp_path / "torch" / "vocabulary"))
    data = pipeline.load_dataset(str(tmp_path / "torch" / "tfrecord" / "train.tfrecord"),
                                 douban_schema(vocabs.sizes()), vocabs)
    assert data.num_examples == len(pd.read_csv(tmp_path / "torch" / "dataframe" / "train.csv"))


def test_wechat_etl_resumes_after_crash(raw_wechat, tmp_path):
    """A run that stops after the dataframe stage resumes at the tfrecord
    stage from the cached features and CSVs, and still writes the bytes of
    an uninterrupted run."""
    raw = str(raw_wechat) + "/"
    etl = WeChatETL(raw, str(tmp_path / "resumed") + "/")
    ua, fi = etl._load(pd)
    etl._generate_vocabulary(pd, ua, fi)
    frames = etl._generate_features(pd, ua, fi)
    etl._generate_dataframe(pd, ua, fi, frames)
    assert not (tmp_path / "resumed" / "tfrecord").exists()
    m_csv = os.path.getmtime(tmp_path / "resumed" / "dataframe" / "train.csv")
    etl.run()
    assert os.path.getmtime(tmp_path / "resumed" / "dataframe" / "train.csv") == m_csv
    WeChatETL(raw, str(tmp_path / "straight") + "/").run()
    assert_same_bytes(tmp_path / "resumed", tmp_path / "straight")


@pytest.mark.parametrize("which", ["wechat", "douban"])
def test_raw_generators_write_the_jax_bytes(tmp_path, which):
    if which == "wechat":
        files = ("user_action.csv", "feed_info.csv")
        jsynth_raw.generate_raw_csvs(str(tmp_path / "jax"), jsynth_raw.RawConfig(scale=0.002, seed=1))
        synth_raw.generate_raw_csvs(str(tmp_path / "torch"), synth_raw.RawConfig(scale=0.002, seed=1))
    else:
        files = ("movies.csv", "ratings.csv")
        jsynth_douban.generate_douban_csvs(
            str(tmp_path / "jax"), jsynth_douban.DoubanRawConfig(scale=0.002, seed=1))
        synth_douban.generate_douban_csvs(
            str(tmp_path / "torch"), synth_douban.DoubanRawConfig(scale=0.002, seed=1))
    for f in files:
        assert filecmp.cmp(tmp_path / "torch" / f, tmp_path / "jax" / f, shallow=False), f
