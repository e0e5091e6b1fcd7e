"""Feature schema: the typed contract between data pipeline, embedding engine and models.

The reference keeps its feature definitions implicit inside per-model
``create_feature_columns()`` functions built on ``tf.feature_column``
(e.g. reference algorithm/WideAndDeep/wide_and_deep.py:58-126).  This
package makes the schema an explicit, hashable dataclass tree:

  * string->id translation happens on the **host** (see features/vocab.py);
    the device only ever sees fixed-shape int32/float32 tensors,
  * every model declares which fields it consumes and with which embedding
    dims; the embedding engine (embed/) materialises exactly those tables,
  * batches are plain dicts of numpy arrays, moved to the model's device by
    the predictor.

Own copy of ``recalgorithm_tpu/features/schema.py`` (the WeChat and Douban
schemas): the PyTorch package imports nothing of the JAX package.

Feature kinds mirror the reference's column types:
  DenseFeature      <- fc.numeric_column            (already log1p'd by the ETL)
  CategoricalFeature<- fc.categorical_column_with_vocabulary_file + embedding
  SequenceFeature   <- sequence/multi-hot categorical (mean combiner)
  CrossFeature      <- fc.crossed_column(hash_bucket_size=N) (wide part)

Id convention (differs from TF, which uses -1 for OOV and masks it inside
safe_embedding_lookup_sparse): id 0 is reserved for PAD/OOV/missing, real
vocabulary entries occupy 1..vocab_size.  Tables therefore have
``vocab_size + 1`` rows and row 0 is excluded from mean-combiner counts.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class DenseFeature:
    """A scalar float feature (stacked into one (B, n_dense) array)."""

    name: str


@dataclasses.dataclass(frozen=True)
class CategoricalFeature:
    """A scalar categorical feature looked up against a named vocabulary.

    ``vocab`` names the id space; fields sharing a ``vocab`` share the
    embedding table when a model requests it (the reference shares feedid
    between the target item and the behaviour sequence,
    wide_and_deep.py:109).
    """

    name: str
    vocab: str


@dataclasses.dataclass(frozen=True)
class SequenceFeature:
    """A variable-length list of categorical ids, padded to ``max_length``.

    Batches carry ``name`` as (B, max_length) int32 (0-padded) plus
    ``name + '_len'`` as (B,) int32.
    """

    name: str
    vocab: str
    max_length: int


@dataclasses.dataclass(frozen=True)
class CrossFeature:
    """A hashed cross of two fields (reference wide_and_deep.py:121-124).

    The cross of a scalar field with a sequence field yields up to
    ``max_length`` bucket ids per example; they are produced on device by
    a hashed cross (``embed/cross.py`` in the JAX package) from the already-translated
    integer ids.  The reference hashes the *string* cross with FarmHash64;
    string hashing is device-hostile, so we hash the integer id pair with a
    splitmix64-style mixer instead (documented deviation — the bucket
    distribution is equivalent in expectation, the exact bucket assignment is
    not bit-identical).
    """

    name: str
    keys: tuple[str, str]  # (scalar field, scalar-or-sequence field)
    num_buckets: int


Feature = DenseFeature | CategoricalFeature | SequenceFeature | CrossFeature


@dataclasses.dataclass(frozen=True)
class Schema:
    """Full dataset schema: features, label names and vocabulary sizes."""

    dense: tuple[DenseFeature, ...]
    categorical: tuple[CategoricalFeature, ...]
    sequence: tuple[SequenceFeature, ...]
    cross: tuple[CrossFeature, ...]
    labels: tuple[str, ...]
    vocab_sizes: Mapping[str, int]

    @property
    def dense_names(self) -> tuple[str, ...]:
        return tuple(f.name for f in self.dense)

    @property
    def categorical_names(self) -> tuple[str, ...]:
        return tuple(f.name for f in self.categorical)

    @property
    def sequence_names(self) -> tuple[str, ...]:
        return tuple(f.name for f in self.sequence)

    def feature(self, name: str) -> Feature:
        for group in (self.dense, self.categorical, self.sequence, self.cross):
            for f in group:
                if f.name == name:
                    return f
        raise KeyError(name)

    def vocab_of(self, field_name: str) -> str:
        f = self.feature(field_name)
        if isinstance(f, (CategoricalFeature, SequenceFeature)):
            return f.vocab
        raise TypeError(f"field {field_name!r} has no vocabulary")

    def batch_spec(self, batch_size: int) -> dict[str, tuple[tuple[int, ...], np.dtype]]:
        """Shape/dtype spec of a host batch (used by tests and the C++ reader)."""
        spec: dict[str, tuple[tuple[int, ...], np.dtype]] = {
            "dense": ((batch_size, len(self.dense)), np.dtype(np.float32)),
            "labels": ((batch_size, len(self.labels)), np.dtype(np.float32)),
        }
        for f in self.categorical:
            spec[f.name] = ((batch_size,), np.dtype(np.int32))
        for f in self.sequence:
            spec[f.name] = ((batch_size, f.max_length), np.dtype(np.int32))
            spec[f.name + "_len"] = ((batch_size,), np.dtype(np.int32))
        return spec


# ---------------------------------------------------------------------------
# The WeChat Channels dataset schema (reference DataGenerator.py:74-109).
# ---------------------------------------------------------------------------

WECHAT_DENSE_NAMES: tuple[str, ...] = (
    "videoplayseconds",
    "u_read_comment_7d_sum",
    "u_like_7d_sum",
    "u_click_avatar_7d_sum",
    "u_forward_7d_sum",
    "u_comment_7d_sum",
    "u_follow_7d_sum",
    "u_favorite_7d_sum",
    "i_read_comment_7d_sum",
    "i_like_7d_sum",
    "i_click_avatar_7d_sum",
    "i_forward_7d_sum",
    "i_comment_7d_sum",
    "i_follow_7d_sum",
    "i_favorite_7d_sum",
    "c_user_author_read_comment_7d_sum",
)

WECHAT_CATEGORICAL: tuple[tuple[str, str], ...] = (
    # (field name, vocab name) — feedid and the behaviour sequence share the
    # 'feedid' vocabulary (reference wide_and_deep.py:105-106).
    ("userid", "userid"),
    ("feedid", "feedid"),
    ("device", "device"),
    ("authorid", "authorid"),
    ("bgm_song_id", "bgm_song_id"),
    ("bgm_singer_id", "bgm_singer_id"),
)

WECHAT_LABELS: tuple[str, ...] = (
    # Order matches the ETL writer (reference DataGenerator.py:101-109).
    "read_comment",
    "comment",
    "like",
    "click_avatar",
    "forward",
    "follow",
    "favorite",
)

# ETL truncates the behaviour sequence to the last 50 events
# (reference DataGenerator.py:273-276); manual tag lists are short — 24 covers
# the dataset with headroom.
MAX_HIS_SEQ_LEN = 50
MAX_TAG_LEN = 24


def wechat_schema(vocab_sizes: Mapping[str, int] | None = None) -> Schema:
    """Build the WeChat dataset schema.

    Args:
      vocab_sizes: measured vocabulary sizes (number of distinct tokens,
        excluding the PAD/OOV slot).  Defaults to the real dataset's sizes so
        models can be constructed without the raw data present; the data
        pipeline overrides them with the compiled vocab sizes.
    """
    sizes = {
        # Real-dataset cardinalities (dataset/README.md + EDA): ~20k users,
        # ~106k feeds, 2 devices, ~18.8k authors, ~25k songs, ~17.5k singers,
        # ~350 tags.  These are defaults only — see vocab.py.
        "userid": 20000,
        "feedid": 106444,
        "device": 2,
        "authorid": 18789,
        "bgm_song_id": 25160,
        "bgm_singer_id": 17501,
        "manual_tag_id": 353,
    }
    if vocab_sizes:
        sizes.update(vocab_sizes)
    return Schema(
        dense=tuple(DenseFeature(n) for n in WECHAT_DENSE_NAMES),
        categorical=tuple(CategoricalFeature(n, v) for n, v in WECHAT_CATEGORICAL),
        sequence=(
            SequenceFeature("his_read_comment_7d_seq", "feedid", MAX_HIS_SEQ_LEN),
            SequenceFeature("manual_tag_list", "manual_tag_id", MAX_TAG_LEN),
        ),
        cross=(
            CrossFeature(
                "cross_userid_manualtag",
                keys=("userid", "manual_tag_list"),
                num_buckets=100_000,
            ),
        ),
        labels=WECHAT_LABELS,
        vocab_sizes=sizes,
    )


# ---------------------------------------------------------------------------
# The Douban movie dataset schema (reference
# dataset/douban_moviedata_10m/DataGenerator.py — abandoned WIP upstream:
# its vocabulary/feature steps are commented out and it was never run to
# completion.  The column list, separators, min_count thresholds, 360-day
# window, last-20 history and rating>=4 label below all come from that
# file's code and comments (DataGenerator.py:30-172); data/douban.py
# completes that pipeline).
# ---------------------------------------------------------------------------

DOUBAN_DENSE_NAMES: tuple[str, ...] = (
    "u_days_since_last_rating",   # 最近一次评分距今天数差
    "u_last_rating",              # 最近一次评分分数
    "u_rating_360d_max",          # 360天内所有评分的最大值/最小值/平均值
    "u_rating_360d_min",
    "u_rating_360d_mean",
    "c_user_director_rating_360d_max",  # 360天内同一导演评分的 max/min/mean
    "c_user_director_rating_360d_min",
    "c_user_director_rating_360d_mean",
)

DOUBAN_LABELS: tuple[str, ...] = ("rating_ge_4",)  # 大于等于4分为正样本

DOUBAN_MAX_HISTORY = 20  # 只取最近20个评分的电影 (DataGenerator.py:130-131)


def douban_schema(vocab_sizes: Mapping[str, int] | None = None) -> Schema:
    """Build the Douban movie dataset schema (completed WIP parity)."""
    sizes = {
        # Rough douban_moviedata_10m cardinalities — defaults only, the
        # pipeline overrides them with the compiled vocab sizes.
        "USER_MD5": 100000,
        "MOVIE_ID": 60000,
        "DIRECTOR_IDS": 20000,
        "ACTOR_IDS": 60000,
        "GENRES": 40,
        "LANGUAGES": 100,
        "REGIONS": 100,
        "YEAR": 120,
    }
    if vocab_sizes:
        sizes.update(vocab_sizes)
    return Schema(
        dense=tuple(DenseFeature(n) for n in DOUBAN_DENSE_NAMES),
        categorical=(
            CategoricalFeature("USER_MD5", "USER_MD5"),
            CategoricalFeature("MOVIE_ID", "MOVIE_ID"),
            # 导演只取第1个 (DataGenerator.py:103-104); shares the
            # DIRECTOR_IDS vocabulary
            CategoricalFeature("DIRECTOR_ID", "DIRECTOR_IDS"),
            CategoricalFeature("YEAR", "YEAR"),
        ),
        sequence=(
            # last-20 movie history shares the MOVIE_ID table (the WeChat
            # feedid <-> sequence sharing pattern)
            SequenceFeature("HISTORY_MOVIES", "MOVIE_ID", DOUBAN_MAX_HISTORY),
            SequenceFeature("GENRES", "GENRES", 8),
            SequenceFeature("ACTOR_IDS", "ACTOR_IDS", 16),
            SequenceFeature("LANGUAGES", "LANGUAGES", 4),
            SequenceFeature("REGIONS", "REGIONS", 4),
        ),
        cross=(),
        labels=DOUBAN_LABELS,
        vocab_sizes=sizes,
    )


# ---------------------------------------------------------------------------
# The Criteo 1TB click logs in MLPerf's multi-hot form (the recommendation
# benchmark of MLPerf Training, mlcommons/training recommendation_v2/
# torchrec_dlrm: its --num_embeddings_per_feature and --multi_hot_sizes
# flags).  13 integer features (log1p'd, as every DenseFeature here), 26
# categorical features, one click label.  A feature with one id a row is a
# CategoricalFeature; one with a bag of h > 1 ids is a SequenceFeature of
# max_length h, whose bag fills every slot.
# ---------------------------------------------------------------------------

CRITEO_NUM_DENSE = 13

CRITEO_VOCAB_SIZES: tuple[int, ...] = (
    40000000, 39060, 17295, 7424, 20265, 3, 7122, 1543, 63, 40000000, 3067956, 405282, 10,
    2209, 11938, 155, 4, 976, 14, 40000000, 40000000, 40000000, 590152, 12973, 108, 36,
)

CRITEO_HOT_SIZES: tuple[int, ...] = (
    3, 2, 1, 2, 6, 1, 1, 1, 1, 7, 3, 8, 1, 6, 9, 5, 1, 1, 1, 12, 100, 27, 10, 3, 1, 1,
)

CRITEO_LABELS: tuple[str, ...] = ("click",)


def criteo_schema(vocab_sizes: Mapping[str, int] | None = None,
                  hot_sizes: Sequence[int] | None = None) -> Schema:
    """Build the multi-hot Criteo schema: fields ``cat_0`` .. ``cat_25``,
    each with a vocabulary of its own name, and dense ``int_0`` ..
    ``int_12``.

    Args:
      vocab_sizes: rows of each vocabulary (a chip's slice of a row-sharded
        table, or a scaled-down one); defaults to the published sizes.
      hot_sizes: ids a row of each of the 26 fields; defaults to the
        published ``multi_hot_sizes``.
    """
    hots = tuple(CRITEO_HOT_SIZES if hot_sizes is None else hot_sizes)
    if len(hots) != len(CRITEO_VOCAB_SIZES) or min(hots) < 1:
        raise ValueError(f"26 hot sizes of at least 1 expected, got {hots}")
    sizes = {f"cat_{i}": n for i, n in enumerate(CRITEO_VOCAB_SIZES)}
    if vocab_sizes:
        sizes.update(vocab_sizes)
    return Schema(
        dense=tuple(DenseFeature(f"int_{i}") for i in range(CRITEO_NUM_DENSE)),
        categorical=tuple(CategoricalFeature(f"cat_{i}", f"cat_{i}")
                          for i, h in enumerate(hots) if h == 1),
        sequence=tuple(SequenceFeature(f"cat_{i}", f"cat_{i}", h)
                       for i, h in enumerate(hots) if h > 1),
        cross=(),
        labels=CRITEO_LABELS,
        vocab_sizes=sizes,
    )
