"""Douban movie ETL: ratings/movies CSVs -> vocab, features, TFRecords.

The reference ships this generator ABANDONED (dataset/douban_moviedata_10m/
DataGenerator.py: `_generate_vocabulary_file` never called, both feature
steps commented out, iterrows loops noted as OOM-prone, nothing past
`print(data.columns)` ever ran).  This module COMPLETES it to the spec its
code and comments lay out, vectorised:

  * vocabularies (DataGenerator.py:59-86): per-column separators
    ('/', '/', '/', '|', '|', ' / ', ' / ', '/') and min_count thresholds
    (5, 5, 20, 5, 5, 20, 20, 20) for USER_MD5, MOVIE_ID, GENRES, ACTOR_IDS,
    DIRECTOR_IDS, LANGUAGES, REGIONS, YEAR; counted over the 2019-01..08
    window; YEAR == 0 is an outlier excluded from the vocabulary (L56),
  * features (DataGenerator.py:100-137): DIRECTOR_ID = first listed
    director; HISTORY_MOVIES = the user's last 20 rated movies inside a
    360-day window STRICTLY before the sample's day; the commented-out
    stats implemented too — days since the user's most recent rating, that
    rating's score, and the 360-day max/min/mean of the user's ratings and
    of the user's ratings of the SAME director,
  * samples (module docstring L1-7): label = RATING >= 4; train =
    2019-01..2019-08 ratings, test = 2019-09; the 360-day lookback consumes
    ratings back to 2018,
  * artifacts mirror the WeChat layout: vocabulary/*.txt (insertion order,
    min_count-filtered), dataframe/{train,test}.csv,
    tfrecord/{train,test}.tfrecord (SequenceExample via the native writer),
    with per-stage idempotence sentinels.

Schema counterpart: features/schema.douban_schema; the artifacts feed the
standard pipeline/vocabulary loaders unchanged, and the schema-driven
GenericDNN (models/generic_dnn.py) trains on them through cli.main
--dataset douban.

Own copy of ``recalgorithm_tpu/data/douban.py``: the same raw CSVs give the
same bytes in vocabulary/*.txt and tfrecord/*.tfrecord.  The TFRecords are
written by the native writer alone: a failed build or write raises, where
the JAX module falls back to its Python encoder.  pandas is imported inside
``run`` only.
"""

from __future__ import annotations

import os

import numpy as np

from recalgorithm_tpu_torch.features.schema import (
    DOUBAN_DENSE_NAMES,
    DOUBAN_MAX_HISTORY,
)

# (column, separator, min_count) — DataGenerator.py:67-71
VOCAB_SPEC = [
    ("USER_MD5", "/", 5),
    ("MOVIE_ID", "/", 5),
    ("GENRES", "/", 20),
    ("ACTOR_IDS", "|", 5),
    ("DIRECTOR_IDS", "|", 5),
    ("LANGUAGES", " / ", 20),
    ("REGIONS", " / ", 20),
    ("YEAR", "/", 20),
]
WINDOW_DAYS = 360  # DataGenerator.py:119
CATS = ["USER_MD5", "MOVIE_ID", "DIRECTOR_ID", "YEAR"]
SEQS = [  # (field, source column, separator, max len)
    ("HISTORY_MOVIES", None, None, DOUBAN_MAX_HISTORY),
    ("GENRES", "GENRES", "/", 8),
    ("ACTOR_IDS", "ACTOR_IDS", "|", 16),
    ("LANGUAGES", "LANGUAGES", " / ", 4),
    ("REGIONS", "REGIONS", " / ", 4),
]


class DoubanETL:
    """ratings.csv + movies.csv -> vocabulary / dataframe / tfrecord."""

    def __init__(self, dataset_dir: str = "./", out_path: str = "./"):
        self.dataset_dir = dataset_dir
        self.out_path = out_path
        self.vocab_dir = os.path.join(out_path, "vocabulary")
        self.dataframe_dir = os.path.join(out_path, "dataframe")
        self.tfrecord_dir = os.path.join(out_path, "tfrecord")

    # -- stages ----------------------------------------------------------

    def run(self) -> None:
        import pandas as pd

        ratings, movies = self._load(pd)
        self._generate_vocabulary(pd, ratings, movies)
        samples = self._generate_features(pd, ratings, movies)
        train, test = self._generate_dataframe(pd, samples)
        self._generate_tfrecord(train, "train.tfrecord")
        self._generate_tfrecord(test, "test.tfrecord")

    @staticmethod
    def _done(dir_: str, sentinel: str) -> bool:
        return os.path.exists(os.path.join(dir_, sentinel))

    @staticmethod
    def _mark(dir_: str, sentinel: str) -> None:
        open(os.path.join(dir_, sentinel), "w").close()

    def _load(self, pd):
        ratings = pd.read_csv(os.path.join(self.dataset_dir, "ratings.csv"))
        movies = pd.read_csv(os.path.join(self.dataset_dir, "movies.csv"))
        ratings["RATING_TIME"] = pd.to_datetime(ratings["RATING_TIME"])
        # YEAR == 0 is an outlier and must not reach the vocabulary
        # (DataGenerator.py:56); scraped YEAR cells can be junk strings
        # ('2019(中国大陆)', '未知') — coerce those to NaN too, matching the
        # outlier exclusion rather than crashing the whole ETL on one cell
        year = pd.to_numeric(movies["YEAR"], errors="coerce")
        movies["YEAR"] = np.where(
            year.isna() | (year == 0), np.nan,
            year.fillna(0).astype(np.int64).astype(str),
        )
        return ratings, movies

    def _generate_vocabulary(self, pd, ratings, movies) -> None:
        os.makedirs(self.vocab_dir, exist_ok=True)
        if self._done(self.vocab_dir, "VOCAB_FILE_ALREADY"):
            return
        data = ratings[
            (ratings["RATING_TIME"] >= "2019-01-01")
            & (ratings["RATING_TIME"] < "2019-09-01")
        ]
        data = pd.merge(data, movies, how="left", on="MOVIE_ID")
        from collections import Counter

        for col, sep, min_count in VOCAB_SPEC:
            counter: Counter = Counter()
            for s in data[col]:
                if pd.isnull(s):
                    continue
                counter.update(str(s).split(sep))
            with open(os.path.join(self.vocab_dir, col + ".txt"), "w") as f:
                # Counter preserves insertion order — first-occurrence order
                # on disk, matching the WeChat ETL's convention
                toks = [t for t, c in counter.items() if c >= min_count]
                f.write("\n".join(toks) + ("\n" if toks else ""))
        self._mark(self.vocab_dir, "VOCAB_FILE_ALREADY")

    def _generate_features(self, pd, ratings, movies):
        """The per-sample feature frame for ratings >= 2019-01-01.

        Vectorised per USER (numpy searchsorted windows over the user's
        time-sorted rating arrays) instead of the reference's per-ROW
        iterrows loops (its own comments flag them as OOM-prone,
        DataGenerator.py:101,116).  Cached as features/samples.pkl behind a
        FEATURE_FILE_ALREADY sentinel — this is the ETL's most expensive
        stage, and a crash in a later stage must resume with an unpickle,
        not a recompute (same contract as WeChatETL._generate_features)."""
        features_dir = os.path.join(self.out_path, "features")
        os.makedirs(features_dir, exist_ok=True)
        cache = os.path.join(features_dir, "samples.pkl")
        if self._done(features_dir, "FEATURE_FILE_ALREADY"):
            return pd.read_pickle(cache)
        data = ratings[ratings["RATING_TIME"] >= "2018-01-01"].copy()
        data = pd.merge(data, movies, how="left", on="MOVIE_ID")
        data["DIRECTOR_ID"] = data["DIRECTOR_IDS"].map(
            lambda s: str(s).split("|")[0] if not pd.isnull(s) else np.nan
        )
        data.sort_values(["USER_MD5", "RATING_TIME"], inplace=True)
        day = (data["RATING_TIME"].values.astype("datetime64[D]")
               .astype(np.int64))
        data["_day"] = day
        is_sample = data["RATING_TIME"] >= pd.Timestamp("2019-01-01")

        n = len(data)
        hist = np.empty(n, dtype=object)
        dense = {name: np.zeros(n, np.float32) for name in DOUBAN_DENSE_NAMES}

        ratings_arr = data["RATING"].to_numpy(np.float32)
        movies_arr = data["MOVIE_ID"].astype(str).to_numpy()
        directors_arr = data["DIRECTOR_ID"].astype(str).to_numpy()
        days_arr = data["_day"].to_numpy()
        sample_arr = is_sample.to_numpy()

        pos = 0
        # group sizes without materialising per-user sub-DataFrames: data is
        # already sorted by (USER_MD5, RATING_TIME)
        sizes = data.groupby("USER_MD5", sort=False).size().to_numpy()
        for m in sizes:
            m = int(m)
            sl = slice(pos, pos + m)
            d = days_arr[sl]
            r = ratings_arr[sl]
            mv = movies_arr[sl]
            dr = directors_arr[sl]
            smp = sample_arr[sl]
            # strictly-before window [day - 360, day) (DataGenerator.py:
            # 124-126: RATING_DAY < cur & cur - RATING_DAY <= 360d)
            starts = np.searchsorted(d, d - WINDOW_DAYS, side="left")
            ends = np.searchsorted(d, d, side="left")
            for i in np.nonzero(smp)[0]:
                s, e = int(starts[i]), int(ends[i])
                j = pos + i
                if e > s:
                    w = r[s:e]
                    hist[j] = list(mv[s:e][-DOUBAN_MAX_HISTORY:])
                    dense["u_days_since_last_rating"][j] = d[i] - d[e - 1]
                    dense["u_last_rating"][j] = r[e - 1]
                    dense["u_rating_360d_max"][j] = w.max()
                    dense["u_rating_360d_min"][j] = w.min()
                    dense["u_rating_360d_mean"][j] = w.mean()
                    dm = dr[s:e] == dr[i]
                    if dr[i] != "nan" and dm.any():
                        wd = w[dm]
                        dense["c_user_director_rating_360d_max"][j] = wd.max()
                        dense["c_user_director_rating_360d_min"][j] = wd.min()
                        dense["c_user_director_rating_360d_mean"][j] = wd.mean()
                else:
                    hist[j] = []
            pos += m

        out = data[sample_arr].copy()
        out["HISTORY_MOVIES"] = hist[sample_arr]
        for name in DOUBAN_DENSE_NAMES:
            out[name] = dense[name][sample_arr]
        out["rating_ge_4"] = (out["RATING"] >= 4).astype(np.float32)
        for field, col, sep, max_len in SEQS[1:]:
            out[field] = out[col].map(
                lambda s, sep=sep, k=max_len: (
                    str(s).split(sep)[:k] if not pd.isnull(s) else []
                )
            )
        out.to_pickle(cache)
        self._mark(features_dir, "FEATURE_FILE_ALREADY")
        return out

    def _generate_dataframe(self, pd, samples):
        os.makedirs(self.dataframe_dir, exist_ok=True)
        cols = (["USER_MD5", "MOVIE_ID", "DIRECTOR_ID", "YEAR",
                 "RATING", "RATING_TIME", "rating_ge_4"]
                + list(DOUBAN_DENSE_NAMES) + [f for f, *_ in SEQS])
        train = samples[samples["RATING_TIME"] < "2019-09-01"][cols]
        test = samples[(samples["RATING_TIME"] >= "2019-09-01")
                       & (samples["RATING_TIME"] < "2019-10-01")][cols]
        if not self._done(self.dataframe_dir, "DATAFRAME_ALREADY"):
            train.to_csv(os.path.join(self.dataframe_dir, "train.csv"),
                         index=False)
            test.to_csv(os.path.join(self.dataframe_dir, "test.csv"),
                        index=False)
            self._mark(self.dataframe_dir, "DATAFRAME_ALREADY")
        return train, test

    def _generate_tfrecord(self, df, fname: str) -> None:
        os.makedirs(self.tfrecord_dir, exist_ok=True)
        sentinel = f"TFRECORD_{fname.split('.')[0]}_ALREADY"
        if self._done(self.tfrecord_dir, sentinel):
            return
        out_path = os.path.join(self.tfrecord_dir, fname)
        enc = lambda v: str(v).encode() if not _isnull(v) else b""
        from recalgorithm_tpu_torch.runtime import loader

        # marshalled in loader.CHUNK_ROWS-row chunks so peak RAM is one
        # chunk's byte encodings, not the whole split's (the reference's
        # version was OOM-prone)
        for start in range(0, max(len(df), 1), loader.CHUNK_ROWS):
            part = df.iloc[start:start + loader.CHUNK_ROWS]
            seq_cols = [
                [[t.encode() for t in row] if isinstance(row, list) else []
                 for row in part[f].tolist()]
                for f, *_ in SEQS
            ]
            loader.write_sequence_examples(
                out_path,
                list(DOUBAN_DENSE_NAMES),
                part[list(DOUBAN_DENSE_NAMES)].to_numpy(np.float32),
                CATS, [[enc(v) for v in part[c].tolist()] for c in CATS],
                ["rating_ge_4"],
                part[["rating_ge_4"]].to_numpy(np.float32),
                [f for f, *_ in SEQS], seq_cols,
                append=start > 0,
            )
        self._mark(self.tfrecord_dir, sentinel)


def _isnull(v) -> bool:
    return v is None or (isinstance(v, float) and v != v) or str(v) == "nan"


def main():
    import argparse

    p = argparse.ArgumentParser(
        description="Douban movie ETL (completed reference WIP)"
    )
    p.add_argument("--dataset_dir", default="./")
    p.add_argument("--out_path", default="./")
    args = p.parse_args()
    DoubanETL(args.dataset_dir, args.out_path).run()


if __name__ == "__main__":
    main()
