"""WeChat Channels ETL: raw CSVs -> vocabularies, features, dataframes, TFRecords.

Re-implements the reference's offline feature engineering
(dataset/wechat_algo_data1/DataGenerator.py) with vectorised pandas (the
reference iterates rows with iterrows/apply) and this framework's native
TFRecord writer (no TensorFlow).  Layout and semantics parity:

  * vocabulary/*.txt — one token per line, first-occurrence order, prefixed
    ids ("feedid_123"); userid/device scoped to date_ in [8, 14]
    (DataGenerator.py:180-204),
  * 7 sliding 7-day windows (feature date_ = window start + 7 in 8..14):
    per-user action sums, per-feed action sums, user read_comment feedid
    sequence truncated to the LAST 50, user x author read_comment sum kept
    only where > 0 (DataGenerator.py:239-338),
  * sample table: user_action date 8..14 left-joined with feed_info and all
    aggregates; dense features log1p'd with NaN -> 0
    (DataGenerator.py:374-377); train = date 8..13, test = date 14,
  * tfrecord/{train,test}.tfrecord — SequenceExample with float context
    dense/labels, bytes context categoricals ('' when missing), bytes
    sequence feature_lists (DataGenerator.py:406-443),
  * idempotence sentinels per stage, matching the reference's
    (VOCAB_FILE_ALREADY DataGenerator.py:172-174, FEATURE_FILE_ALREADY
    229-231, DATAFRAME_ALREADY 352-354, TFRECORD_ALREADY 396-398): a
    crashed run resumes at the first incomplete stage — the features stage
    caches its four aggregate frames as features/*.pkl (reference layout),
    the dataframe stage reads its CSVs back instead of re-joining,
  * ``chunk_dates=True``: low-RAM mode — the 7-window sample join runs one
    feature date at a time, appending to the CSVs and TFRecords, so peak
    memory is one date's join (~1/7 of the split) instead of the whole
    sample table.  The default all-in-RAM join is fine at the reference's
    3.3M rows; chunked mode is for bigger-than-reference reruns.

Own copy of ``recalgorithm_tpu/data/etl.py``: the same raw CSVs give the
same bytes in vocabulary/*.txt and tfrecord/*.tfrecord.  The TFRecords are
written by the native writer alone (runtime/loader.write_sequence_examples):
a failed build or write raises, where the JAX module falls back to its
Python encoder.  pandas is imported inside ``run`` only.
"""

from __future__ import annotations

import os

import numpy as np

from recalgorithm_tpu_torch.features.schema import (
    MAX_HIS_SEQ_LEN,
    WECHAT_DENSE_NAMES,
    WECHAT_LABELS,
)

CATS = ["userid", "feedid", "device", "authorid", "bgm_song_id", "bgm_singer_id"]
ACTION_COLUMNS = [
    "read_comment", "like", "click_avatar", "forward", "comment", "follow",
    "favorite",
]
END_DAY = 14


class WeChatETL:
    """Generate vocabulary/feature/dataframe/tfrecord artifacts.

    Args:
      dataset_dir: directory containing user_action.csv and feed_info.csv.
      out_path: output root (vocabulary/, dataframe/, tfrecord/ created here).
    """

    def __init__(self, dataset_dir: str = "./", out_path: str = "./",
                 chunk_dates: bool = False):
        self.dataset_dir = dataset_dir
        self.out_path = out_path
        self.chunk_dates = chunk_dates
        self.vocab_dir = os.path.join(out_path, "vocabulary")
        self.features_dir = os.path.join(out_path, "features")
        self.dataframe_dir = os.path.join(out_path, "dataframe")
        self.tfrecord_dir = os.path.join(out_path, "tfrecord")

    def run(self) -> None:
        import pandas as pd  # deferred: heavy import

        user_action, feed_info = self._load(pd)
        self._generate_vocabulary(pd, user_action, feed_info)
        frames = self._generate_features(pd, user_action, feed_info)
        if self.chunk_dates:
            self._generate_chunked(pd, user_action, feed_info, frames)
            return
        train_df, test_df = self._generate_dataframe(
            pd, user_action, feed_info, frames
        )
        self._generate_tfrecord(pd, train_df, "train.tfrecord")
        self._generate_tfrecord(pd, test_df, "test.tfrecord")

    @staticmethod
    def _done(dir_: str, sentinel: str) -> bool:
        return os.path.exists(os.path.join(dir_, sentinel))

    @staticmethod
    def _mark(dir_: str, sentinel: str) -> None:
        open(os.path.join(dir_, sentinel), "w").close()

    # -- stages ---------------------------------------------------------------

    def _load(self, pd):
        user_action = pd.read_csv(os.path.join(self.dataset_dir, "user_action.csv"))
        feed_info = pd.read_csv(
            os.path.join(self.dataset_dir, "feed_info.csv"),
            usecols=[
                "feedid", "authorid", "videoplayseconds", "bgm_song_id",
                "bgm_singer_id", "manual_tag_list",
            ],
        )
        # prefix ids (DataGenerator.py:137-159); vectorised
        feed_info["feedid"] = "feedid_" + feed_info["feedid"].astype(str)
        feed_info["authorid"] = "authorid_" + feed_info["authorid"].astype(str)
        for col in ("bgm_song_id", "bgm_singer_id"):
            vals = feed_info[col]
            feed_info[col] = np.where(
                vals.isna(), np.nan,
                col + "_" + vals.astype("Int64").astype(str),
            )
        feed_info["manual_tag_list"] = feed_info["manual_tag_list"].map(
            lambda s: ["manual_tag_id_" + t for t in s.split(";")]
            if isinstance(s, str)
            else np.nan
        )
        user_action["userid"] = "userid_" + user_action["userid"].astype(str)
        user_action["feedid"] = "feedid_" + user_action["feedid"].astype(str)
        user_action["device"] = "device_" + user_action["device"].astype(str)
        return user_action, feed_info

    def _generate_vocabulary(self, pd, user_action, feed_info) -> None:
        os.makedirs(self.vocab_dir, exist_ok=True)
        sentinel = os.path.join(self.vocab_dir, "VOCAB_FILE_ALREADY")
        if os.path.exists(sentinel):
            return
        scope = user_action[user_action["date_"].between(8, 14)]

        def uniq(series):
            return list(dict.fromkeys(series.dropna()))

        vocabs = {
            "userid": uniq(scope["userid"]),
            "device": uniq(scope["device"]),
            "feedid": uniq(feed_info["feedid"]),
            "authorid": uniq(feed_info["authorid"]),
            "bgm_song_id": uniq(feed_info["bgm_song_id"]),
            "bgm_singer_id": uniq(feed_info["bgm_singer_id"]),
        }
        tags: dict[str, None] = {}
        for lst in feed_info["manual_tag_list"]:
            if isinstance(lst, list):
                for t in lst:
                    tags.setdefault(t)
        vocabs["manual_tag_id"] = list(tags)
        for name, toks in vocabs.items():
            with open(os.path.join(self.vocab_dir, name + ".txt"), "w") as f:
                f.write("\n".join(toks) + ("\n" if toks else ""))
        open(sentinel, "w").close()

    def _generate_features(self, pd, user_action, feed_info) -> dict:
        """The four aggregate frames, concatenated over the 7 windows.

        Cached as features/*.pkl (the reference's features/ layout,
        DataGenerator.py:229-231) behind a FEATURE_FILE_ALREADY sentinel:
        a crash in a later stage resumes here with an unpickle, not a
        recompute of the windowed aggregations."""
        os.makedirs(self.features_dir, exist_ok=True)
        names = ("user", "seq", "feed", "cross")
        if self._done(self.features_dir, "FEATURE_FILE_ALREADY"):
            return {
                n: pd.read_pickle(os.path.join(self.features_dir, n + ".pkl"))
                for n in names
            }
        user_arr, seq_arr, feed_arr, cross_arr = [], [], [], []
        cross_base = pd.merge(
            user_action[["userid", "feedid", "date_", "read_comment"]],
            feed_info[["feedid", "authorid"]],
            on="feedid", how="left",
        )
        for start in range(1, END_DAY - 7 + 1):
            date_val = start + 7
            win = user_action[
                (user_action["date_"] >= start) & (user_action["date_"] < start + 7)
            ]
            # user aggregates
            ua = win.groupby("userid")[ACTION_COLUMNS].sum().reset_index()
            ua.columns = ["userid"] + [f"u_{c}_7d_sum" for c in ACTION_COLUMNS]
            ua["date_"] = date_val
            user_arr.append(ua)
            # user read_comment sequence (last 50)
            seq = (
                win[win["read_comment"] == 1]
                .groupby("userid")["feedid"]
                .agg(list)
                .reset_index()
                .rename(columns={"feedid": "his_read_comment_7d_seq"})
            )
            seq["his_read_comment_7d_seq"] = seq["his_read_comment_7d_seq"].map(
                lambda lst: lst[-MAX_HIS_SEQ_LEN:]
            )
            seq["date_"] = date_val
            seq_arr.append(seq)
            # feed aggregates
            fa = win.groupby("feedid")[ACTION_COLUMNS].sum().reset_index()
            fa.columns = ["feedid"] + [f"i_{c}_7d_sum" for c in ACTION_COLUMNS]
            fa["date_"] = date_val
            feed_arr.append(fa)
            # user x author read_comment aggregate, > 0 only
            cw = cross_base[
                (cross_base["date_"] >= start) & (cross_base["date_"] < start + 7)
            ]
            ca = (
                cw.groupby(["userid", "authorid"])["read_comment"]
                .sum()
                .reset_index()
                .rename(columns={"read_comment": "c_user_author_read_comment_7d_sum"})
            )
            ca = ca[ca["c_user_author_read_comment_7d_sum"] > 0]
            ca["date_"] = date_val
            cross_arr.append(ca)
        frames = {
            "user": pd.concat(user_arr, ignore_index=True),
            "seq": pd.concat(seq_arr, ignore_index=True),
            "feed": pd.concat(feed_arr, ignore_index=True),
            "cross": pd.concat(cross_arr, ignore_index=True),
        }
        for n in names:
            frames[n].to_pickle(os.path.join(self.features_dir, n + ".pkl"))
        self._mark(self.features_dir, "FEATURE_FILE_ALREADY")
        return frames

    def _join_window(self, pd, user_action, feed_info, frames, dates):
        """The sample-table join for a subset of feature dates."""
        df = user_action[user_action["date_"].isin(dates)]
        df = pd.merge(df, feed_info, on="feedid", how="left")
        df = pd.merge(df, frames["user"], on=["userid", "date_"], how="left")
        df = pd.merge(df, frames["seq"], on=["userid", "date_"], how="left")
        df = pd.merge(df, frames["feed"], on=["feedid", "date_"], how="left")
        df = pd.merge(
            df, frames["cross"], on=["userid", "authorid", "date_"], how="left"
        )
        for col in WECHAT_DENSE_NAMES:
            # NaN -> 0 then log1p: log1p(0) == 0 == the reference's NaN fill
            # (DataGenerator.py:374-377)
            df[col] = np.log1p(df[col].fillna(0.0).astype(np.float64))
        return df

    def _read_dataframe_csv(self, pd, fname: str):
        """Read a dataframe CSV back with its list columns re-materialised
        (crash-resume path: the join is on disk, only TFRecords remain)."""
        import ast

        def as_list(v):
            # missing cells round-trip as ''/NaN; lists as their repr
            if isinstance(v, str) and v.startswith("["):
                return ast.literal_eval(v)
            return np.nan

        return pd.read_csv(
            os.path.join(self.dataframe_dir, fname),
            converters={"his_read_comment_7d_seq": as_list,
                        "manual_tag_list": as_list},
        )

    def _generate_dataframe(self, pd, user_action, feed_info, frames):
        os.makedirs(self.dataframe_dir, exist_ok=True)
        if self._done(self.dataframe_dir, "DATAFRAME_ALREADY"):
            return (self._read_dataframe_csv(pd, "train.csv"),
                    self._read_dataframe_csv(pd, "test.csv"))
        df = self._join_window(pd, user_action, feed_info, frames,
                               list(range(8, END_DAY + 1)))
        train = df[df["date_"].between(8, 13)]
        test = df[df["date_"] == 14]
        train.to_csv(os.path.join(self.dataframe_dir, "train.csv"), index=False)
        test.to_csv(os.path.join(self.dataframe_dir, "test.csv"), index=False)
        self._mark(self.dataframe_dir, "DATAFRAME_ALREADY")
        return train, test

    def _generate_chunked(self, pd, user_action, feed_info, frames) -> None:
        """Low-RAM dataframe + tfrecord generation, one feature date at a
        time (peak memory: one date's join).  Sentinels are per OUTPUT file
        and written at the end — a crash reruns the whole chunked pass
        (append-mode artifacts cannot be trusted half-written)."""
        os.makedirs(self.dataframe_dir, exist_ok=True)
        os.makedirs(self.tfrecord_dir, exist_ok=True)
        df_done = self._done(self.dataframe_dir, "DATAFRAME_ALREADY")
        tf_done = (self._done(self.tfrecord_dir, "TFRECORD_train_ALREADY")
                   and self._done(self.tfrecord_dir, "TFRECORD_test_ALREADY"))
        if df_done and tf_done:
            return
        for date in range(8, END_DAY + 1):
            df = self._join_window(pd, user_action, feed_info, frames, [date])
            split = "train" if date <= 13 else "test"
            if not df_done:
                csv = os.path.join(self.dataframe_dir, f"{split}.csv")
                first = date == 8 or (split == "test")
                df.to_csv(csv, index=False, mode="w" if first else "a",
                          header=first)
            if not tf_done:
                self._write_tfrecord_native(
                    df, os.path.join(self.tfrecord_dir, f"{split}.tfrecord"),
                    append=(date not in (8, 14)),
                )
        if not df_done:
            self._mark(self.dataframe_dir, "DATAFRAME_ALREADY")
        if not tf_done:
            self._mark(self.tfrecord_dir, "TFRECORD_train_ALREADY")
            self._mark(self.tfrecord_dir, "TFRECORD_test_ALREADY")

    def _generate_tfrecord(self, pd, df, fname: str) -> None:
        os.makedirs(self.tfrecord_dir, exist_ok=True)
        split = fname.split(".")[0]
        sentinel = f"TFRECORD_{split}_ALREADY"
        if self._done(self.tfrecord_dir, sentinel):
            return
        self._write_tfrecord_native(df, os.path.join(self.tfrecord_dir, fname))
        self._mark(self.tfrecord_dir, sentinel)

    def _write_tfrecord_native(self, df, out_path: str, append: bool = False) -> None:
        """Columnar marshal + native parallel encode (loader.
        write_sequence_examples), the bytes of data/tfrecord.py's encoder in
        the (dense, categorical, labels) context order.  Marshals and writes
        in ``loader.CHUNK_ROWS`` df chunks so peak RAM is one chunk's token
        encodings, not the whole split's."""
        from recalgorithm_tpu_torch.runtime import loader

        enc = lambda v: v.encode() if isinstance(v, str) else b""
        for start in range(0, max(len(df), 1), loader.CHUNK_ROWS):
            part = df.iloc[start:start + loader.CHUNK_ROWS]
            cat_cols = [[enc(v) for v in part[c].tolist()] for c in CATS]
            seq_cols = []
            for name in ("his_read_comment_7d_seq", "manual_tag_list"):
                seq_cols.append([
                    [t.encode() for t in row] if isinstance(row, list) else []
                    for row in part[name].tolist()
                ])
            loader.write_sequence_examples(
                out_path,
                list(WECHAT_DENSE_NAMES),
                part[list(WECHAT_DENSE_NAMES)].to_numpy(np.float32),
                CATS, cat_cols,
                list(WECHAT_LABELS),
                part[list(WECHAT_LABELS)].to_numpy(np.float32),
                ["his_read_comment_7d_seq", "manual_tag_list"], seq_cols,
                append=append or start > 0,
            )


def main():
    import argparse

    p = argparse.ArgumentParser(description="WeChat ETL (DataGenerator parity)")
    p.add_argument("--dataset_dir", default="./")
    p.add_argument("--out_path", default="./")
    p.add_argument("--chunk_dates", action="store_true",
                   help="low-RAM mode: join + write one feature date at a "
                        "time (peak memory ~1/7 of the sample table)")
    args = p.parse_args()
    WeChatETL(args.dataset_dir, args.out_path,
              chunk_dates=args.chunk_dates).run()


if __name__ == "__main__":
    main()
