"""Shared helpers of the port's data tests: a reference-format split with
the reader's edge cases, and the JAX package's native library built before
its first use."""

import os
import subprocess

import numpy as np

from recalgorithm_tpu_torch.data import tfrecord

VOCAB_TOKENS = {
    "userid": [f"userid_{i}" for i in range(5)],
    "feedid": [f"feedid_{i}" for i in range(9)],
    "device": ["device_1", "device_2"],
    "authorid": [f"authorid_{i}" for i in range(4)],
    "bgm_song_id": [f"bgm_song_id_{i}" for i in range(3)],
    "bgm_singer_id": [f"bgm_singer_id_{i}" for i in range(3)],
    "manual_tag_id": [f"manual_tag_id_{i}" for i in range(6)],
}


def ensure_jax_native():
    """Build the JAX package's reader and writer libraries under a private
    name and rename them into place before its loader first runs: its own
    build writes the final path directly, which test workers starting
    together could load half-written."""
    from recalgorithm_tpu.runtime import loader as jl

    for src, so in ((jl._SRC, jl._SO), (jl._SRC_W, jl._SO_W)):
        if os.path.exists(so) and os.path.getmtime(so) >= os.path.getmtime(src):
            continue
        tmp = f"{so}.{os.getpid()}.tmp"
        subprocess.run(["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
                        "-o", tmp, src], check=True, capture_output=True)
        os.replace(tmp, so)


def write_split(root, n, seed=0, name="train.tfrecord", vocab=True):
    """A SequenceExample split of ``n`` rows in the WeChat layout under
    ``root``: missing and out-of-vocabulary tokens, a missing dense value,
    empty, absent and over-long sequences.  Returns (path, vocab_dir)."""
    from recalgorithm_tpu_torch.features.schema import wechat_schema

    schema = wechat_schema()
    vocab_dir = root / "vocabulary"
    if vocab:
        vocab_dir.mkdir(exist_ok=True)
        for vname, toks in VOCAB_TOKENS.items():
            (vocab_dir / f"{vname}.txt").write_text("\n".join(toks) + "\n")
    rng = np.random.default_rng(seed)
    payloads = []
    for i in range(n):
        context = {d: ("float", [float(rng.random())]) for d in schema.dense_names
                   if not (i % 7 == 2 and d == "videoplayseconds")}
        for f in schema.categorical:
            k = int(rng.integers(0, len(VOCAB_TOKENS[f.vocab]) + 1))
            tok = f"{f.vocab}_{k}" if f.vocab != "device" else f"device_{k}"
            if i % 5 == 3:
                tok = ""
            context[f.name] = ("bytes", [tok.encode()])
        for label in schema.labels:
            context[label] = ("float", [float(rng.integers(0, 2))])
        seq_len = int(rng.integers(0, 60))  # over MAX_HIS_SEQ_LEN (50) at times
        fl = {"his_read_comment_7d_seq": (
            "bytes", [f"feedid_{int(rng.integers(0, 11))}".encode() for _ in range(seq_len)])}
        if i % 4:
            fl["manual_tag_list"] = ("bytes", [f"manual_tag_id_{int(rng.integers(0, 7))}".encode()
                                               for _ in range(int(rng.integers(0, 4)))])
        payloads.append(tfrecord.encode_sequence_example(context, fl))
    path = root / name
    tfrecord.write_records(str(path), payloads)
    return str(path), str(vocab_dir)


def write_raw_wechat(root):
    """tests/test_etl.py's raw user_action.csv / feed_info.csv under root."""
    import pandas as pd

    rng = np.random.default_rng(0)
    n_users, n_feeds, n_authors = 6, 12, 4
    rows = []
    for date in range(1, 15):
        for _ in range(30):
            u = rng.integers(0, n_users)
            f = rng.integers(0, n_feeds)
            acts = (rng.random(7) < 0.25).astype(int)
            rows.append(dict(userid=u, feedid=f, date_=date, device=int(rng.integers(1, 3)),
                             read_comment=acts[0], like=acts[1], click_avatar=acts[2],
                             forward=acts[3], comment=acts[4], follow=acts[5],
                             favorite=acts[6]))
    pd.DataFrame(rows).to_csv(root / "user_action.csv", index=False)
    feeds = []
    for f in range(n_feeds):
        feeds.append(dict(
            feedid=f, authorid=int(f % n_authors),
            videoplayseconds=float(rng.integers(5, 60)),
            bgm_song_id=(np.nan if f % 5 == 0 else int(f % 7)),
            bgm_singer_id=(np.nan if f % 4 == 0 else int(f % 3)),
            manual_tag_list=(np.nan if f % 6 == 0 else ";".join(
                str(t) for t in rng.choice(9, size=rng.integers(1, 4), replace=False)))))
    pd.DataFrame(feeds).to_csv(root / "feed_info.csv", index=False)
    return root


def write_raw_douban(root):
    """tests/test_douban.py's raw ratings.csv / movies.csv under root."""
    import pandas as pd

    rng = np.random.default_rng(0)
    n_users, n_movies, n_directors, n_actors = 40, 120, 18, 50
    user_mean = rng.normal(3.5, 0.6, n_users)
    movie_q = rng.normal(0.0, 0.7, n_movies)
    genres = ["剧情", "喜剧", "动作", "爱情", "科幻", "悬疑"]
    langs = ["汉语普通话", "英语", "日语"]
    regions = ["中国大陆", "美国", "日本"]
    movies = []
    for m in range(n_movies):
        movies.append(dict(
            MOVIE_ID=m,
            GENRES="/".join(sorted(set(rng.choice(genres, size=rng.integers(1, 3),
                                                  replace=False)))),
            ACTOR_IDS="|".join(f"actor{a}" for a in rng.choice(
                n_actors, size=rng.integers(1, 4), replace=False)),
            DIRECTOR_IDS="|".join(f"dir{d}" for d in rng.choice(
                n_directors, size=rng.integers(1, 3), replace=False)),
            LANGUAGES=" / ".join(rng.choice(langs, size=1)),
            REGIONS=" / ".join(rng.choice(regions, size=1)),
            YEAR=0 if m == 7 else int(1990 + m % 10)))
    pd.DataFrame(movies).to_csv(root / "movies.csv", index=False)
    rows = []
    start = np.datetime64("2018-01-01")
    for u in range(n_users):
        n = rng.integers(30, 45)
        days = np.sort(rng.integers(0, 638, size=n))
        for d in days:
            m = int(rng.integers(0, n_movies))
            r = np.clip(round(user_mean[u] + movie_q[m] + rng.normal(0, 0.7)), 1, 5)
            rows.append(dict(USER_MD5=f"u{u:03d}", MOVIE_ID=m, RATING=int(r),
                             RATING_TIME=str(start + np.timedelta64(int(d), "D")) + " 12:00:00"))
    pd.DataFrame(rows).to_csv(root / "ratings.csv", index=False)
    return root
