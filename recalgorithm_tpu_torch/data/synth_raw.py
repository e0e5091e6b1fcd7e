"""Reference-shaped synthetic RAW CSVs (user_action.csv / feed_info.csv).

The reference's entire acceptance surface is AUC on the WeChat competition
CSVs (reference README.md:18-43), which cannot ship with this repo.  This
module generates raw CSVs with the SAME layout, cardinalities and statistics
(reference dataset/README.md:8, DataGenerator.py:129-135):

  * ``user_action.csv`` — userid, feedid, date_ (1..14), device, 7 binary
    action columns; row counts per day sized so dates 8..13 ≈ the reference's
    3.32M-row train split and date 14 ≈ its 609k-row test split at scale=1,
  * ``feed_info.csv`` — feedid, authorid, videoplayseconds, bgm_song_id /
    bgm_singer_id (with NaNs), manual_tag_list (semicolon-joined, with NaNs),

plus a planted signal (per-user activity x per-feed quality logits, Zipf
exposure) so models trained on the ETL'd output exhibit the reference's
qualitative behaviour: AUC well above 0.5, per-user GAUC below global AUC,
low positive rates per action.  It feeds data/etl.py where the
competition CSVs are not at hand.

Own copy of ``recalgorithm_tpu/data/synth_raw.py`` (numpy only): the same
config and seed write the same bytes.

Scale knob: ``scale=1.0`` reproduces reference-sized artifacts (~7.4M action
rows, 106,444 feeds, ~20k users); smaller scales shrink everything
proportionally.  Generation is vectorised and chunked per day (bounded RAM).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

ACTION_COLUMNS = [
    "read_comment", "like", "click_avatar", "forward", "comment", "follow",
    "favorite",
]
# Base action rates, roughly the WeChat EDA's behaviour rates (EDA.ipynb):
# read_comment is the densest label (~4%), follow/favorite the sparsest.
ACTION_BASE_LOGIT = {
    "read_comment": -3.2, "like": -3.4, "click_avatar": -4.0,
    "forward": -4.6, "comment": -5.3, "follow": -5.0, "favorite": -4.8,
}


@dataclasses.dataclass
class RawConfig:
    scale: float = 1.0
    seed: int = 0
    n_users: int = 20000
    n_feeds: int = 106444
    n_authors: int = 18000
    n_tags: int = 350
    n_songs: int = 25000
    n_singers: int = 17000
    rows_per_day: int = 530000  # dates 8..13 -> ~3.2M train rows at scale 1
    days: int = 14

    def scaled(self, field: str) -> int:
        return max(4, int(getattr(self, field) * self.scale))


def _zipf(rng: np.random.Generator, size, n: int, power: float = 2.0):
    """Skewed ids in [0, n): head items vastly more popular than the tail."""
    return np.minimum(np.floor(n * rng.random(size) ** power), n - 1).astype(
        np.int64
    )


def generate_raw_csvs(out_dir: str, config: RawConfig | None = None) -> dict:
    """Write user_action.csv + feed_info.csv; returns the generation stats.

    Signal model: p(action) = sigmoid(base + user_activity + feed_quality
    + device_offset), with activity/quality ~ N(0, 0.7) — so the ETL's
    7-day window counts, the id embeddings AND the history sequence all
    carry real predictive signal, as in the actual dataset.
    """
    cfg = config or RawConfig()
    rng = np.random.default_rng(cfg.seed)
    os.makedirs(out_dir, exist_ok=True)
    n_users = cfg.scaled("n_users")
    n_feeds = cfg.scaled("n_feeds")
    n_authors = cfg.scaled("n_authors")
    n_tags = cfg.scaled("n_tags")
    rows_per_day = cfg.scaled("rows_per_day")

    # ---- feed_info.csv (one pass, small)
    feed_author = _zipf(rng, n_feeds, n_authors)
    videoplayseconds = np.clip(
        np.exp(rng.normal(2.8, 0.8, n_feeds)), 5, 60
    ).astype(np.int64)
    song = _zipf(rng, n_feeds, cfg.scaled("n_songs")).astype(object)
    singer = _zipf(rng, n_feeds, cfg.scaled("n_singers")).astype(object)
    song[rng.random(n_feeds) < 0.25] = ""   # NaN share as in the real feed_info
    singer[rng.random(n_feeds) < 0.22] = ""
    n_feed_tags = 1 + _zipf(rng, n_feeds, 4, power=1.0)
    tag_lists = []
    for i in range(n_feeds):
        if rng.random() < 0.05:
            tag_lists.append("")
            continue
        tags = np.unique(_zipf(rng, int(n_feed_tags[i]), n_tags))
        tag_lists.append(";".join(str(t) for t in tags))
    with open(os.path.join(out_dir, "feed_info.csv"), "w") as f:
        f.write("feedid,authorid,videoplayseconds,bgm_song_id,"
                "bgm_singer_id,manual_tag_list\n")
        for i in range(n_feeds):
            f.write(f"{i},{feed_author[i]},{videoplayseconds[i]},"
                    f"{song[i]},{singer[i]},{tag_lists[i]}\n")

    # ---- user_action.csv (chunked per day, bounded RAM)
    user_activity = rng.normal(0.0, 0.7, n_users)
    feed_quality = rng.normal(0.0, 0.7, n_feeds)
    total = 0
    positives = {c: 0 for c in ACTION_COLUMNS}
    path = os.path.join(out_dir, "user_action.csv")
    with open(path, "w") as f:
        f.write("userid,feedid,date_,device," + ",".join(ACTION_COLUMNS) + "\n")
        for date in range(1, cfg.days + 1):
            n = rows_per_day
            users = _zipf(rng, n, n_users)
            feeds = _zipf(rng, n, n_feeds)
            device = rng.integers(1, 3, n)
            base_logit = (
                user_activity[users] + feed_quality[feeds]
                + np.where(device == 2, 0.15, 0.0)
            )
            cols = {}
            for c in ACTION_COLUMNS:
                p = 1.0 / (1.0 + np.exp(-(base_logit + ACTION_BASE_LOGIT[c])))
                cols[c] = (rng.random(n) < p).astype(np.int8)
                positives[c] += int(cols[c].sum())
            total += n
            # one formatted write per day: ~10x the speed of row loops
            import io

            buf = io.StringIO()
            act = np.stack([cols[c] for c in ACTION_COLUMNS], axis=1)
            for i in range(n):
                buf.write(f"{users[i]},{feeds[i]},{date},{device[i]},"
                          + ",".join(map(str, act[i])) + "\n")
            f.write(buf.getvalue())
    return {
        "rows": total,
        "rows_train_window": rows_per_day * min(6, cfg.days),
        "n_users": n_users,
        "n_feeds": n_feeds,
        "positive_rate": {
            c: positives[c] / max(total, 1) for c in ACTION_COLUMNS
        },
    }


def main():
    import argparse
    import json
    import time

    p = argparse.ArgumentParser(
        description="reference-shaped synthetic raw WeChat CSVs"
    )
    p.add_argument("--out_dir", required=True)
    p.add_argument("--scale", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()
    t0 = time.time()
    stats = generate_raw_csvs(
        args.out_dir, RawConfig(scale=args.scale, seed=args.seed)
    )
    stats["wall_s"] = round(time.time() - t0, 2)
    print(json.dumps(stats))


if __name__ == "__main__":
    main()
