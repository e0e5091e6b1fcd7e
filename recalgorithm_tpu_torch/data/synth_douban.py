"""moviedata-10m-shaped synthetic RAW CSVs (ratings.csv / movies.csv).

The reference's douban generator (dataset/douban_moviedata_10m/
DataGenerator.py) was abandoned before it ever ran at the dataset's real
size — its own comments flag the per-row loops as OOM-prone (L101, L116).
data/douban.py completes that ETL; THIS module generates raw CSVs at the
10M-rating shape so the completed ETL can be proven at the scale the name
promises, the same role data/synth_raw.py plays for the WeChat ETL.

Own copy of ``recalgorithm_tpu/data/synth_douban.py``: the same config and
seed write the same bytes, through plain file writes where the JAX module
uses pandas, so it needs no pandas.

Layout matches the fixture in tests/test_douban.py and the real dataset's
columns:

  * ``ratings.csv`` — USER_MD5 (32-hex-char tokens, the string-heavy sort/
    groupby load the real dataset carries), MOVIE_ID, RATING (1..5),
    RATING_TIME ("YYYY-MM-DD HH:MM:SS"), spread over 2018-01-01..2019-09-30
    so the ETL's 360-day lookback, the 2019-01..08 train window and the
    2019-09 test month are all populated,
  * ``movies.csv`` — MOVIE_ID, GENRES ('/'-joined), ACTOR_IDS ('|'),
    DIRECTOR_IDS ('|', first = main director), LANGUAGES (' / '),
    REGIONS (' / '), YEAR (with the ==0 outliers the reference excludes,
    DataGenerator.py:56).

Planted signal: RATING = clip(round(user_mean + movie_quality +
director_quality + noise), 1, 5) — so rating_ge_4 is predictable from the
id embeddings, the 360-day user-rating stats AND the same-director stats
the ETL computes, mirroring how the WeChat generator plants activity x
quality.

Scale knob: ``scale=1.0`` ≈ 10M ratings / 200k users / 60k movies;
smaller scales shrink proportionally.  Generation is vectorised (token
tables indexed per row — no per-row Python formatting) and written in
chunks (bounded RAM).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

GENRES = [f"genre{i:02d}" for i in range(40)]
LANGUAGES = [f"lang{i:02d}" for i in range(30)]
REGIONS = [f"region{i:02d}" for i in range(60)]
FIRST_DAY = np.datetime64("2018-01-01")
N_DAYS = 638  # .. 2019-09-30 (train 2019-01..08, test 2019-09)


@dataclasses.dataclass
class DoubanRawConfig:
    scale: float = 1.0
    seed: int = 0
    n_ratings: int = 10_000_000
    n_users: int = 200_000
    n_movies: int = 60_000
    n_directors: int = 20_000
    n_actors: int = 60_000

    def scaled(self, field: str) -> int:
        return max(8, int(getattr(self, field) * self.scale))


def _zipf(rng: np.random.Generator, size, n: int, power: float = 2.0):
    """Skewed ids in [0, n): head items vastly more popular than the tail."""
    return np.minimum(np.floor(n * rng.random(size) ** power), n - 1).astype(
        np.int64
    )


def generate_douban_csvs(
    out_dir: str, config: DoubanRawConfig | None = None
) -> dict:
    """Write ratings.csv + movies.csv; returns generation stats."""
    cfg = config or DoubanRawConfig()
    rng = np.random.default_rng(cfg.seed)
    os.makedirs(out_dir, exist_ok=True)
    n_users = cfg.scaled("n_users")
    n_movies = cfg.scaled("n_movies")
    n_directors = cfg.scaled("n_directors")
    n_actors = cfg.scaled("n_actors")
    n_ratings = cfg.scaled("n_ratings")

    # ---- movies.csv (one pass, small)
    movie_director = _zipf(rng, n_movies, n_directors)  # main director
    years = (1930 + _zipf(rng, n_movies, 90, power=0.35)).astype(object)
    years[rng.random(n_movies) < 0.002] = 0  # the outlier the ETL excludes
    rows = {
        "MOVIE_ID": [f"m{m:06d}" for m in range(n_movies)],
        "GENRES": [], "ACTOR_IDS": [], "DIRECTOR_IDS": [],
        "LANGUAGES": [], "REGIONS": [], "YEAR": list(years),
    }
    for m in range(n_movies):
        g = rng.choice(len(GENRES), size=rng.integers(1, 4), replace=False)
        rows["GENRES"].append("/".join(GENRES[i] for i in sorted(g)))
        a = _zipf(rng, rng.integers(1, 6), n_actors)
        rows["ACTOR_IDS"].append("|".join(f"actor{i:05d}" for i in a))
        extra = _zipf(rng, rng.integers(0, 2), n_directors)
        ds = [movie_director[m], *extra]
        rows["DIRECTOR_IDS"].append("|".join(f"dir{i:05d}" for i in ds))
        l = rng.choice(len(LANGUAGES), size=rng.integers(1, 3), replace=False)
        rows["LANGUAGES"].append(" / ".join(LANGUAGES[i] for i in sorted(l)))
        r = rng.choice(len(REGIONS), size=rng.integers(1, 3), replace=False)
        rows["REGIONS"].append(" / ".join(REGIONS[i] for i in sorted(r)))
    cols = list(rows)
    with open(os.path.join(out_dir, "movies.csv"), "w") as f:
        f.write(",".join(cols) + "\n")
        for m in range(n_movies):
            f.write(",".join(str(rows[c][m]) for c in cols) + "\n")

    # ---- ratings.csv (vectorised, chunked writes)
    user_mean = rng.normal(3.3, 0.6, n_users)
    movie_q = rng.normal(0.0, 0.5, n_movies)
    director_q = rng.normal(0.0, 0.4, n_directors)

    # heavy-tailed per-user rating counts (lognormal), normalised to total
    raw = rng.lognormal(0.0, 1.1, n_users)
    counts = np.maximum(1, np.round(raw * n_ratings / raw.sum())).astype(
        np.int64
    )
    total = int(counts.sum())

    # token tables indexed per row — no per-row Python formatting
    user_tokens = np.array(
        [f"{rng_hash(u):032x}" for u in range(n_users)], dtype=object
    )
    movie_tokens = np.array(rows["MOVIE_ID"], dtype=object)
    day_tokens = np.array(
        [str(FIRST_DAY + np.timedelta64(d, "D")) + " 12:00:00"
         for d in range(N_DAYS)], dtype=object
    )

    users = np.repeat(np.arange(n_users), counts)
    days = rng.integers(0, N_DAYS, size=total)
    movies_idx = _zipf(rng, total, n_movies)
    logit = (user_mean[users] + movie_q[movies_idx]
             + director_q[movie_director[movies_idx]]
             + rng.normal(0.0, 0.7, total))
    ratings = np.clip(np.round(logit), 1, 5).astype(np.int64)

    path = os.path.join(out_dir, "ratings.csv")
    chunk = 2_000_000
    pos_ge4 = 0
    with open(path, "w") as f:
        f.write("USER_MD5,MOVIE_ID,RATING,RATING_TIME\n")
        for start in range(0, total, chunk):
            sl = slice(start, min(start + chunk, total))
            f.write("".join(
                f"{u},{m},{r},{t}\n" for u, m, r, t in zip(
                    user_tokens[users[sl]], movie_tokens[movies_idx[sl]],
                    ratings[sl].tolist(), day_tokens[days[sl]])))
            pos_ge4 += int((ratings[sl] >= 4).sum())
    return {
        "rows": total,
        "n_users": n_users,
        "n_movies": n_movies,
        "rating_ge_4_rate": round(pos_ge4 / max(total, 1), 4),
    }


def rng_hash(u: int) -> int:
    """Deterministic 128-bit pseudo-md5 of a user index (splitmix-style) —
    32-hex-char USER_MD5 tokens without hashlib's per-call overhead."""
    x = (u + 0x9E3779B97F4A7C15) & (2**64 - 1)
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & (2**64 - 1)
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & (2**64 - 1)
    x ^= x >> 31
    y = (u * 0xD1B54A32D192ED03 + 0x8CB92BA72F3D8DD7) & (2**64 - 1)
    y = ((y ^ (y >> 29)) * 0xFF51AFD7ED558CCD) & (2**64 - 1)
    y ^= y >> 33
    return (x << 64) | y


def main():
    import argparse
    import json
    import time

    p = argparse.ArgumentParser(
        description="moviedata-10m-shaped synthetic raw douban CSVs"
    )
    p.add_argument("--out_dir", required=True)
    p.add_argument("--scale", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()
    t0 = time.time()
    stats = generate_douban_csvs(
        args.out_dir, DoubanRawConfig(scale=args.scale, seed=args.seed)
    )
    stats["wall_s"] = round(time.time() - t0, 2)
    print(json.dumps(stats))


if __name__ == "__main__":
    main()
