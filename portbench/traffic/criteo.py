"""DLRM-DCNv2 training traffic: host batches of multi-hot Criteo rows, from
``--seed`` only.

Each of the 26 features has exactly its configured hot count of ids a row
(``multi_hot_sizes``; MLPerf's multi-hot Criteo fills every bag), drawn by
the training traffic's law (``traffic/train.py``'s ``zipf_ids``):
``floor(n * u**2) + 1`` over the ``n`` rows the configuration holds of the
feature's table (a chip's slice of a row-sharded table: the ids this chip's
shard would be sent).  A feature with one id a row is a (B,) column, one
with a bag of h ids a (B, h) column beside a ``<name>_len`` column of h.
The 13 dense features are ``log1p`` of Poisson counts, and the click label
is Bernoulli with ``label_rate``.

Parameters (a workload file's ``traffic``): ``num_batches``,
``dense_poisson_lam``, ``label_rate``.
"""

from __future__ import annotations

import numpy as np

from portbench.traffic.train import STREAM, zipf_ids


def rows(rng: np.random.Generator, cfg: dict, traffic: dict, n: int) -> dict:
    """``n`` rows of every batch column."""
    out = {"dense": np.log1p(rng.poisson(traffic["dense_poisson_lam"],
                                         (n, cfg["num_dense"]))).astype(np.float32)}
    for i, (held, hot) in enumerate(zip(cfg["num_embeddings_per_feature"],
                                        cfg["multi_hot_sizes"])):
        if hot == 1:
            out[f"cat_{i}"] = zipf_ids(rng, held, (n,))
        else:
            out[f"cat_{i}"] = zipf_ids(rng, held, (n, hot))
            out[f"cat_{i}_len"] = np.full((n,), hot, np.int32)
    out["labels"] = (rng.random((n, 1)) < traffic["label_rate"]).astype(np.float32)
    return out


def batches(cfg: dict, traffic: dict, batch_size: int, seed: int) -> list[dict]:
    """``traffic["num_batches"]`` host batches of ``batch_size`` rows."""
    rng = np.random.default_rng([seed, STREAM])
    return [rows(rng, cfg, traffic, batch_size) for _ in range(traffic["num_batches"])]
