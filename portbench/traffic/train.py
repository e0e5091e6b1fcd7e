"""Training traffic: host batches of WeChat-shaped rows, from ``--seed`` only.

The law is that of the port's synthetic stream, rewritten here so that the
yardstick does not move with the program: ids ``floor(n * u**2) + 1`` over
each field's real vocabulary size n (Zipf-like, never the padding id 0);
dense features ``log1p`` of Poisson counts; tag lists geometric in length,
capped at their maximum.  The history's length law is the traffic's own
parameter (``history``): ``{"law": "geometric", "p": ...}`` capped at the
maximum length, or ``{"law": "uniform", "low": ..., "high": ...}``
(inclusive).  Labels are Bernoulli with ``label_rate``.  Sequences are
valid-prefix padded: ids in the first ``length`` slots, 0 after.

Parameters (a workload file's ``traffic``): ``num_batches``, ``history``,
``tags`` (a length law of the same form), ``dense_poisson_lam``,
``label_rate``.
"""

from __future__ import annotations

import numpy as np

STREAM = 1  # the numpy stream of the training batches, beside the seed


def zipf_ids(rng: np.random.Generator, n: int, size) -> np.ndarray:
    return np.minimum(np.floor(n * rng.random(size) ** 2.0).astype(np.int32) + 1, n)


def lengths(rng: np.random.Generator, law: dict, max_length: int, size: int) -> np.ndarray:
    if law["law"] == "geometric":
        out = np.minimum(rng.geometric(p=law["p"], size=size), max_length)
    elif law["law"] == "uniform":
        out = rng.integers(law["low"], law["high"], size=size, endpoint=True)
    else:
        raise ValueError(f"unknown length law {law['law']!r}")
    return out.astype(np.int32)


def sequence(rng: np.random.Generator, n: int, lens: np.ndarray, max_length: int) -> np.ndarray:
    ids = zipf_ids(rng, n, (len(lens), max_length))
    return np.where(np.arange(max_length)[None, :] < lens[:, None], ids, 0).astype(np.int32)


def rows(rng: np.random.Generator, schema: dict, traffic: dict, n: int) -> dict:
    """``n`` rows of every batch column."""
    vocab = schema["vocab_sizes"]
    out = {"dense": np.log1p(rng.poisson(traffic["dense_poisson_lam"],
                                         (n, schema["num_dense"]))).astype(np.float32)}
    for field, v, kind in schema["category_fields"]:
        if kind == "scalar":
            out[field] = zipf_ids(rng, vocab[v], (n,))
    out["feedid"] = zipf_ids(rng, vocab[schema["history"]["vocab"]], (n,))
    for key in ("history", "tags"):
        f = schema[key]
        lens = lengths(rng, traffic[key], f["max_length"], n)
        out[f["field"]] = sequence(rng, vocab[f["vocab"]], lens, f["max_length"])
        out[f["field"] + "_len"] = lens
    out["labels"] = (rng.random((n, schema["num_labels"])) < traffic["label_rate"]
                     ).astype(np.float32)
    return out


def batches(schema: dict, traffic: dict, batch_size: int, seed: int) -> list[dict]:
    """``traffic["num_batches"]`` host batches of ``batch_size`` rows."""
    rng = np.random.default_rng([seed, STREAM])
    return [rows(rng, schema, traffic, batch_size) for _ in range(traffic["num_batches"])]
