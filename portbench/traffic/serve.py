"""Serving traffic: an open loop of ranking requests, from ``--seed`` only.

A request is one user (userid, device, the behaviour history) with k
candidate items (feedid, authorid, the song and singer, the tag list and the
dense features).  Ids, lengths and dense features follow the training
traffic's law (``traffic/train.py``).

Every seed gets the same work in another order: N = rate x seconds requests,
whose gaps are the N quantiles (i + 1/2) / N of the exponential law of the
rate (Poisson arrivals) and whose k are spread evenly over [low, high], each
set shuffled by the seed; the gaps are scaled so that the last request
arrives at ``seconds``.

Parameters (a workload file's ``traffic``): ``rate_rps``, ``candidates``
(``low``, ``high``), ``history`` and ``tags`` (length laws),
``dense_poisson_lam``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from portbench.traffic.train import lengths, sequence, zipf_ids

STREAM = 2
USER_FIELDS = ("userid", "device")


@dataclasses.dataclass
class Requests:
    arrivals: np.ndarray   # (N,) seconds after the window opens
    offsets: np.ndarray    # (N + 1,) each request's candidates
    user: dict             # per request: userid, device, history, its length
    item: dict             # per candidate: the rest of the columns
    history: str           # the history column's name

    def __len__(self) -> int:
        return len(self.arrivals)

    @property
    def candidates(self) -> int:
        return int(self.offsets[-1])

    def features(self, r: int) -> list[dict]:
        """Request ``r``'s candidates, one feature dict each (what a client
        hands ``BatchingPredictor.predict_async``)."""
        shared = {k: v[r] for k, v in self.user.items()}
        return [{**shared, **{k: v[c] for k, v in self.item.items()}}
                for c in range(self.offsets[r], self.offsets[r + 1])]

    def rows(self, idx: np.ndarray) -> dict:
        """The batch columns of candidates ``idx``."""
        req = np.searchsorted(self.offsets, idx, side="right") - 1
        return {**{k: v[req] for k, v in self.user.items()},
                **{k: v[idx] for k, v in self.item.items()}}


def spread(n: int, low: int, high: int) -> np.ndarray:
    """n whole numbers spread evenly over [low, high]."""
    return (low + np.floor((high - low + 1) * (np.arange(n) + 0.5) / n)).astype(np.int64)


def requests(schema: dict, traffic: dict, seconds: float, seed: int) -> Requests:
    rng = np.random.default_rng([seed, STREAM])
    n = max(1, int(round(traffic["rate_rps"] * seconds)))
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / traffic["rate_rps"]
    gaps = rng.permutation(gaps)
    arrivals = np.cumsum(gaps) * (seconds / gaps.sum())
    k = rng.permutation(spread(n, traffic["candidates"]["low"], traffic["candidates"]["high"]))
    offsets = np.concatenate([[0], np.cumsum(k)])
    c = int(offsets[-1])
    vocab = schema["vocab_sizes"]
    hist, tags = schema["history"], schema["tags"]
    hist_len = lengths(rng, traffic["history"], hist["max_length"], n)
    user = {"userid": zipf_ids(rng, vocab["userid"], (n,)),
            "device": zipf_ids(rng, vocab["device"], (n,)),
            hist["field"]: sequence(rng, vocab[hist["vocab"]], hist_len, hist["max_length"]),
            hist["field"] + "_len": hist_len}
    tag_len = lengths(rng, traffic["tags"], tags["max_length"], c)
    item = {"dense": np.log1p(rng.poisson(traffic["dense_poisson_lam"],
                                          (c, schema["num_dense"]))).astype(np.float32),
            "feedid": zipf_ids(rng, vocab[hist["vocab"]], (c,))}
    for field, v, kind in schema["category_fields"]:
        if kind == "scalar" and field not in USER_FIELDS:
            item[field] = zipf_ids(rng, vocab[v], (c,))
    item[tags["field"]] = sequence(rng, vocab[tags["vocab"]], tag_len, tags["max_length"])
    item[tags["field"] + "_len"] = tag_len
    return Requests(arrivals, offsets, user, item, hist["field"])
