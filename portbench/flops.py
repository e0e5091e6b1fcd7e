"""Model FLOP per example, from a configuration's widths.

A product of an (m, k) by a (k, n) matrix counts 2 m k n.  Attention counts
the valid keys only: BST's scores and weighted sums over the history length
plus the target, DIN's attention MLP and pooling over the history length.
Element-wise work (norms, activations, softmax, lookups) is not counted.
"""

from __future__ import annotations

import numpy as np


def _tower(widths: list[int]) -> int:
    return sum(2 * a * b for a, b in zip(widths[:-1], widths[1:]))


def _category_width(schema: dict) -> int:
    return sum(schema["embedding_dims"][v] for _, v, _ in schema["category_fields"])


def bst_forward(cfg: dict, history_lengths: np.ndarray) -> np.ndarray:
    """Forward FLOP of each example, (B,), given its history length."""
    model, schema = cfg["config"], cfg["schema"]
    k = schema["embedding_dims"][schema["history"]["vocab"]]
    h, t = model["num_transformer_heads"], model["sequence_max_length"] + 1
    keys = np.minimum(np.asarray(history_lengths, np.int64) + 1, t)
    block = (3 * 2 * t * k * h * k      # q, k, v projections
             + 2 * t * h * k * k         # the heads' output projection
             + 2 * t * k * k)            # the feed-forward layer
    core = 4 * h * t * k * keys          # scores and weighted sums, valid keys
    width = schema["num_dense"] + _category_width(schema) + k
    tower = _tower([width, *model["hidden_units"], 1])
    return model["num_transformer_block"] * (block + core) + tower


def din_forward(cfg: dict, history_lengths: np.ndarray) -> np.ndarray:
    """Forward FLOP of each example, (B,), given its history length."""
    schema = cfg["schema"]
    k = schema["embedding_dims"][schema["history"]["vocab"]]
    steps = np.minimum(np.asarray(history_lengths, np.int64),
                       schema["history"]["max_length"])
    per_step = _tower([4 * k, *cfg["attention_units"]]) + 2 * k
    width = schema["num_dense"] + _category_width(schema) + 2 * k
    return per_step * steps + _tower([width, *cfg["config"]["hidden_units"], 1])


FORWARD = {"BST": bst_forward, "DIN": din_forward}


def train_step(cfg: dict, history_lengths: np.ndarray) -> int:
    """A training step's FLOP on a batch: forward and backward, 3 forwards."""
    return 3 * int(FORWARD[cfg["model"]](cfg, history_lengths).sum())


def forward(cfg: dict, history_lengths: np.ndarray) -> int:
    return int(FORWARD[cfg["model"]](cfg, history_lengths).sum())
