"""DLRM-DCNv2's work: model FLOP and the tables' needed bytes, from the
configuration's widths and a step's host batch.

FLOP: a product of an (m, k) by a (k, n) matrix counts 2 m k n.  A row's
forward is the dense arch, the cross stack (each layer a down and an up
projection, width x rank) and the over arch with its logit; a train step
counts three forwards (the forward, and the backward's two products a
layer).  Element-wise work (pooling sums, the cross's product with x0,
activations, the loss) is not counted, so these are the step's matrix
products and nothing else.

Bytes: what the tables' path needs at the least, every byte once, in
float32: each id's row read by its lookup; the pooled rows written and
their gradients read back; and each row a step touches (each distinct id of
a table) with its gradient, its parameter and its Adagrad accumulator read
and written once, the update of the touched rows alone (the sparse ideal).
"""

from __future__ import annotations

import numpy as np

F32 = 4


def _products(widths: list[int]) -> int:
    return sum(2 * a * b for a, b in zip(widths[:-1], widths[1:]))


def cross_width(cfg: dict) -> int:
    return cfg["dense_arch_layer_sizes"][-1] + cfg["embedding_dim"] * len(
        cfg["multi_hot_sizes"])


def forward_per_row(cfg: dict) -> int:
    """Forward FLOP of one row."""
    width = cross_width(cfg)
    bottom = _products([cfg["num_dense"], *cfg["dense_arch_layer_sizes"]])
    cross = cfg["dcn_num_layers"] * 2 * (2 * width * cfg["dcn_low_rank_dim"])
    over = _products([width, *cfg["over_arch_layer_sizes"]])
    return bottom + cross + over


def train_step(cfg: dict, rows: int) -> int:
    """A train step's FLOP on ``rows`` rows: three forwards."""
    return 3 * forward_per_row(cfg) * rows


def distinct_rows(cfg: dict, batch: dict) -> int:
    """Rows a batch touches, summed over the tables (distinct ids a table)."""
    return sum(len(np.unique(batch[f"cat_{i}"])) for i in range(len(cfg["multi_hot_sizes"])))


def table_bytes(cfg: dict, batch: dict) -> int:
    """The tables' needed bytes in one train step on ``batch`` (module
    docstring)."""
    dim, b = cfg["embedding_dim"], len(batch["labels"])
    lookups = sum(int(np.asarray(batch[f"cat_{i}"]).size)
                  for i in range(len(cfg["multi_hot_sizes"])))
    pooled = b * len(cfg["multi_hot_sizes"]) * dim * F32
    return lookups * dim * F32 + 2 * pooled + 6 * distinct_rows(cfg, batch) * dim * F32
