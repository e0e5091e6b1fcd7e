"""DIEN's model FLOP, from the configuration's widths.

A product of an (m, k) by a (k, n) matrix counts 2 m k n, a dot product of
length k counts 2 k.  A row's forward: the extraction GRU and the evolution
AUGRU over all T steps (each recurrence runs every step whatever the row's
length: its input products to the two gates and the candidate, and its
recurrent ones), the attention (the target's projection and T scores), the
auxiliary loss over the T - 1 step pairs (the next item and each negative
projected to H and scored), and the tower with its logit.  A train step
counts three forwards (the forward, and the backward's two products a
product).  Element-wise work (gates, softmax, norms, Dice, lookups, the
loss) is not counted, so these are the step's matrix products and dot
products and nothing else.
"""

from __future__ import annotations


def _products(widths: list[int]) -> int:
    return sum(2 * a * b for a, b in zip(widths[:-1], widths[1:]))


def forward_per_row(cfg: dict) -> int:
    """Forward FLOP of one row."""
    model, schema = cfg["config"], cfg["schema"]
    k = schema["embedding_dims"][schema["history"]["vocab"]]
    h, t = model["gru_output_units"], schema["history"]["max_length"]
    recurrent = t * 2 * h * 3 * h                 # h W_hg (H, 2H) and (r h) W_hc (H, H)
    extract = t * 2 * k * 3 * h + recurrent       # x W_xg (K, 2H), x W_xc (K, H)
    evolve = t * 2 * h * 3 * h + recurrent
    attend = 2 * k * h + t * 2 * h
    aux = 0
    if model["use_auxiliary_loss"]:
        aux = (1 + model["negative_sample_number"]) * (t - 1) * (2 * k * h + 2 * h)
    category = sum(schema["embedding_dims"][v] for _, v, _ in schema["category_fields"])
    width = schema["num_dense"] + category + k + h
    tower = _products([width, *model["hidden_units"], 1])
    return extract + attend + evolve + aux + tower


def train_step(cfg: dict, rows: int) -> int:
    """A train step's FLOP on ``rows`` rows: three forwards."""
    return 3 * forward_per_row(cfg) * rows
