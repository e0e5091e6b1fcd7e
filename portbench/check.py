"""The numbers that decide ``correct``, each against the cell's limit.

Training (the program's first three steps, which set-up drives through the
window's own ``Trainer.train_step``, against the reference's three steps from
the same weights, batches and dropout masks):

  * ``loss_gap``: the largest relative gap of a step's loss;
  * ``grad_gap``: over the leaves, the largest gap between the norms of the
    first step's gradient (the program's worked out from Adam's first moment
    after step 1), over the larger of the reference leaf's norm and the
    median leaf's;
  * ``grad_gap_median``: the same gaps' median leaf;
  * ``change_gap``: the same gap for the norm of each leaf's change over the
    three steps, on the leaves whose reference gradient is at least
    ``ZERO_GRADIENT`` of the median leaf's (a bias before a batch norm has a
    gradient of rounding alone, which Adam turns into a step of full size),
    and of these gaps the median leaf's;
  * ``change_gap_worst``: the worst of those leaves' gaps.

The worst leaf's gaps and the later steps' losses swing from seed to seed on
both sides, in float32 as much in the reference as in the program (a float64
reference shows which side moved): a pre-activation within rounding of the
leaky ReLU's knee takes the other branch on one side, which moves one
element of the feed-forward bias's gradient and, through it, the layer
norm's; and Adam steps every element by about the rate whatever its
gradient's size, so an element whose gradient is zero to rounding and takes
the other sign moves by twice the rate, and the steps after it carry that
on.  So these numbers are held only against the planted faults, and the
control (the reference one precision lower) has to fail the first
gradient's median leaf, which no such event moves.

Serving: ``prob_gap``, the largest absolute gap between a served probability
and the reference's, over every candidate answered in the window.
"""

from __future__ import annotations

import numpy as np

ZERO_GRADIENT = 1e-3


def leaf_gaps(prog: dict, ref: dict, leaves) -> dict:
    """|prog - ref| / max(ref, median of ref) of each of ``leaves``."""
    leaves = list(leaves)
    median = float(np.median([ref[k] for k in leaves]))
    return {k: abs(prog[k] - ref[k]) / max(ref[k], median) for k in leaves}


def worst(gaps: dict) -> tuple[float, str]:
    leaf = max(gaps, key=gaps.get)
    return gaps[leaf], leaf


def median_leaf(gaps: dict) -> tuple[float, str]:
    leaves = sorted(gaps, key=gaps.get)
    leaf = leaves[(len(leaves) - 1) // 2]
    return gaps[leaf], leaf


def counted_leaves(ref_grad: dict) -> list[str]:
    median = float(np.median(list(ref_grad.values())))
    return [k for k, v in ref_grad.items() if v >= ZERO_GRADIENT * median]


def train_numbers(prog: dict, ref: dict) -> dict:
    """``prog`` and ``ref``: {"losses": [..], "grad": {leaf: norm},
    "change": {leaf: norm}}.  Returns {name: (value, the step or leaf that
    sets it)}."""
    loss = [abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"])]
    step = int(np.argmax(loss))
    change = leaf_gaps(prog["change"], ref["change"], counted_leaves(ref["grad"]))
    grad = leaf_gaps(prog["grad"], ref["grad"], ref["grad"])
    return {
        "loss_gap": (loss[step], f"step {step + 1}"),
        "grad_gap": worst(grad),
        "grad_gap_median": median_leaf(grad),
        "change_gap": median_leaf(change),
        "change_gap_worst": worst(change),
    }


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """Every number that has a limit within it; returns (correct, {name:
    (value, limit)})."""
    checks = {name: (value, limits[name]) for name, (value, _) in numbers.items()
              if name in limits}
    return all(v <= lim for v, lim in checks.values()), checks
