"""Streaming metrics: binned AUC (tf.metrics.auc parity), accuracy, mean loss.

Counterpart of ``recalgorithm_tpu/train/metrics.py``.  The reference's
north-star metric is streaming ``tf.metrics.auc`` with its default 200
thresholds (e.g. wide_and_deep.py:243).  ``AUCState`` reproduces that
binning as per-threshold counts that live on the device and update inside
the train and eval steps with no host sync.  The updates add into the
state's tensors in place, and read the thresholds from a constant kept on
each device: no allocation of state and no host copy a step, so a CUDA
graph can hold them (``train/loop.py``).

``exact_auc`` is the rank-based (Mann-Whitney) AUC computed on the host for
final reporting; it is the unbinned ground truth the binned metric
approximates.  ``grouped_auc`` is its per-user (GAUC) companion.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

NUM_THRESHOLDS = 200  # tf.metrics.auc default


def _thresholds(num: int = NUM_THRESHOLDS) -> np.ndarray:
    # tf.metrics.auc: [ -eps, 1/(n-1), 2/(n-1), ..., (n-2)/(n-1), 1+eps ]
    eps = 1e-7
    inner = [(i + 1) / (num - 1) for i in range(num - 2)]
    return np.asarray([-eps] + inner + [1.0 + eps], np.float32)


_device_thresholds: dict[torch.device, torch.Tensor] = {}


def _thresholds_on(device: torch.device) -> torch.Tensor:
    """The thresholds on ``device``, copied there once."""
    thr = _device_thresholds.get(device)
    if thr is None:
        thr = _device_thresholds[device] = torch.from_numpy(_thresholds()).to(device)
    return thr


@dataclasses.dataclass
class AUCState:
    """Per-threshold confusion counts (each shape (NUM_THRESHOLDS,), f32)."""

    tp: torch.Tensor
    fp: torch.Tensor
    tn: torch.Tensor
    fn: torch.Tensor

    @classmethod
    def init(cls, device: torch.device | str = "cpu") -> "AUCState":
        z = lambda: torch.zeros(NUM_THRESHOLDS, dtype=torch.float32, device=device)
        return cls(tp=z(), fp=z(), tn=z(), fn=z())


def auc_update(state: AUCState,
               labels: torch.Tensor,       # (B,) in {0, 1}
               predictions: torch.Tensor,  # (B,) probabilities in [0, 1]
               weights: torch.Tensor | None = None,  # (B,) 0/1 padding mask
               ) -> AUCState:
    """Adds the batch's counts to ``state`` in place; returns ``state``."""
    thr = _thresholds_on(predictions.device)
    labels = labels.to(torch.float32)
    weights = torch.ones_like(labels) if weights is None else weights.to(torch.float32)
    pred_pos = (predictions[None, :] > thr[:, None]).to(torch.float32)  # (T, B)
    pos = (labels * weights)[None, :]
    neg = ((1.0 - labels) * weights)[None, :]
    state.tp.add_((pred_pos * pos).sum(dim=1))
    state.fp.add_((pred_pos * neg).sum(dim=1))
    state.fn.add_(((1.0 - pred_pos) * pos).sum(dim=1))
    state.tn.add_(((1.0 - pred_pos) * neg).sum(dim=1))
    return state


def auc_compute(state: AUCState) -> torch.Tensor:
    """Trapezoidal ROC-AUC over the binned counts (tf 'trapezoidal' mode)."""
    eps = 1e-7
    tpr = state.tp / (state.tp + state.fn).clamp(min=eps)
    fpr = state.fp / (state.fp + state.tn).clamp(min=eps)
    # thresholds ascend -> (fpr, tpr) descend; integrate |dx| * mean(y)
    return ((fpr[:-1] - fpr[1:]) * (tpr[:-1] + tpr[1:]) / 2.0).sum()


def exact_auc(labels: np.ndarray, scores: np.ndarray) -> float:
    """Rank-based AUC (ties get their average rank); host-side, for final eval."""
    labels = np.asarray(labels).astype(np.float64).ravel()
    scores = np.asarray(scores).astype(np.float64).ravel()
    n_pos = labels.sum()
    n_neg = labels.size - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(scores, kind="mergesort")
    sorted_scores = scores[order]
    # average rank over each run of tied scores
    starts = np.flatnonzero(np.r_[True, sorted_scores[1:] != sorted_scores[:-1]])
    ends = np.r_[starts[1:], len(sorted_scores)] - 1
    ranks = np.empty_like(scores)
    ranks[order] = np.repeat((starts + ends) / 2.0 + 1.0, ends - starts + 1)
    pos_rank_sum = ranks[labels == 1].sum()
    return float((pos_rank_sum - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))


def grouped_auc(labels: np.ndarray, scores: np.ndarray, groups: np.ndarray) -> float:
    """GAUC: impression-weighted mean of per-group (per-user) AUCs (DIN
    paper, KDD'18 §6.1).  Single-class groups carry no ranking information
    and are left out of both the sum and the weight."""
    labels = np.asarray(labels).astype(np.float64).ravel()
    scores = np.asarray(scores).astype(np.float64).ravel()
    groups = np.asarray(groups).ravel()
    order = np.argsort(groups, kind="mergesort")
    labels, scores, groups = labels[order], scores[order], groups[order]
    starts = np.flatnonzero(np.r_[True, groups[1:] != groups[:-1]])
    bounds = np.r_[starts, len(groups)]
    total_w = 0.0
    total = 0.0
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        y = labels[lo:hi]
        n_pos = y.sum()
        if n_pos == 0 or n_pos == len(y):
            continue
        total += (hi - lo) * exact_auc(y, scores[lo:hi])
        total_w += hi - lo
    return float(total / total_w) if total_w else float("nan")


@dataclasses.dataclass
class ScalarMeanState:
    """Streaming weighted mean (loss, accuracy), 0-d f32 tensors."""

    total: torch.Tensor
    count: torch.Tensor

    @classmethod
    def init(cls, device: torch.device | str = "cpu") -> "ScalarMeanState":
        return cls(total=torch.zeros((), dtype=torch.float32, device=device),
                   count=torch.zeros((), dtype=torch.float32, device=device))


def mean_update(state: ScalarMeanState, values: torch.Tensor,
                weights: torch.Tensor | None = None) -> ScalarMeanState:
    """Adds the batch's weighted sum and weight to ``state`` in place;
    returns ``state``."""
    if weights is None:
        weights = torch.ones_like(values)
    state.total.add_((values * weights).sum())
    state.count.add_(weights.sum())
    return state


def mean_compute(state: ScalarMeanState) -> torch.Tensor:
    return state.total / state.count.clamp(min=1e-7)
