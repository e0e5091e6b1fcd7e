"""Faults planted under the timed path, for the checks that ``correct``
comes out false (the tests) and for the readings that set the limits
(``control.py``).  Each takes ``patch(owner, name, value)``: pytest's
``monkeypatch.setattr`` in a test, ``setattr`` in a process of its own.
"""

from __future__ import annotations


def unchanged_state(patch) -> None:
    """Every optimizer step returns the parameters unchanged."""
    from recalgorithm_tpu_torch.train import optimizers

    patch(optimizers.Optimizer, "step", lambda self: None)


def half_batch(patch) -> None:
    """The training loss is the mean over the first half of each batch only
    (the second half weighted 0)."""
    import torch

    from recalgorithm_tpu_torch.train.loop import Trainer

    inner = Trainer._loss_and_logits

    def half(self, batch):
        n = len(batch["labels"])
        weights = (torch.arange(n, device=batch["labels"].device) < n // 2).float()
        return inner(self, {**batch, "_weights": weights})

    patch(Trainer, "_loss_and_logits", half)


def altered_answer(patch) -> None:
    """The first row of every served batch answers 0.5 more (mod 1)."""
    from recalgorithm_tpu_torch.serving.predictor import Predictor

    inner = Predictor.predict_batch

    def altered(self, batch):
        out = inner(self, batch)
        for p in out.values():
            p[0] = (p[0] + 0.5) % 1.0
        return out

    patch(Predictor, "predict_batch", altered)


def half_served(patch) -> None:
    """Half of each served batch's real rows left out: only the first half
    is computed, and the rest answer the mean over it (0.5 where it is
    empty)."""
    import numpy as np

    from recalgorithm_tpu_torch.serving.predictor import Predictor

    inner = Predictor.predict_batch

    def half(self, batch):
        real = int((np.asarray(batch["_weights"]) > 0).sum())
        m = real // 2
        out = inner(self, batch)
        for p in out.values():
            p[m:real] = p[:m].mean() if m else 0.5
        return out

    patch(Predictor, "predict_batch", half)


TRAIN = {"unchanged_state": unchanged_state, "half_batch": half_batch}
SERVE = {"altered_answer": altered_answer, "half_served": half_served}
