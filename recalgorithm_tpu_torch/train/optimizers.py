"""Optimizers with reference parity, and learning-rate schedules.

Counterpart of ``recalgorithm_tpu/train/optimizers.py`` (``build("adam")``
and ``make_schedule`` so far; Adagrad, FTRL, RMSProp, SGD, LazyAdam and the
Wide&Deep dual optimizer wait for the models that use them).

``torch.optim.Adam`` computes optax's Adam update:
``lr * m_hat / (sqrt(v_hat) + eps)`` with bias-corrected moments.  A
schedule is a function of the 0-based count of updates already applied, as
``optax.scale_by_schedule`` evaluates it; :class:`Optimizer` sets the rate
before each step.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable

import torch

Schedule = Callable[[int], float]


def make_schedule(learning_rate: float, schedule: str = "constant",
                  warmup_steps: int = 0, decay_steps: int = 0,
                  end_lr_factor: float = 0.01) -> Schedule:
    """LR schedule factory (beyond reference — the reference trains at a
    fixed LR only).

      constant     flat LR (optionally after linear warmup)
      cosine       cosine decay to end_lr_factor * lr over decay_steps
      exponential  x0.1 every decay_steps (staircase off)

    Warmup ramps linearly from 0 over ``warmup_steps`` and composes with
    any of the above (the body then starts at step ``warmup_steps``).
    """
    schedule = schedule.lower()
    if schedule == "constant":
        body = lambda step: learning_rate
    elif schedule == "cosine":
        if decay_steps <= 0:
            raise ValueError("cosine schedule requires decay_steps > 0")

        def body(step):
            frac = min(step, decay_steps) / decay_steps
            decay = 0.5 * (1.0 + math.cos(math.pi * frac))
            return learning_rate * ((1.0 - end_lr_factor) * decay + end_lr_factor)
    elif schedule == "exponential":
        if decay_steps <= 0:
            raise ValueError("exponential schedule requires decay_steps > 0")
        body = lambda step: learning_rate * 0.1 ** (step / decay_steps)
    else:
        raise ValueError(f"unknown schedule {schedule!r}")
    if warmup_steps <= 0:
        return body
    return lambda step: (learning_rate * step / warmup_steps if step < warmup_steps
                         else body(step - warmup_steps))


class Optimizer:
    """A torch optimizer stepped as optax steps its transformation: the
    scheduled rate of update ``count`` is set before the update."""

    def __init__(self, opt: torch.optim.Optimizer, schedule: Schedule):
        self.opt = opt
        self.schedule = schedule
        self.count = 0

    def zero_grad(self) -> None:
        self.opt.zero_grad(set_to_none=True)

    def step(self) -> None:
        lr = self.schedule(self.count)
        for group in self.opt.param_groups:
            group["lr"] = lr
        self.opt.step()
        self.count += 1

    def state_dict(self) -> dict:
        return {"opt": self.opt.state_dict(), "count": self.count}

    def load_state_dict(self, state: dict) -> None:
        self.opt.load_state_dict(state["opt"])
        self.count = int(state["count"])


def build(name: str, learning_rate: float | Schedule
          ) -> Callable[[Iterable[torch.nn.Parameter]], Optimizer]:
    """Optimizer factory with the reference's names and defaults; returns a
    function of the parameters.  ``learning_rate`` is a float or a schedule."""
    schedule = learning_rate if callable(learning_rate) else (lambda step: learning_rate)
    name = name.lower()
    if name == "adam":
        return lambda params: Optimizer(
            torch.optim.Adam(params, lr=schedule(0), betas=(0.9, 0.999), eps=1e-8),
            schedule)
    raise NotImplementedError(f"optimizer {name!r} is not ported yet (adam only)")
