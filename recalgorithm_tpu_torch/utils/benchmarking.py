"""Per-step device time of a train step, as the slope of K steps.

Counterpart of ``recalgorithm_tpu/utils/benchmarking.py`` with the same
contract: the median per-step time of ``step_fn`` on one batch that is fed
again every step (the input pipeline is left out by design), measured as
the slope between K = ``k_small`` and K = ``k_big`` steps run back to back,
so that the fixed cost of starting and ending a measurement cancels.

On ``cuda`` the K steps sit between two CUDA events and the time is the
card's, host gaps between launches included; on the CPU it is the wall
clock.  The JAX package's ``rng_impl`` (a TPU PRNG) and
``compiler_options`` (XLA's) are accepted and ignored: the step runs
eagerly here.
"""

from __future__ import annotations

import time
from typing import Callable

import torch


def loop_step_time_us(
    step_fn: Callable,  # (state, batch, rng) -> (state, scalar loss)
    state,
    batch,
    *,
    k_small: int = 8,
    k_big: int = 72,
    repeats: int = 3,
    seed: int = 0,
    rng_impl: str = "rbg",  # accepted for the JAX signature; unused
    compiler_options: dict | None = None,  # accepted for the JAX signature; unused
    device: str | torch.device = "cuda",
) -> float:
    """Median per-step time (µs) of ``step_fn``: (t(k_big) - t(k_small)) /
    (k_big - k_small), each t the median of ``repeats`` timed runs after one
    warm-up run.  ``rng`` is the step's index offset by the run's seed (an
    int).  ``device`` is where the step runs and picks the clock: CUDA
    events on ``cuda`` (the default; raises without a card), the wall clock
    on the CPU."""
    device = torch.device(device)
    on_card = device.type == "cuda"

    def run(k: int, st, run_seed: int):
        """k steps from ``st``, each on ``batch``."""
        loss = None
        for i in range(k):
            st, loss = step_fn(st, batch, run_seed + i)
        return st, loss

    def timed(k: int) -> float:
        run(k, state, seed)  # warm-up
        if on_card:
            torch.cuda.synchronize(device)
        times = []
        for r in range(repeats):
            if on_card:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                run(k, state, seed + 1 + r)
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end) / 1e3)
            else:
                t0 = time.perf_counter()
                _, loss = run(k, state, seed + 1 + r)
                if isinstance(loss, torch.Tensor):
                    float(loss)
                times.append(time.perf_counter() - t0)
        times.sort()
        return times[len(times) // 2]

    t_small = timed(k_small)
    t_big = timed(k_big)
    return max(t_big - t_small, 1e-9) / (k_big - k_small) * 1e6


def loop_step_time_stats(
    step_fn: Callable,
    state,
    batch,
    *,
    reps: int = 5,
    seed: int = 0,
    time_budget_s: float | None = None,
    **kw,
) -> dict:
    """Median and sample standard deviation over ``reps`` independent slope
    measurements (each a fresh :func:`loop_step_time_us`).

    ``time_budget_s`` stops early, keeping at least 2 reps.  Returns
    ``{"median_us", "sigma_us", "reps_us"}``."""
    t0 = time.perf_counter()
    vals: list[float] = []
    for r in range(reps):
        vals.append(loop_step_time_us(step_fn, state, batch, seed=seed + 101 * r, **kw))
        if (time_budget_s is not None and len(vals) >= 2
                and time.perf_counter() - t0 > time_budget_s):
            break
    s = sorted(vals)
    n = len(s)
    median = s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])
    mean = sum(s) / n
    sigma = (sum((v - mean) ** 2 for v in s) / max(n - 1, 1)) ** 0.5
    return {"median_us": median, "sigma_us": sigma, "reps_us": vals}
