"""DIEN training cells: ``Trainer.train_step`` on WeChat host batches, back
to back, as ``kinds/train.py`` drives BST.

Set-up makes the seed's weights (``weights_dien.py``) and batches
(``traffic/train.py``), builds one trainer with the configuration's
LazyAdam, and drives it through its first three steps on batches 0-2: they
are the steps the reference (``reference/dien.py``) follows, and they warm
up and capture every shape the window uses.  The first step's gradient is
read from LazyAdam's first moment (``mu / (1 - b1)`` after step 1: ``mu``
is ``(1 - b1) g`` where g is nonzero and 0 where it is 0).

The cell measures DIEN's replayed step: on a card, a program whose second
and third steps are not graph replays cannot run it, and the run fails
there (:func:`require_replays`).  Set-up then steps on the cycled batches
for the cell's ``warm_seconds``: on the H100 a fresh process's replayed
DIEN step runs about 13% slower (22.9 against 20.2 ms of device time)
for its first 0 to 20 seconds or more of stepping, and the window measures
the steady step that follows.  The window then runs steps for
``--seconds`` and ends in a synchronize; ``train_ex_s`` is all examples
trained over the window's wall time.  A traced run profiles the window's
first ``TRACE_SECONDS`` and fails unless each of its ``train.step`` spans
has a ``train.replay`` under it.  The trainer is freed before the
reference runs its three steps.
"""

from __future__ import annotations

import time

import numpy as np

from portbench import check, harness, spans, weights, weights_dien  # noqa: F401 (the spec)
from portbench.kinds import train as base
from portbench.traffic import train as traffic

CHECKED_STEPS = base.CHECKED_STEPS
TRACE_SECONDS = base.TRACE_SECONDS


def make_trainer(cfg: dict, w: dict, seed: int, device: str):
    """``kinds/train.py``'s trainer, its LazyAdam checked against the
    configuration file's moments and eps (``build`` gives it its own)."""
    trainer = base.make_trainer(cfg, w, seed, device)
    group, opt = trainer.optimizer.opt.param_groups[0], cfg["optimizer"]
    built = {"name": type(trainer.optimizer.opt).__name__.lower(), "b1": group["betas"][0],
             "b2": group["betas"][1], "eps": group["eps"]}
    if built != opt:
        raise ValueError(f"the program's optimizer {built} is not the configuration's {opt}")
    return trainer


def program_steps(trainer, cfg: dict, batches: list, init: dict) -> dict:
    """The first CHECKED_STEPS steps through ``train_step``: each loss, the
    first gradient's norm by leaf (from LazyAdam's first moment after step
    1; 0 where it holds none), and each leaf's change after the last."""
    import torch

    b1 = cfg["optimizer"]["b1"]
    params = dict(trainer.model.named_parameters())
    losses, grad = [], None
    for batch in batches[:CHECKED_STEPS]:
        losses.append(float(trainer.train_step(batch)))
        if grad is None:
            state = trainer.optimizer.opt.state
            grad = base._norms({k: state[p]["mu"] / (1 - b1) if "mu" in state[p]
                                else torch.zeros(()) for k, p in params.items()})
    change = base._norms({k: p.detach() - init[k] for k, p in params.items()})
    return {"losses": losses, "grad": grad, "change": change}


def reference_steps(cfg: dict, seed: int, batches: list, device, tf32: bool = False) -> dict:
    """The reference's CHECKED_STEPS steps from the seed's weights, with the
    dropout stream the trainer draws from (TrainerConfig.seed + 1)."""
    from portbench import reference
    from portbench.reference import dien

    init = weights.trainable(cfg, weights.make(cfg, seed, device))
    params = {k: v.clone() for k, v in init.items()}
    on_device = [base.device_batch(b, device) for b in batches[:CHECKED_STEPS]]
    with reference.precision(tf32):
        losses, first, after = dien.train(params, cfg, on_device, seed + 1, device)
    return {"losses": losses, "grad": base._norms(first),
            "change": base._norms({k: after[k] - init[k] for k in init})}


def require_replays(trainer, device: str) -> None:
    """On a card, the first CHECKED_STEPS steps' last two must have been
    graph replays (the second captures and replays); a program that steps
    DIEN eagerly raises, before the window."""
    replays = getattr(trainer, "replays", 0)
    if device == "cuda" and replays != CHECKED_STEPS - 1:
        raise RuntimeError(
            f"DIEN's steps 2-{CHECKED_STEPS} ran {replays} graph replays, not "
            f"{CHECKED_STEPS - 1}: this cell measures the replayed step, which the "
            "program does not take (its LazyAdam is not capturable)")


def warm_up(trainer, batches: list, i: int, seconds: float, sync) -> int:
    """Steps on the cycled batches from index ``i`` for ``seconds``; the next
    index."""
    end = time.perf_counter() + seconds
    while time.perf_counter() < end:
        trainer.train_step(batches[i % len(batches)])
        i += 1
    sync()
    return i


def replayed_steps() -> tuple[int, int]:
    """(``train.step`` spans with a ``train.replay`` under them, all
    ``train.step`` spans) of the traced window; (0, 0) where the program
    records none."""
    records = spans.recorded() or []
    replays, steps = spans.under(records, "train.step", "train.replay")
    return len(replays), steps


def run(run: harness.Run) -> harness.Result:
    import torch

    cfg, tr = run.cfg, run.cell["traffic"]
    harness.mark(run, "imports")
    if run.device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    w = weights.make(cfg, run.seed, run.device)
    init = {k: v.clone() for k, v in weights.trainable(cfg, w).items()}
    harness.mark(run, "weights")
    trainer = make_trainer(cfg, w, run.seed, run.device)
    del w
    harness.mark(run, "trainer")
    batches = traffic.batches(cfg["schema"], tr, cfg["batch_size"], run.seed)
    harness.mark(run, "batches")
    prog = program_steps(trainer, cfg, batches, init)
    del init
    require_replays(trainer, run.device)
    harness.mark(run, "checked steps")
    sync = torch.cuda.synchronize if run.device == "cuda" else (lambda: None)
    start = warm_up(trainer, batches, CHECKED_STEPS, run.cell["warm_seconds"], sync)
    setup_s = time.perf_counter() - run.started

    session = None
    if run.trace:
        from portbench.trace import Session

        session = Session()
        session.start()
    steps, traced, i = 0, None, start
    stamps = []
    cpu0 = time.process_time()
    pauses = harness.GCPauses().__enter__()
    t0 = time.perf_counter()
    end, trace_end = t0 + run.seconds, t0 + TRACE_SECONDS
    while True:
        trainer.train_step(batches[i % len(batches)])
        i += 1
        steps += 1
        now = time.perf_counter()
        stamps.append(now)
        if session is not None and traced is None and now >= trace_end:
            session.stop()
            traced = (start, i)
        if now >= end:
            break
    sync()
    wall = time.perf_counter() - t0
    pauses.__exit__()
    if session is not None and traced is None:
        session.stop()
        traced = (start, i)
    ex_s = steps * cfg["batch_size"] / wall
    peak = torch.cuda.max_memory_allocated() if run.device == "cuda" else 0
    harness.log(f"window: {steps} steps in {wall:.6f} s, {ex_s:.3f} examples/s, "
                f"set-up {setup_s:.3f} s, process CPU {time.process_time() - cpu0:.3f} s, "
                f"peak {peak} bytes, {getattr(trainer, 'replays', 0)} replayed steps in all")
    per_s = np.histogram(np.asarray(stamps) - t0, bins=np.arange(0, run.seconds + 1.0))[0]
    harness.log(f"steps a second: {' '.join(str(int(x)) for x in per_s)}; "
                f"garbage collection: {pauses}")

    trace = None
    if session is not None:
        n = traced[1] - traced[0]
        replayed, spanned = replayed_steps()
        harness.log(f"traced window: {n} steps, {replayed} of its {spanned} train.step spans "
                    "with a train.replay under them")
        if run.device == "cuda" and replayed != spanned:
            raise RuntimeError(f"{spanned - replayed} traced train.step spans without a "
                               "train.replay under them")
        trace = session.read("train", cfg, {"steps": n, "examples": n * cfg["batch_size"]})
    del trainer
    base.free_device()
    ref = reference_steps(cfg, run.seed, batches, run.device)
    numbers = check.train_numbers(prog, ref)
    for name, (value, where) in numbers.items():
        harness.log(f"{name} {value!r} at {where}")
    correct, checks = check.judge(numbers, run.cell["limits"])
    return harness.Result(correct=correct, attempted=steps, failed=0,
                          e2e={"train_ex_s": ex_s, "setup_s": setup_s}, checks=checks,
                          trace=trace, memory_peak_bytes=peak)
