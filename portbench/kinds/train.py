"""Training cells: ``Trainer.train_step`` on host batches, back to back.

Set-up makes the weights and the batches from the seed, builds one trainer,
and drives it through its first three steps on batches 0-2 (rows that all
differ): they are the steps the reference follows, and they warm up every
shape the window uses.  The window then runs steps on the cycled batches for
``--seconds``, and ends in a synchronize; ``train_ex_s`` is all examples
trained over the whole window's wall time.  A traced run profiles the
window's first ``TRACE_SECONDS``.
"""

from __future__ import annotations

import gc
import time

import numpy as np

from portbench import check, harness, weights
from portbench.kinds import program_model
from portbench.traffic import train as traffic

CHECKED_STEPS = 3
TRACE_SECONDS = 2.0


def history_lengths(cfg: dict, batch: dict) -> np.ndarray:
    return batch[cfg["schema"]["history"]["field"] + "_len"]


def make_trainer(cfg: dict, w: dict, seed: int, device: str):
    from recalgorithm_tpu_torch.train import optimizers
    from recalgorithm_tpu_torch.train.loop import Trainer, TrainerConfig

    model, mcfg = program_model(cfg, w, device)
    tcfg = TrainerConfig(seed=seed, handle_sigterm=False,
                         model_dir=str(harness.scratch_dir("train")))
    return Trainer(model, mcfg.task_names, optimizers.build(mcfg.optimizer, mcfg.learning_rate),
                   tcfg, device=device)


def _norms(tensors: dict) -> dict:
    return {k: float(v.double().norm()) for k, v in tensors.items()}


def program_steps(trainer, cfg: dict, batches: list, init: dict) -> dict:
    """The first CHECKED_STEPS steps through ``train_step``: each loss, the
    first gradient's norm by leaf (Adam's first moment after step 1 over
    1 - b1; 0 where the optimizer holds none), and each leaf's change after
    the last."""
    import torch

    b1 = cfg["optimizer"]["b1"]
    params = dict(trainer.model.named_parameters())
    losses, grad = [], None
    for batch in batches[:CHECKED_STEPS]:
        losses.append(float(trainer.train_step(batch)))
        if grad is None:
            state = trainer.optimizer.opt.state
            grad = _norms({k: state[p]["exp_avg"] / (1 - b1) if "exp_avg" in state[p]
                           else torch.zeros(()) for k, p in params.items()})
    change = _norms({k: p.detach() - init[k] for k, p in params.items()})
    return {"losses": losses, "grad": grad, "change": change}


def device_batch(batch: dict, device) -> dict:
    import torch

    return {k: torch.from_numpy(np.asarray(v)).to(device) for k, v in batch.items()}


def reference_steps(cfg: dict, seed: int, batches: list, device, tf32: bool = False) -> dict:
    """The reference's CHECKED_STEPS steps from the seed's weights, with the
    dropout stream the trainer draws from (TrainerConfig.seed + 1)."""
    from portbench import reference
    from portbench.reference import bst

    init = weights.trainable(cfg, weights.make(cfg, seed, device))
    params = {k: v.clone() for k, v in init.items()}
    on_device = [device_batch(b, device) for b in batches[:CHECKED_STEPS]]
    with reference.precision(tf32):
        losses, first, after = bst.train(params, cfg, on_device, seed + 1, device)
    return {"losses": losses, "grad": _norms(first),
            "change": _norms({k: after[k] - init[k] for k in init})}


def free_device() -> None:
    import torch

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def run(run: harness.Run) -> harness.Result:
    import torch

    cfg, tr = run.cfg, run.cell["traffic"]
    harness.mark(run, "imports")
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
    sync = torch.cuda.synchronize if run.device == "cuda" else (lambda: None)
    sync()
    setup_s = time.perf_counter() - run.started

    session = None
    if run.trace:
        from portbench.trace import Session

        session = Session()
        session.start()
    steps, traced, i = 0, None, CHECKED_STEPS
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
            traced = (CHECKED_STEPS, i)
        if now >= end:
            break
    sync()
    wall = time.perf_counter() - t0
    pauses.__exit__()
    if session is not None and traced is None:
        session.stop()
        traced = (CHECKED_STEPS, i)
    ex_s = steps * cfg["batch_size"] / wall
    peak = torch.cuda.max_memory_allocated() if run.device == "cuda" else 0
    harness.log(f"window: {steps} steps in {wall:.6f} s, {ex_s:.3f} examples/s, "
                f"set-up {setup_s:.3f} s, process CPU {time.process_time() - cpu0:.3f} s")
    per_s = np.histogram(np.asarray(stamps) - t0, bins=np.arange(0, run.seconds + 1.0))[0]
    harness.log(f"steps a second: {' '.join(str(int(x)) for x in per_s)}; "
                f"garbage collection: {pauses}")

    trace = None
    if session is not None:
        lens = [history_lengths(cfg, batches[j % len(batches)]) for j in range(*traced)]
        trace = session.read("train", cfg, {
            "steps": len(lens), "examples": len(lens) * cfg["batch_size"],
            "history_lengths": lens, "heads": cfg["config"]["num_transformer_heads"],
            "keys": cfg["config"]["sequence_max_length"] + 1})
    del trainer
    free_device()
    ref = reference_steps(cfg, run.seed, batches, run.device)
    numbers = check.train_numbers(prog, ref)
    for name, (value, where) in numbers.items():
        harness.log(f"{name} {value!r} at {where}")
    correct, checks = check.judge(numbers, run.cell["limits"])
    return harness.Result(correct=correct, attempted=steps, failed=0,
                          e2e={"train_ex_s": ex_s, "setup_s": setup_s}, checks=checks,
                          trace=trace, memory_peak_bytes=peak)
