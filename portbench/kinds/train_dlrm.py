"""DLRM-DCNv2 training cells: ``Trainer.train_step`` on multi-hot Criteo
host batches, back to back, as ``kinds/train.py`` drives BST.

Set-up builds the program's ``DLRM`` in its DCN form from the configuration
file, loads the seed's weights leaf by leaf (``weights_dlrm.py``), builds one
trainer with the configuration's Adagrad and drives it through its first
three steps on batches 0-2: they are the steps the reference follows, and
they warm up every shape the window uses.  The first step's gradient is
read from Adagrad's accumulator (``sqrt(sum(acc - initial))`` a leaf), and
each leaf's change after the third step against its initial value drawn
again from the seed: the tables are 13.1 GB, so no second copy of them is
kept.  The window then runs steps on the cycled batches for ``--seconds``
and ends in a synchronize; ``train_ex_s`` is all rows trained over the
window's wall time.  A traced run profiles the window's first
``TRACE_SECONDS``, and records for the readers each traced step's rows,
ids and distinct table rows.  The trainer is freed before the reference
runs its three steps from the seed's weights drawn again.
"""

from __future__ import annotations

import time

import numpy as np

from portbench import check, flops_dlrm, harness, weights_dlrm
from portbench.kinds import train as base
from portbench.traffic import criteo as traffic

CHECKED_STEPS = base.CHECKED_STEPS
TRACE_SECONDS = base.TRACE_SECONDS
TASK = "click"


def model_config(cfg: dict):
    """The program's ``DLRMConfig`` of the configuration file (the source's
    flags, by their names)."""
    from recalgorithm_tpu_torch.models.dlrm import DLRMConfig

    over, opt = cfg["over_arch_layer_sizes"], cfg["optimizer"]
    if over[-1] != 1:
        raise ValueError(f"the over arch ends in the logit's width 1, not {over[-1]}")
    return DLRMConfig(
        interaction="dcn", embedding_dim=cfg["embedding_dim"],
        bottom_hidden_units=tuple(cfg["dense_arch_layer_sizes"]),
        hidden_units=tuple(over[:-1]), batch_norm=False, dropout_rate=0.0,
        num_cross_layers=cfg["dcn_num_layers"], cross_low_rank=cfg["dcn_low_rank_dim"],
        optimizer=opt["name"], learning_rate=opt["learning_rate"],
        adagrad_initial_accumulator_value=opt["initial_accumulator_value"],
        adagrad_eps=opt["eps"], task_names=(TASK,), precision=cfg["precision"],
        batch_size=cfg["batch_size"])


def schema(cfg: dict):
    from recalgorithm_tpu_torch.features.schema import criteo_schema

    return criteo_schema({f"cat_{i}": n for i, n in enumerate(cfg["num_embeddings_per_feature"])},
                         cfg["multi_hot_sizes"])


def program_model(cfg: dict, seed: int, device):
    """The program's model on ``device`` holding the seed's weights."""
    import torch

    from recalgorithm_tpu_torch.models.dlrm import DLRM

    mcfg = model_config(cfg)
    with torch.device(device):
        model = DLRM(mcfg, schema(cfg))
    weights_dlrm.load_(model, cfg, seed)
    return model, mcfg


def make_trainer(cfg: dict, seed: int, device: str):
    from recalgorithm_tpu_torch.train import optimizers
    from recalgorithm_tpu_torch.train.loop import Trainer, TrainerConfig

    model, mcfg = program_model(cfg, seed, device)
    tcfg = TrainerConfig(seed=seed, handle_sigterm=False,
                         model_dir=str(harness.scratch_dir("train_dlrm")))
    return Trainer(model, mcfg.task_names,
                   optimizers.build(mcfg.optimizer, mcfg.learning_rate,
                                    **mcfg.optimizer_options()),
                   tcfg, device=device)


def change_norms(cfg: dict, seed: int, params: dict) -> dict:
    """Each leaf's distance from its initial value, drawn again a leaf at a
    time."""
    return {k: weights_dlrm.norm_of_change(cfg, seed, k, p) for k, p in params.items()}


def program_steps(trainer, cfg: dict, seed: int, batches: list) -> dict:
    """The first CHECKED_STEPS steps through ``train_step``: each loss, the
    first gradient's norm by leaf (from Adagrad's accumulator after step 1;
    0 where it holds none), and each leaf's change after the last."""
    import torch

    initial = cfg["optimizer"]["initial_accumulator_value"]
    params = dict(trainer.model.named_parameters())
    losses, grad = [], None
    for batch in batches[:CHECKED_STEPS]:
        losses.append(float(trainer.train_step(batch)))
        if grad is None:
            state = trainer.optimizer.opt.state
            grad = {k: (float(torch.sum(state[p]["sum_of_squares"] - initial,
                                        dtype=torch.float64).clamp(min=0).sqrt())
                        if "sum_of_squares" in state[p] else 0.0)
                    for k, p in params.items()}
    with torch.no_grad():
        change = change_norms(cfg, seed, params)
    return {"losses": losses, "grad": grad, "change": change}


def device_batch(batch: dict, device) -> dict:
    return base.device_batch({k: v for k, v in batch.items() if not k.endswith("_len")}, device)


def reference_steps(cfg: dict, seed: int, batches: list, device, tf32: bool = False) -> dict:
    """The reference's CHECKED_STEPS steps from the seed's weights."""
    from portbench import reference
    from portbench.reference import dlrm

    params = weights_dlrm.make(cfg, seed, device)
    on_device = [device_batch(b, device) for b in batches[:CHECKED_STEPS]]
    with reference.precision(tf32):
        losses, first, after = dlrm.train(params, cfg, on_device)
    del on_device
    change = change_norms(cfg, seed, after)
    return {"losses": losses, "grad": first, "change": change}


def traced_data(cfg: dict, batches: list, traced: tuple) -> dict:
    """What the readers need of the traced steps ``range(*traced)``: their
    count, rows, and the tables' needed bytes (``flops_dlrm``)."""
    index = [j % len(batches) for j in range(*traced)]
    nbytes = {j: flops_dlrm.table_bytes(cfg, batches[j]) for j in set(index)}
    return {"steps": len(index), "examples": len(index) * cfg["batch_size"],
            "table_bytes": sum(nbytes[j] for j in index)}


def run(run: harness.Run) -> harness.Result:
    import torch

    cfg, tr = run.cfg, run.cell["traffic"]
    harness.mark(run, "imports")
    if run.device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    trainer = make_trainer(cfg, run.seed, run.device)
    harness.mark(run, "trainer")
    batches = traffic.batches(cfg, tr, cfg["batch_size"], run.seed)
    harness.mark(run, "batches")
    prog = program_steps(trainer, cfg, run.seed, batches)
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
                f"set-up {setup_s:.3f} s, process CPU {time.process_time() - cpu0:.3f} s, "
                f"peak {peak} bytes")
    per_s = np.histogram(np.asarray(stamps) - t0, bins=np.arange(0, run.seconds + 1.0))[0]
    harness.log(f"steps a second: {' '.join(str(int(x)) for x in per_s)}; "
                f"garbage collection: {pauses}")

    trace = None
    if session is not None:
        trace = session.read("train", cfg, traced_data(cfg, batches, traced))
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
