"""Data-parallel training cells: BST's ``Trainer`` on a mesh of the cell's
``chips`` ranks, one card each, the tables row-sharded over them through the
port's exchange (``embed/sharded.py``).

Rank 0 runs in the run's own process, so the profiler, the spans and the
check of loaded modules see it; ranks 1.. start with ``spawn``.  The ranks
meet at ``tcp://localhost:<free port>`` (NCCL on cards, gloo on the CPU)
with a timeout on every collective, and rank 0 waits for the others' exit
with a timeout too: a rank that fails or hangs ends the run with an error,
never a hang.

Every rank draws the same global batches from the seed (the training
traffic's law, ``batch_size`` rows a rank) and takes its own rows; every
rank builds the seed's weights whole and the trainer shards them.  Set-up
drives the first three steps on global batches 0-2 (the steps the
reference follows).  The first step's gradient is Adam's first moment after
step 1 over 1 - b1, its squares summed over the ranks for a sharded table;
each leaf's change after step 3 is read from the whole state gathered to
rank 0.  The window runs steps on the cycled batches until rank 0's clock
passes ``--seconds``: every ``STOP_EVERY`` steps the ranks agree on rank
0's decision in one collective.  It ends in a barrier and a synchronize;
``train_ex_s`` is the global rows trained over rank 0's window.  A traced
run profiles rank 0's first ``TRACE_SECONDS``.  Rank 0 then runs the
reference (``reference/bst_dp.py``) on the global batches.
"""

from __future__ import annotations

import datetime
import socket
import time


from portbench import check, harness, weights
from portbench.kinds import program_model
from portbench.kinds import train as base
from portbench.traffic import train as traffic

CHECKED_STEPS = base.CHECKED_STEPS
TRACE_SECONDS = base.TRACE_SECONDS
STOP_EVERY = 8
TIMEOUT_S = 180.0  # a collective, the ranks' meeting, a rank's exit


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def local_rows(batch: dict, rank: int, rows: int) -> dict:
    return {k: v[rank * rows:(rank + 1) * rows] for k, v in batch.items()}


def first_grad_norms(trainer, cfg: dict, dist) -> dict:
    """Each leaf's first-step gradient norm (Adam's first moment over
    1 - b1), a sharded table's squares summed over the ranks."""
    import torch

    from recalgorithm_tpu_torch.parallel import mesh as mesh_lib

    b1 = cfg["optimizer"]["b1"]
    state = trainer.optimizer.opt.state
    names, squares, tables = [], [], []
    for k, p in trainer.model.named_parameters():
        g = state[p]["exp_avg"] / (1 - b1) if "exp_avg" in state[p] else torch.zeros(())
        names.append(k)
        squares.append(g.double().square().sum().to(p.device))
        tables.append(trainer.specs[k] == mesh_lib.TABLE)
    sq = torch.stack(squares)
    summed = sq.clone()
    dist.all_reduce(summed)
    mask = torch.tensor(tables, device=sq.device)
    return dict(zip(names, torch.where(mask, summed, sq).sqrt().tolist()))


def train_rank(rank: int, world: int, address: str, run: harness.Run) -> dict | None:
    """One rank's whole part of the run; rank 0 returns what it measured."""
    import torch
    import torch.distributed as dist

    from recalgorithm_tpu_torch.parallel import mesh as mesh_lib
    from recalgorithm_tpu_torch.train import optimizers
    from recalgorithm_tpu_torch.train.loop import Trainer, TrainerConfig

    cfg, tr = run.cfg, run.cell["traffic"]
    if run.device == "cuda":
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
        backend = "nccl"
    else:
        device, backend = torch.device("cpu"), "gloo"
    dist.init_process_group(backend, init_method=address, world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        mesh = mesh_lib.make_mesh(1)
        rows = cfg["batch_size"]
        w = weights.make(cfg, run.seed, device)
        init = ({k: v.clone() for k, v in weights.trainable(cfg, w).items()}
                if rank == 0 else None)
        model, mcfg = program_model(cfg, w, device)
        del w
        trainer = Trainer(model, mcfg.task_names,
                          optimizers.build(mcfg.optimizer, mcfg.learning_rate),
                          TrainerConfig(seed=run.seed, handle_sigterm=False,
                                        model_dir=str(harness.scratch_dir(f"train_dp{rank}"))),
                          device=device, mesh=mesh, global_batch_size=rows * world)
        batches = [local_rows(b, rank, rows)
                   for b in traffic.batches(cfg["schema"], tr, rows * world, run.seed)]
        if rank == 0:
            harness.mark(run, "trainer and batches")
        losses, grad = [], None
        for batch in batches[:CHECKED_STEPS]:
            losses.append(float(trainer.train_step(batch)))
            if grad is None:
                grad = first_grad_norms(trainer, cfg, dist)
        full = trainer.full_state_dict()
        prog = None
        if rank == 0:
            change = {k: float((full[k].double() - init[k].double()).norm()) for k in init}
            prog = {"losses": losses, "grad": grad, "change": change}
        del full, init
        sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
        dist.barrier()
        sync()
        setup_s = time.perf_counter() - run.started

        session = None
        if run.trace and rank == 0:
            from portbench.trace import Session

            session = Session()
            session.start()
        steps, traced, i = 0, None, CHECKED_STEPS
        stop = torch.zeros(1, device=device)
        t0 = time.perf_counter()
        end, trace_end = t0 + run.seconds, t0 + TRACE_SECONDS
        while True:
            trainer.train_step(batches[i % len(batches)])
            i += 1
            steps += 1
            now = time.perf_counter()
            if session is not None and traced is None and now >= trace_end:
                session.stop()
                traced = (CHECKED_STEPS, i)
            if steps % STOP_EVERY == 0:
                stop.fill_(float(rank == 0 and now >= end))
                dist.all_reduce(stop, op=dist.ReduceOp.MAX)
                if stop.item() > 0:
                    break
        dist.barrier()
        sync()
        wall = time.perf_counter() - t0
        if session is not None and traced is None:
            session.stop()
            traced = (CHECKED_STEPS, i)
        out = None
        if rank == 0:
            out = {"prog": prog, "setup_s": setup_s, "steps": steps, "wall": wall,
                   "ex_s": steps * rows * world / wall,
                   "peak": torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0,
                   "trace": None if session is None else session.read("train", cfg, {
                       "steps": traced[1] - traced[0],
                       "examples": (traced[1] - traced[0]) * rows * world})}
        del trainer
        dist.barrier()
        return out
    finally:
        dist.destroy_process_group()


def _child(rank: int, world: int, address: str, run: harness.Run) -> None:
    import sys

    try:
        train_rank(rank, world, address, run)
    except BaseException as e:  # the exit code tells rank 0
        harness.log(f"rank {rank} failed: {type(e).__name__}: {e}")
        sys.exit(1)


def run(run: harness.Run) -> harness.Result:
    import torch.multiprocessing as mp

    world = run.cell["chips"]
    address = f"tcp://localhost:{free_port()}"
    ctx = mp.get_context("spawn")
    children = [ctx.Process(target=_child, args=(r, world, address, run), daemon=True)
                for r in range(1, world)]
    for c in children:
        c.start()
    try:
        got = train_rank(0, world, address, run)
    finally:
        deadline = time.perf_counter() + TIMEOUT_S
        for c in children:
            c.join(max(0.0, deadline - time.perf_counter()))
            if c.is_alive():
                c.kill()
                c.join()
    failed = [r for r, c in enumerate(children, 1) if c.exitcode != 0]
    if failed:
        raise RuntimeError(f"rank(s) {failed} failed (exit codes "
                           f"{[children[r - 1].exitcode for r in failed]})")
    harness.log(f"window: {got['steps']} steps of {world} x {run.cfg['batch_size']} rows in "
                f"{got['wall']:.6f} s, {got['ex_s']:.3f} examples/s, set-up "
                f"{got['setup_s']:.3f} s, rank 0 peak {got['peak']} bytes")
    base.free_device()
    ref = reference_steps(run.cfg, run.cell["traffic"], world, run.seed, run.device)
    numbers = check.train_numbers(got["prog"], ref)
    for name, (value, where) in numbers.items():
        harness.log(f"{name} {value!r} at {where}")
    correct, checks = check.judge(numbers, run.cell["limits"])
    return harness.Result(correct=correct, attempted=got["steps"], failed=0,
                          e2e={"train_ex_s": got["ex_s"], "setup_s": got["setup_s"]},
                          checks=checks, trace=got["trace"], memory_peak_bytes=got["peak"])


def reference_steps(cfg: dict, tr: dict, world: int, seed: int, device,
                    tf32: bool = False) -> dict:
    """The reference's CHECKED_STEPS steps on the global batches from the
    seed's weights, rank r's dropout stream seeded ``seed + 1 + r``."""
    from portbench import reference
    from portbench.reference import bst_dp

    init = weights.trainable(cfg, weights.make(cfg, seed, device))
    params = {k: v.clone() for k, v in init.items()}
    glob = traffic.batches(cfg["schema"], tr, cfg["batch_size"] * world, seed)
    on_device = [base.device_batch(b, device) for b in glob[:CHECKED_STEPS]]
    with reference.precision(tf32):
        losses, first, after = bst_dp.train(params, cfg, on_device, seed + 1, world, device)
    return {"losses": losses, "grad": base._norms(first),
            "change": base._norms({k: after[k] - init[k] for k in init})}
