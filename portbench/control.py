"""Readings that set a cell's limits: the program's numbers on many seeds,
and the control's (the reference in TF32, the precision below the
configuration's float32) on the same seeds, in one process.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 [--seconds 20]
        [--fault half_batch] [--out file.json]

Training: set-up's three checked steps, no window.  Serving: a window of
``--seconds`` at the cell's own rate, every answer compared.  With
``--fault`` plants one of ``portbench/faults.py``'s training faults for
this process (``half_batch``: the loss takes the first half of each batch
only).  Prints one JSON line a seed; with ``--out`` writes them all.  The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from portbench import check, faults, harness, weights  # noqa: E402
from portbench.kinds import serve, train  # noqa: E402
from portbench.traffic import serve as serve_traffic  # noqa: E402
from portbench.traffic import train as train_traffic  # noqa: E402


def train_readings(cell: dict, cfg: dict, seed: int, device: str) -> dict:
    w = weights.make(cfg, seed, device)
    init = {k: v.clone() for k, v in weights.trainable(cfg, w).items()}
    trainer = train.make_trainer(cfg, w, seed, device)
    batches = train_traffic.batches(cfg["schema"], cell["traffic"], cfg["batch_size"], seed)
    prog = train.program_steps(trainer, cfg, batches, init)
    del trainer, w, init
    train.free_device()
    ref = train.reference_steps(cfg, seed, batches, device)
    ctl = train.reference_steps(cfg, seed, batches, device, tf32=True)
    return {"program": check.train_numbers(prog, ref), "control": check.train_numbers(ctl, ref)}


def serve_readings(workload: str, cell: dict, cfg: dict, seed: int, seconds: float,
                   device: str) -> dict:
    reqs = serve_traffic.requests(cfg["schema"], cell["traffic"], seconds, seed)
    served = serve.build(cfg, seed, device, workload)
    serve.warm(served, reqs)
    win = serve.drive(served, reqs, seconds)
    served.batcher.close()
    del served
    train.free_device()
    answered = np.flatnonzero(~np.isnan(win.probs))
    ref = serve.reference_probs(cfg, seed, reqs, answered, device)
    ctl = serve.reference_probs(cfg, seed, reqs, answered, device, tf32=True)
    return {"program": {"prob_gap": (float(np.abs(win.probs[answered] - ref).max()), "")},
            "control": {"prob_gap": (float(np.abs(ctl - ref).max()), "")},
            "answered": int(len(answered)), "failed": int(win.failed.sum()),
            "p99_ms": float(np.percentile(win.latency_ms, 99))}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--fault", choices=tuple(faults.TRAIN), default=None)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    cell = harness.cell(args.workload)
    cfg = harness.config(cell["config"])
    if args.fault:
        faults.TRAIN[args.fault](setattr)
    out = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        if cell["kind"] == "train":
            rec = train_readings(cell, cfg, seed, args.device)
        else:
            rec = serve_readings(args.workload, cell, cfg, seed, args.seconds, args.device)
        rec.update(seed=seed, fault=args.fault, seconds_taken=time.perf_counter() - t0)
        print(json.dumps(rec), flush=True)
        out.append(rec)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
