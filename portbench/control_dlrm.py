"""Readings that set the limits of a DLRM-DCNv2 cell (``kinds/train_dlrm.py``):
the program's numbers on many seeds, and the control's (the reference in
TF32, the precision below the configuration's float32) on the same seeds,
in one process, as ``control.py`` reads the other training cells.

    python3 portbench/control_dlrm.py --workload <cell> --seeds 1,2,3
        [--fault half_batch|unchanged_state|table_unmoved] [--out file.json]

Set-up's three checked steps, no window.  With ``--fault`` plants one of
:data:`FAULTS` for this process.  Prints one JSON line a seed; with
``--out`` writes them all.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import check, faults, harness  # noqa: E402
from portbench.kinds import train_dlrm  # noqa: E402
from portbench.traffic import criteo  # noqa: E402


def table_unmoved(patch) -> None:
    """The optimizer leaves the largest leaf (a table) out of every update:
    no gradient reaches its accumulator and its rows never move."""
    from recalgorithm_tpu_torch.train import optimizers

    inner = optimizers.Adagrad.step

    def skip_largest(self):
        params = [p for group in self.param_groups for p in group["params"]]
        max(params, key=lambda p: p.numel()).grad = None
        inner(self)

    patch(optimizers.Adagrad, "step", skip_largest)


FAULTS = {**faults.TRAIN, "table_unmoved": table_unmoved}


def readings(cell: dict, cfg: dict, seed: int, device: str) -> dict:
    trainer = train_dlrm.make_trainer(cfg, seed, device)
    batches = criteo.batches(cfg, cell["traffic"], cfg["batch_size"], seed)
    prog = train_dlrm.program_steps(trainer, cfg, seed, batches)
    del trainer
    train_dlrm.base.free_device()
    ref = train_dlrm.reference_steps(cfg, seed, batches, device)
    ctl = train_dlrm.reference_steps(cfg, seed, batches, device, tf32=True)
    return {"program": check.train_numbers(prog, ref), "control": check.train_numbers(ctl, ref)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--fault", choices=tuple(FAULTS), default=None)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    cell = harness.cell(args.workload)
    cfg = harness.config(cell["config"])
    if args.fault:
        FAULTS[args.fault](setattr)
    out = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        rec = readings(cell, cfg, seed, args.device)
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
