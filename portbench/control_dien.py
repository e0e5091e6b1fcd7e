"""Readings that set the limits of a DIEN cell (``kinds/train_dien.py``): the
program's numbers on many seeds, and the control's (the reference in TF32,
the precision below the configuration's float32) on the same seeds, in one
process, as ``control_dlrm.py`` reads DLRM-DCNv2's cell.

    python3 portbench/control_dien.py --workload <cell> --seeds 1,2,3
        [--fault half_batch|agru|aux_dropped|unchanged_state] [--out file.json]

Set-up's three checked steps, no window.  With ``--fault`` plants one of
:data:`FAULTS` for this process.  Prints one JSON line a seed, each with
the limits the control's numbers exceed; with ``--out`` writes them all.
The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import check, faults, harness, weights  # noqa: E402
from portbench.kinds import train_dien  # noqa: E402
from portbench.traffic import train as traffic  # noqa: E402


def agru(patch) -> None:
    """The interest evolution runs AGRU (the attention replaces the update
    gate) where the configuration asks for AUGRU."""
    from recalgorithm_tpu_torch.models.dien import DIEN

    inner = DIEN.__init__

    def built(self, *args, **kwargs):
        inner(self, *args, **kwargs)
        self.evolution.cell_type = "AGRU"

    patch(DIEN, "__init__", built)


def aux_dropped(patch) -> None:
    """The auxiliary loss is left out of the training loss."""
    from recalgorithm_tpu_torch.models.dien import DIEN

    patch(DIEN, "_auxiliary_loss", lambda self, h, seq, lengths: h.new_zeros(()))


FAULTS = {**faults.TRAIN, "agru": agru, "aux_dropped": aux_dropped}


def readings(cell: dict, cfg: dict, seed: int, device: str) -> dict:
    w = weights.make(cfg, seed, device)
    init = {k: v.clone() for k, v in weights.trainable(cfg, w).items()}
    trainer = train_dien.make_trainer(cfg, w, seed, device)
    batches = traffic.batches(cfg["schema"], cell["traffic"], cfg["batch_size"], seed)
    prog = train_dien.program_steps(trainer, cfg, batches, init)
    replays = getattr(trainer, "replays", 0)
    del trainer, w, init
    train_dien.base.free_device()
    ref = train_dien.reference_steps(cfg, seed, batches, device)
    ctl = train_dien.reference_steps(cfg, seed, batches, device, tf32=True)
    out = {"program": check.train_numbers(prog, ref), "control": check.train_numbers(ctl, ref)}
    limits = cell["limits"]
    out["control_fails"] = sorted(k for k, (v, _) in out["control"].items() if v > limits[k])
    out["program_fails"] = sorted(k for k, (v, _) in out["program"].items() if v > limits[k])
    out["replays"] = replays
    return out


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
