"""Control readings of a data-parallel training cell (``kinds/train_dp.py``):
the reference in TF32 (the precision below the configuration's float32)
against the reference in float32, on many seeds, on one card.

    python3 portbench/control_dp.py --workload <cell> --seeds 1,2,3 [--out file.json]

The program's own readings are the cell's runs (each run's ``checks``); the
control needs only the reference, which rank 0 runs alone, so it takes one
card where the cell takes several.  Prints one JSON line a seed; with
``--out`` writes them all.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import check, harness  # noqa: E402
from portbench.kinds import train_dp  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    cell = harness.cell(args.workload)
    cfg = harness.config(cell["config"])
    out = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        ref = train_dp.reference_steps(cfg, cell["traffic"], cell["chips"], seed, args.device)
        ctl = train_dp.reference_steps(cfg, cell["traffic"], cell["chips"], seed, args.device,
                                       tf32=True)
        rec = {"control": check.train_numbers(ctl, ref), "seed": seed,
               "seconds_taken": time.perf_counter() - t0}
        print(json.dumps(rec), flush=True)
        out.append(rec)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
