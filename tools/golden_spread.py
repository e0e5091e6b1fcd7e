"""Rerun the golden recipe of tests/golden_common.py over several init seeds.

    JAX_PLATFORMS=cpu python tools/golden_spread.py --package torch --seeds 10 MaskNet DCNv2
    JAX_PLATFORMS=cpu python tools/golden_spread.py --package jax --seeds 10 MaskNet

Each run keeps the data of the recipe's seed and varies the seed of the
weights and the dropout stream: ``--package jax`` through
``golden_common.run_golden``, ``--package torch`` through
``chip_smoke.golden_auc`` (the port's copy of the recipe, on ``--device``).
Prints each run's AUC of every task, then each model's mean and standard
deviation of each task beside its band of tests/golden_bands.json: how
often one draw lands outside the band that ``chip_smoke.py`` gates on.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("models", nargs="+")
    p.add_argument("--package", choices=("torch", "jax"), required=True)
    p.add_argument("--seeds", type=int, default=10, help="init seeds 0 .. N-1")
    p.add_argument("--device", default="cpu", help="the port's device (--package torch)")
    args = p.parse_args()
    if args.package == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        from tests import golden_common

        def run(name, model_dir, seed):
            return golden_common.run_golden(name, model_dir, seed=seed)
    else:
        import chip_smoke

        def run(name, model_dir, seed):
            return chip_smoke.golden_auc(name, args.device, model_dir, init_seed=seed)

    with open(os.path.join(REPO, "tests", "golden_bands.json")) as f:
        bands = json.load(f)
    with tempfile.TemporaryDirectory() as work:
        for name in args.models:
            runs = []
            for seed in range(args.seeds):
                runs.append(run(name, os.path.join(work, f"{name}_{seed}"), seed))
                print(f"{args.package} {name} seed {seed}: " + " ".join(
                    f"{k} {float(v):.5f}" for k, v in sorted(runs[-1].items())), flush=True)
            for key in sorted(runs[0]):
                aucs = [float(r[key]) for r in runs]
                center = bands[name]["auc"][key]
                width = bands[name]["band"][key]
                outside = sum(abs(a - center) > width for a in aucs)
                print(f"{args.package} {name} {key}: mean {np.mean(aucs):.5f} std "
                      f"{np.std(aucs, ddof=1):.5f} over {args.seeds} seeds; band {center} +- "
                      f"{width}: {outside} outside", flush=True)


if __name__ == "__main__":
    main()
