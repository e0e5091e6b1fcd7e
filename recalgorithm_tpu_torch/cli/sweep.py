"""Hyperparameter sweep runner: the reference's result.md grids as one command.

Counterpart of ``recalgorithm_tpu/cli/sweep.py``.  Runs the port's
``cli.main`` once for each point of a JSON grid and writes a markdown table
of every run's final eval metrics:

  python -m recalgorithm_tpu_torch.cli.sweep --model DCN --synthetic \\
      --grid '{"num_cross_layer": [1, 2, 3], "hidden_units": ["512,256,128"]}' \\
      --out result.md --device cuda -- --train_steps 500 --batch_size 512

Grid values are flag strings; the cartesian product runs one point after
another, each in a fresh temporary model directory.  ``--device`` is passed
to every run (default ``cuda``, which raises without a GPU); the arguments
after ``--`` too.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import sys
import tempfile


def main(argv=None) -> list[tuple[dict, dict]]:
    """Run the grid; returns each point's (flags, final eval metrics)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--" in argv:
        split = argv.index("--")
        argv, passthrough = argv[:split], argv[split + 1:]
    else:
        passthrough = []

    p = argparse.ArgumentParser()
    p.add_argument("--model", required=True)
    p.add_argument("--grid", required=True, help="JSON: flag -> list of values")
    p.add_argument("--out", default="result.md")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--device", default="cuda", help="passed to every run of cli.main")
    args = p.parse_args(argv)

    from recalgorithm_tpu_torch.cli.main import main as train_main

    grid: dict[str, list] = json.loads(args.grid)
    keys = sorted(grid)
    rows = []
    for combo in itertools.product(*(grid[k] for k in keys)):
        flags = []
        for k, v in zip(keys, combo):
            flags += [f"--{k}", str(v)]
        with tempfile.TemporaryDirectory() as model_dir:
            run_argv = (["--model", args.model, "--model_dir", model_dir,
                         "--device", args.device]
                        + (["--synthetic"] if args.synthetic else [])
                        + flags + passthrough
                        + ["--predictions_csv", os.path.join(model_dir, "p.csv")])
            print(f"=== sweep: {dict(zip(keys, combo))}")
            metrics = train_main(run_argv)
        rows.append((dict(zip(keys, combo)), metrics))

    metric_names = sorted(rows[0][1]) if rows else []
    with open(args.out, "w") as f:
        f.write(f"# {args.model} sweep\n\n")
        f.write("| " + " | ".join(keys + metric_names) + " |\n")
        f.write("|" + "---|" * (len(keys) + len(metric_names)) + "\n")
        for combo, metrics in rows:
            cells = [str(combo[k]) for k in keys] + [f"{metrics[m]:.6f}" for m in metric_names]
            f.write("| " + " | ".join(cells) + " |\n")
    print(f"wrote {args.out} ({len(rows)} rows)")
    return rows


if __name__ == "__main__":
    main()
