#!/usr/bin/env python3
"""Phase 17's step-timer gate of chip_smoke.py, repeated: ``--runs`` fresh
processes, each of which builds BST at full width (the real WeChat tables,
B=4096, the config defaults, weights from a seed) and reads
``chip_smoke.step_timer_rounds`` on its train step: utils.benchmarking's
``loop_step_time_us`` against CUDA events around the same step, read in
turns, and the timer's slope of 2 stacked steps against one.

    python3 tools/timer_repeat.py [--runs 10]

Prints each run's two ratios (the timer's step over the events', 2 stacked
steps over one), their range, the limits chip_smoke.py holds them to
(``TIMER_TOL``, ``STACKED``) and the card's name and power limit; exits
non-zero if a run falls outside those limits.  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import tempfile

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def one_run(model_dir: str) -> dict:
    """One process's reading: the medians of ``step_timer_rounds``."""
    from recalgorithm_tpu_torch.data.synthetic import SyntheticConfig, SyntheticWeChat
    from recalgorithm_tpu_torch.features.schema import wechat_schema
    from recalgorithm_tpu_torch.models.bst import BST, BSTConfig
    from recalgorithm_tpu_torch.train import optimizers
    from recalgorithm_tpu_torch.train.loop import Trainer, TrainerConfig

    cs = _chip_smoke()
    gen = SyntheticWeChat(wechat_schema(), SyntheticConfig(seed=7, vocab_scale=1.0))
    schema = wechat_schema(gen.vocab_sizes())
    cfg = BSTConfig()
    tr = Trainer(BST(cfg, schema, torch.Generator().manual_seed(0)),
                 tuple(cfg.task_names) or (schema.labels[0],),
                 optimizers.build(cfg.optimizer, cfg.learning_rate),
                 TrainerConfig(model_dir=model_dir), device="cuda")
    events_us, t1, t2 = cs.step_timer_rounds(
        tr, [gen.batch(cs.BST_BATCH, 10 + i) for i in range(4)])
    return {"events_us": events_us, "timer_us": t1, "stacked_us": t2,
            "timer_vs_events": t1 / events_us, "stacked_vs_one": t2 / t1}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=10)
    ap.add_argument("--one-run", metavar="MODEL_DIR", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("timer_repeat: no CUDA device", file=sys.stderr)
        return 1
    if args.one_run:
        print(json.dumps(one_run(args.one_run)), flush=True)
        return 0
    cs = _chip_smoke()
    card = cs.card_line()
    print(card, flush=True)
    work = tempfile.mkdtemp(prefix="timer_repeat_")
    runs = []
    for run in range(args.runs):
        done = subprocess.run([sys.executable, os.path.abspath(__file__), "--one-run",
                               os.path.join(work, str(run))], timeout=600,
                              capture_output=True, text=True)
        if done.returncode:
            print(done.stdout[-4000:], done.stderr[-4000:], file=sys.stderr)
            return 1
        lines = done.stdout.strip().splitlines()
        runs.append(json.loads(lines[-1]))
        print(f"run {run}: {lines[-2]}\n  {json.dumps(runs[-1])}", flush=True)
    ratios = [r["timer_vs_events"] for r in runs]
    stacked = [r["stacked_vs_one"] for r in runs]
    inside = [abs(a - 1.0) <= cs.TIMER_TOL and cs.STACKED[0] <= b <= cs.STACKED[1]
              for a, b in zip(ratios, stacked)]
    print(f"{card}: {args.runs} runs; the timer over CUDA events {min(ratios):.4f} to "
          f"{max(ratios):.4f} (limit 1 +- {cs.TIMER_TOL}); 2 stacked steps over one "
          f"{min(stacked):.4f} to {max(stacked):.4f} (limits {cs.STACKED}); "
          f"{sum(inside)} of {args.runs} inside", flush=True)
    return 0 if all(inside) else 1


if __name__ == "__main__":
    sys.exit(main())
