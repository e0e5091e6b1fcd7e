#!/usr/bin/env python3
"""The PAD-compacted table gradient (ops/compact_scatter.py) end to end:
BST's and DIN's default train steps at full width (the real WeChat tables,
B=4096, weights from a seed) with and without it.

    python3 tools/compact_ab.py [--rounds 7] [--parent DIR]

In one process, four trainers (BST and DIN, each with
``compact_grad_scatter`` on, the default, and off) are read in turns for
``--rounds`` rounds; each reading is the step's device ms from CUDA events
around STEP_ITERS steps back to back and the median host wall of STEP_ITERS
synchronized steps.  With ``--parent DIR`` (an unpacked checkout of another
commit, e.g. ``git archive`` of the parent into a gitignored directory) the
default step of that tree and of this one are then read in fresh processes
in the order parent, this, this, parent, each process ``--rounds`` rounds
of both models.  Prints every reading, the medians, and the card's name and
power limit.  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = ("BST", "DIN")
BATCH = 4096
STEP_ITERS = 20


def trainers(configs: dict[str, dict], model_dir: str) -> tuple[dict, list]:
    """A trainer for each model and each named TrainerConfig override set,
    on cuda, and the synthetic batches they are fed.  Uses only what every
    slice of the port has, so a checkout of an earlier commit runs it."""
    from recalgorithm_tpu_torch.data.synthetic import SyntheticConfig, SyntheticWeChat
    from recalgorithm_tpu_torch.features.schema import wechat_schema
    from recalgorithm_tpu_torch.models import get_model
    from recalgorithm_tpu_torch.train import optimizers
    from recalgorithm_tpu_torch.train.loop import Trainer, TrainerConfig

    gen = SyntheticWeChat(wechat_schema(), SyntheticConfig(seed=7, vocab_scale=1.0))
    schema = wechat_schema(gen.vocab_sizes())
    out = {}
    for name in MODELS:
        cfg_cls, cls = get_model(name)
        cfg = cfg_cls()
        for label, overrides in configs.items():
            out[name, label] = Trainer(
                cls(cfg, schema, torch.Generator().manual_seed(0)),
                tuple(cfg.task_names) or (schema.labels[0],),
                optimizers.build(cfg.optimizer, cfg.learning_rate),
                TrainerConfig(model_dir=os.path.join(model_dir, f"{name}_{label}"),
                              **overrides), device="cuda")
    return out, [gen.batch(BATCH, 10 + i) for i in range(4)]


def reading(tr, batches) -> tuple[float, float]:
    """(device ms a step from CUDA events over STEP_ITERS steps back to back,
    median host wall ms of STEP_ITERS synchronized steps)."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(STEP_ITERS):
        tr.train_step(batches[i % len(batches)])
    end.record()
    end.synchronize()
    walls = []
    for i in range(STEP_ITERS):
        t0 = time.perf_counter()
        tr.train_step(batches[i % len(batches)])
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return start.elapsed_time(end) / STEP_ITERS, float(np.median(walls))


def interleaved(configs: dict[str, dict], rounds: int) -> dict[str, list]:
    """Every (model, config) trainer read once a round, in turns."""
    trs, batches = trainers(configs, tempfile.mkdtemp(prefix="compact_ab_"))
    for tr in trs.values():
        for b in batches[:3]:
            tr.train_step(b)
    readings = {f"{name} {label}": [] for name, label in trs}
    for _ in range(rounds):
        for (name, label), tr in trs.items():
            readings[f"{name} {label}"].append(reading(tr, batches))
    return readings


def summary(readings: dict[str, list]) -> dict[str, dict]:
    return {k: {"events_ms": float(np.median([e for e, _ in v])),
                "wall_ms": float(np.median([w for _, w in v])), "n": len(v)}
            for k, v in readings.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=7)
    ap.add_argument("--parent", help="an unpacked checkout to compare the default step with")
    ap.add_argument("--worker", metavar="ROOT", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("compact_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.worker or REPO))
    if args.worker:  # the tree's default step, both models
        print(json.dumps(interleaved({"default": {}}, args.rounds)), flush=True)
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    readings = interleaved({"compact": {"compact_grad_scatter": True},
                            "full": {"compact_grad_scatter": False}}, args.rounds)
    print("in one process, read in turns (events ms, wall ms): "
          + json.dumps({k: [tuple(round(x, 4) for x in r) for r in v]
                        for k, v in readings.items()}), flush=True)
    med = summary(readings)
    for name in MODELS:
        c, f = med[f"{name} compact"], med[f"{name} full"]
        print(f"{card}: {name} B={BATCH} default step, medians of {args.rounds} rounds: "
              f"compact {c['events_ms']} ms (events), {c['wall_ms']} ms (wall); full "
              f"{f['events_ms']} ms, {f['wall_ms']} ms; compact / full "
              f"{c['events_ms'] / f['events_ms']:.4f} (events), "
              f"{c['wall_ms'] / f['wall_ms']:.4f} (wall)", flush=True)
    if not args.parent:
        return 0
    trees = {"parent": os.path.abspath(args.parent), "this": REPO}
    pooled: dict[str, list] = {}
    for tree in ("parent", "this", "this", "parent"):
        done = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", trees[tree],
                               "--rounds", str(args.rounds)], cwd=trees[tree], timeout=900,
                              capture_output=True, text=True,
                              env=dict(os.environ, PYTHONPATH=trees[tree]))
        if done.returncode:
            print(done.stdout[-4000:], done.stderr[-4000:], file=sys.stderr)
            return 1
        got = json.loads(done.stdout.strip().splitlines()[-1])
        print(f"{tree} ({trees[tree]}), a fresh process: "
              + json.dumps({k: [tuple(round(x, 4) for x in r) for r in v] for k, v in got.items()}),
              flush=True)
        for k, v in got.items():
            pooled.setdefault(f"{tree} {k}", []).extend(v)
    med = summary(pooled)
    for name in MODELS:
        p, t = med[f"parent {name} default"], med[f"this {name} default"]
        print(f"{card}: {name} B={BATCH} default step, parent vs this tree, medians of "
              f"{p['n']} readings each from 2 processes: parent {p['events_ms']} ms (events), "
              f"{p['wall_ms']} ms (wall); this {t['events_ms']} ms, {t['wall_ms']} ms; this / "
              f"parent {t['events_ms'] / p['events_ms']:.4f} (events), "
              f"{t['wall_ms'] / p['wall_ms']:.4f} (wall)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
