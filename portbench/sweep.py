"""The knee of a serving cell: the highest offered rate the system sustains.

    python3 portbench/sweep.py --workload <serving cell> --rates 100,200,400
        [--seconds 8] [--seed 1] [--out file.json]

One process builds the cell's predictor and batcher once, then offers each
rate for ``--seconds`` as the cell's traffic (its file's parameters, the
rate replaced).  For each rate it reports the offered and answered rates
(requests whose last answer came inside the window, over the window), p50
and p99, how late the generator ran, and whether the backlog grew: the rule
is that the last answer came more than ``DRAIN_S`` after the window closed,
or that the median latency is more than ``GROWTH`` times the median at the
lowest rate swept (the unloaded latency; requests wait in a queue that
builds up).  The knee is the highest rate below the first that grows.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from portbench import harness  # noqa: E402
from portbench.kinds import serve  # noqa: E402
from portbench.traffic import serve as traffic  # noqa: E402

GROWTH = 2.0
DRAIN_S = 0.5


def point(served, cfg: dict, cell: dict, rate: float, seconds: float, seed: int) -> dict:
    tr = dict(cell["traffic"], rate_rps=rate)
    reqs = traffic.requests(cfg["schema"], tr, seconds, seed)
    win = serve.drive(served, reqs, seconds, drain=30.0)
    answered_in_window = int(np.sum(reqs.arrivals + win.latency_ms / 1e3 <= seconds))
    rows = np.diff(reqs.offsets)
    return {"offered_rps": rate, "requests": len(reqs),
            "answered_rps": answered_in_window / seconds,
            "candidates_per_s": float(rows.sum()) / seconds,
            "p50_ms": float(np.percentile(win.latency_ms, 50)),
            "p99_ms": float(np.percentile(win.latency_ms, 99)),
            "failed": int(win.failed.sum()),
            "generator_late_p99_ms": float(np.percentile(win.late_ms, 99)),
            "drain_s": win.answered_s - seconds}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    cell = harness.cell(args.workload)
    cfg = harness.config(cell["config"])
    served = serve.build(cfg, args.seed, args.device, args.workload)
    serve.warm(served, traffic.requests(cfg["schema"], cell["traffic"], 1.0, args.seed))
    points = []
    for rate in sorted(float(r) for r in args.rates.split(",")):
        points.append(point(served, cfg, cell, rate, args.seconds, args.seed))
        print(json.dumps(points[-1]), file=sys.stderr, flush=True)
    served.batcher.close()
    unloaded = points[0]["p50_ms"]
    for q in points:
        q["grows"] = bool(q["drain_s"] > DRAIN_S or q["p50_ms"] > GROWTH * unloaded)
    sustained = [q["offered_rps"] for q in points if not q["grows"] and not q["failed"]]
    first_growth = min([q["offered_rps"] for q in points if q["grows"] or q["failed"]],
                       default=None)
    knee = max([r for r in sustained if first_growth is None or r < first_growth],
               default=None)
    summary = {"workload": args.workload, "knee_rps": knee, "points": points}
    print(json.dumps(summary), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
