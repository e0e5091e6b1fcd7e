"""What every cell shares: its files found by name, the per-layer readers,
the check that JAX stayed out, and the result line.

A cell is ``workloads/<cell>.json`` (its configuration, kind and traffic
parameters, its limits); its configuration is ``configs/<config>.json``; a
per-layer metric is ``metrics/<metric>.py``.  Which per-layer metrics a cell
reports, and which end-to-end metrics, comes from the entries of
``BENCHMARK.json`` that list the cell.  So a later cell, configuration or
metric is one new file and one new entry; no file here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# Top-level module names that may not be loaded by a run (compared whole:
# the port's own name begins with the JAX package's).
FORBIDDEN = ("jax", "jaxlib", "flax", "recalgorithm_tpu")


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return read_json(ROOT / "BENCHMARK.json")


def cell(name: str) -> dict:
    return read_json(BENCH / "workloads" / f"{name}.json")


def config(name: str) -> dict:
    return read_json(BENCH / "configs" / f"{name}.json")


def metric_module(name: str):
    """The reader of per-layer metric ``name`` (``metrics/<name>.py``)."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _lists(entry: dict, workload: str) -> bool:
    return "workloads" not in entry or workload in entry["workloads"]


def end_to_end(workload: str, bench: dict | None = None) -> list[dict]:
    return [m for m in (bench or benchmark())["end_to_end"] if _lists(m, workload)]


def per_layer(workload: str, bench: dict | None = None) -> list[dict]:
    """The per-layer metrics a cell reports: those whose entry lists it."""
    return [m for m in (bench or benchmark())["per_layer"] if workload in m["workloads"]]


def read_per_layer(workload: str, trace, bench: dict | None = None) -> dict:
    """Each per-layer metric's reader on ``trace``; a reader that finds
    nothing returns None and the metric is left out."""
    out = {}
    for entry in per_layer(workload, bench):
        value = metric_module(entry["name"]).read(trace)
        if value is not None:
            out[entry["name"]] = {"value": float(value), "unit": entry["unit"]}
    return out


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN, whole."""
    return sorted({name for name in list(sys.modules)
                   if name.split(".")[0] in FORBIDDEN})


class GCPauses:
    """Counts the interpreter's garbage collections and the time they hold
    the process, by generation, while installed (a diagnostic for the log)."""

    def __init__(self):
        import gc
        import time

        self._gc, self._clock = gc, time.perf_counter
        self.count = [0, 0, 0]
        self.seconds = [0.0, 0.0, 0.0]
        self.longest = 0.0
        self.pauses: list = []  # (start, seconds) of each collection
        self._start = None

    def __call__(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._start = self._clock()
        elif self._start is not None:
            took = self._clock() - self._start
            g = info["generation"]
            self.count[g] += 1
            self.seconds[g] += took
            self.longest = max(self.longest, took)
            self.pauses.append((self._start, took))

    def __enter__(self):
        self._gc.callbacks.append(self)
        return self

    def __exit__(self, *exc):
        self._gc.callbacks.remove(self)

    def __str__(self) -> str:
        return (f"collections by generation {self.count}, seconds "
                f"{[round(s, 6) for s in self.seconds]}, longest {self.longest:.6f} s")


@dataclasses.dataclass
class Run:
    """What a cell's driver needs."""

    workload: str
    cell: dict
    cfg: dict
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    started: float = 0.0  # perf_counter() at process start


@dataclasses.dataclass
class Result:
    correct: bool
    attempted: int
    failed: int
    e2e: dict                 # name -> value
    checks: dict              # name -> (value, limit)
    trace: object = None      # a trace.Trace in a traced run
    memory_peak_bytes: int = 0


def _finite(x: float) -> float:
    """A number JSON can hold: a NaN or an infinity reads as 1e300."""
    x = float(x)
    return x if x == x and abs(x) != float("inf") else 1e300


def checks_line(checks: dict) -> dict:
    return {name: {"value": _finite(v), "limit": float(lim)} for name, (v, lim) in checks.items()}


def result_line(run: Run, res: Result, device: dict, bench: dict | None = None) -> dict:
    """The last line of standard output, ``checks`` last."""
    bench = bench or benchmark()
    if run.trace:
        metrics = read_per_layer(run.workload, res.trace, bench)
    else:
        units = {m["name"]: m["unit"] for m in end_to_end(run.workload, bench)}
        metrics = {k: {"value": float(v), "unit": units[k]} for k, v in res.e2e.items()
                   if k in units}
    line = {"correct": bool(res.correct), "attempted": int(res.attempted),
            "failed": int(res.failed), "metrics": metrics, "device": device}
    if run.trace and res.trace is not None:
        line["breakdown"] = res.trace.breakdown
    line["checks"] = checks_line(res.checks)
    return line


def print_checks(checks: dict) -> None:
    """Each number compared beside its limit, as the last lines of stderr."""
    for name, (value, limit) in checks.items():
        print(f"check {name} {float(value)!r} limit {float(limit)!r} "
              f"{'ok' if value <= limit else 'FAILED'}", file=sys.stderr, flush=True)


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def mark(run: "Run", phase: str) -> None:
    """Log how far into the process set-up has come."""
    import time

    log(f"set-up: {phase} at {time.perf_counter() - run.started:.3f} s")


def scratch_dir(workload: str) -> Path:
    """A fixed directory for a run's files: under TMPDIR, or the checkout's
    ``build/`` where none is set."""
    base = Path(os.environ["TMPDIR"]) if os.environ.get("TMPDIR") else ROOT / "build"
    path = base / "portbench" / workload
    path.mkdir(parents=True, exist_ok=True)
    return path
