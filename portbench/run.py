"""The port's benchmark: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The run loads, warms up its own cell's shapes,
measures for ``--seconds``, checks what the timed path produced against the
plain reference, and prints as its last line one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device``, with ``--trace 1`` also
``breakdown``, and last ``checks`` (each number compared, with its limit).
It exits with 1 and prints no result where there is no CUDA card or fewer
cards than the cell asks for, and where a module of JAX or of the JAX package
is loaded once the window has closed.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import harness  # noqa: E402

# Kernel caches at fixed paths inside the checkout, so only a checkout's
# first run builds (the port's own nvcc libraries already go to build/).
for _var, _dir in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ.setdefault(_var, str(harness.ROOT / "build" / _dir))


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def device_info(res: harness.Result, trace: bool, chips: int) -> dict:
    import torch

    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": int(res.memory_peak_bytes)}
    if trace and res.trace is not None:
        info["busy_s"] = res.trace.busy_s
        info["window_s"] = res.trace.window_s
    return info


def main(argv=None) -> int:
    args = parse(argv)
    cell = harness.cell(args.workload)
    import torch

    harness.log(f"set-up: torch imported at {time.perf_counter() - STARTED:.3f} s")
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        harness.log(f"{args.workload} needs {cell['chips']} CUDA device(s); "
                    f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 1
    from portbench.kinds import kind

    run = harness.Run(workload=args.workload, cell=cell, cfg=harness.config(cell["config"]),
                      seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                      started=STARTED)
    res = kind(cell["kind"]).run(run)
    loaded = harness.forbidden_modules()
    if loaded:
        harness.log(f"forbidden modules loaded: {', '.join(loaded)}")
        return 1
    line = harness.result_line(run, res, device_info(res, run.trace, cell["chips"]))
    harness.print_checks(res.checks)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
