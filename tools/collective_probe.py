#!/usr/bin/env python3
"""Which torch.distributed collectives the gloo backend runs on CUDA tensors.

    python3 tools/collective_probe.py [--device cuda|cpu] [--world 2]

Spawns ``--world`` processes (a ``file://`` store under a temporary
directory) that share one device over gloo, as the port's several-process
runs on one card do (NCCL refuses two ranks on one device).  Each rank runs
every collective that ``recalgorithm_tpu_torch`` uses, on the world group and
on a subgroup, on tensors of ``--device``, and checks the result.  Prints
one line per collective (ok, or the exception) and the torch build; exits
non-zero if any collective failed or a rank did not finish.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import traceback

RANK_TIMEOUT_S = 240


def _checks(dist, torch, device, rank: int, world: int, group) -> dict[str, str]:
    """Each collective on ``group`` (ranks 0..world-1 in order), checked."""
    out: dict[str, str] = {}

    def run(name, fn):
        try:
            fn()
            out[name] = "ok"
        except Exception as exc:  # recorded: the probe reports what fails
            out[name] = f"{type(exc).__name__}: {str(exc).splitlines()[0][:200]}"

    def full(value, n=4, dtype=torch.float32):
        return torch.full((n,), float(value), dtype=dtype, device=device)

    def all_reduce(op, want):
        t = full(rank + 1)
        dist.all_reduce(t, op=op, group=group)
        assert torch.equal(t.cpu(), full(want).cpu()), t

    run("all_reduce_sum", lambda: all_reduce(dist.ReduceOp.SUM, world * (world + 1) / 2))
    run("all_reduce_max", lambda: all_reduce(dist.ReduceOp.MAX, world))
    run("all_reduce_min", lambda: all_reduce(dist.ReduceOp.MIN, 1))

    def all_reduce_int():
        t = torch.tensor([rank, 1], dtype=torch.int64, device=device)
        dist.all_reduce(t, group=group)
        assert t.tolist() == [world * (world - 1) // 2, world], t

    run("all_reduce_int64", all_reduce_int)

    def broadcast():
        t = full(7.0 if rank == 0 else -1.0)
        dist.broadcast(t, src=0, group=group)
        assert (t == 7.0).all(), t

    run("broadcast", broadcast)

    def all_gather_list():
        parts = [full(-1) for _ in range(world)]
        dist.all_gather(parts, full(rank), group=group)
        assert [float(p[0]) for p in parts] == list(range(world)), parts

    run("all_gather", all_gather_list)

    def all_gather_into_tensor():
        out_t = torch.empty(world * 4, device=device)
        dist.all_gather_into_tensor(out_t, full(rank), group=group)
        assert out_t.reshape(world, 4)[:, 0].tolist() == list(range(world)), out_t

    run("all_gather_into_tensor", all_gather_into_tensor)

    def reduce_scatter_tensor():
        inp = torch.arange(world * 4, dtype=torch.float32, device=device)
        out_t = torch.empty(4, device=device)
        dist.reduce_scatter_tensor(out_t, inp, group=group)
        want = world * torch.arange(rank * 4, rank * 4 + 4, dtype=torch.float32)
        assert torch.equal(out_t.cpu(), want), out_t

    run("reduce_scatter_tensor", reduce_scatter_tensor)

    def reduce_scatter_list():
        inp = [full(r) for r in range(world)]
        out_t = torch.empty(4, device=device)
        dist.reduce_scatter(out_t, inp, group=group)
        assert (out_t == world * rank).all(), out_t

    run("reduce_scatter", reduce_scatter_list)

    def all_to_all_single():
        inp = torch.arange(world, dtype=torch.float32, device=device) + 10 * rank
        out_t = torch.empty(world, device=device)
        dist.all_to_all_single(out_t, inp, group=group)
        assert out_t.tolist() == [10 * r + rank for r in range(world)], out_t

    run("all_to_all_single", all_to_all_single)

    def all_gather_object():
        objs = [None] * world
        dist.all_gather_object(objs, {"rank": rank}, group=group)
        assert [o["rank"] for o in objs] == list(range(world)), objs

    run("all_gather_object", all_gather_object)
    run("barrier", lambda: dist.barrier(group=group))
    return out


def rank_main(rank: int, world: int, store: str, device_name: str) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    if device_name == "cuda":
        torch.cuda.set_device(0)
    device = torch.device(device_name)
    dist.init_process_group("gloo", init_method=f"file://{store}", world_size=world, rank=rank)
    try:
        results = {"world": _checks(dist, torch, device, rank, world, None)}
        sub = dist.new_group(list(range(world)))
        results["subgroup"] = _checks(dist, torch, device, rank, world, sub)
        print("RESULT " + json.dumps(results), flush=True)
    finally:
        dist.destroy_process_group()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--store", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.rank is not None:
        rank_main(args.rank, args.world, args.store, args.device)
        return 0

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("collective_probe: no CUDA device", file=sys.stderr)
        return 1
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"gloo available {torch.distributed.is_gloo_available()}; "
          f"nccl available {torch.distributed.is_nccl_available()}; device {args.device}"
          + (f" ({torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()})"
             if args.device == "cuda" else ""), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--device", args.device,
             "--world", str(args.world), "--rank", str(r), "--store", store],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(args.world)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=RANK_TIMEOUT_S))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    failed = False
    per_rank = []
    for r, (p, (stdout, stderr)) in enumerate(zip(procs, outs)):
        lines = [ln for ln in stdout.splitlines() if ln.startswith("RESULT ")]
        if p.returncode != 0 or not lines:
            print(f"rank {r}: exit {p.returncode}\n{stderr[-3000:]}")
            failed = True
            continue
        per_rank.append(json.loads(lines[-1][len("RESULT "):]))
    if per_rank:
        for scope in ("world", "subgroup"):
            for name in per_rank[0][scope]:
                verdicts = {res[scope][name] for res in per_rank}
                verdict = verdicts.pop() if len(verdicts) == 1 else " | ".join(sorted(verdicts))
                failed |= verdict != "ok"
                print(f"{scope:9s} {name:24s} {verdict}")
    return 1 if failed else 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:
        traceback.print_exc()
        sys.exit(1)
