"""Helpers of the port's several-process CPU tests: start a gloo world of
``tests/torch_dist_worker.py`` ranks and read their results, and write the
inputs (JAX weights, global batches) the ranks read.

Every rank gets a hard timeout, so a hang fails one test instead of running
the suite into its time limit; the ranks meet through a ``file://`` store
under the test's tmp_path, never a TCP port; each runs on one CPU thread."""

import json
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_dist_worker.py")
RANK_TIMEOUT_S = 240


def start_ranks(argv_of_rank, world: int, timeout: float = RANK_TIMEOUT_S,
                cuda: bool = False):
    """Start ``world`` processes (``argv_of_rank(rank)``) with the repository
    on the path and one CPU thread each (and no card unless ``cuda``).
    Returns a function that waits for all (``timeout`` seconds from its
    call), kills any left, fails with the first failing rank's stderr and
    returns each rank's stdout."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    if not cuda:
        env["CUDA_VISIBLE_DEVICES"] = ""
    procs = [subprocess.Popen(argv_of_rank(r), env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(world)]

    def finish() -> list[str]:
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=timeout))
        finally:
            for p in procs:  # a rank left behind by a failure or a timeout
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        for r, (p, (_, stderr)) in enumerate(zip(procs, outs)):
            assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{stderr[-4000:]}"
        return [out for out, _ in outs]

    return finish


def start_world(tmp_path, scenario: str, world: int, in_dir):
    """Start ``scenario`` of the worker on ``world`` ranks; returns a
    function that waits for them and returns the directory of their
    results."""
    out_dir = tmp_path / f"{scenario}_w{world}"
    out_dir.mkdir()
    store = tmp_path / f"store_{scenario}_w{world}"
    finish = start_ranks(lambda r: [sys.executable, WORKER, scenario, str(r), str(world),
                                    str(store), str(in_dir), str(out_dir)], world,
                         cuda=scenario.endswith("_cuda"))
    return lambda: finish() and str(out_dir)


def run_world(tmp_path, scenario: str, world: int, in_dir) -> str:
    """Run ``scenario`` of the worker on ``world`` ranks; returns the
    directory of their results."""
    return start_world(tmp_path, scenario, world, in_dir)()


def result(out_dir: str, name: str, rank: int = 0) -> dict[str, np.ndarray]:
    with np.load(os.path.join(out_dir, f"{name}.r{rank}.npz")) as z:
        return {k: z[k] for k in z.files}


def flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def write_weights(in_dir, tag: str, variables) -> None:
    """A JAX ``{"params", "batch_stats"}`` tree as ``in_dir/tag/params.npz``
    (the export layout ``convert.load_export`` reads)."""
    os.makedirs(os.path.join(in_dir, tag), exist_ok=True)
    np.savez(os.path.join(in_dir, tag, "params.npz"),
             **{"/".join(p): v for p, v in flat(variables).items()})


def write_batches(in_dir, tag: str, batches) -> None:
    np.savez(os.path.join(in_dir, f"{tag}_batches.npz"),
             **{f"b{i}/{k}": v for i, hb in enumerate(batches) for k, v in hb.items()})


def write_vocab_sizes(in_dir, sizes) -> None:
    with open(os.path.join(in_dir, "vocab_sizes.json"), "w") as f:
        json.dump(dict(sizes), f)
