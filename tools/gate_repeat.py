#!/usr/bin/env python3
"""Phase 8's gate of chip_smoke.py, repeated: the BST train step on the card
held to the CPU step ``--runs`` times, each card step in a fresh process,
then the same gate on planted faults, which it must refuse.

    python3 tools/gate_repeat.py [--runs 10]

Builds phase 8's repeatable weights and its CPU reference once
(``chip_smoke.repeatable_weights``, ``chip_smoke.step_reference``: the f32
and f64 CPU steps and the tables' term magnitudes), then starts one
process per run that loads the weights, takes the full-width BST step on the
card (B=4096, dropout 0) and saves its loss and gradients; each run is held
to the reference by ``chip_smoke.step_gradient_ratios``.  The planted faults
(FAULT = 1e-3, far below any real gradient's size): a card step whose
attention passes back dk x (1 + FAULT) (its own process, the kernels
unchanged), and run 0's feedid table gradient, then that table's row of the
largest |gradient|, times (1 + FAULT).  Prints each run's worst tensor and
its share of the allowance, each planted fault's, and the card's name and
power limit; exits non-zero if a clean run fails the gate or a planted fault
passes it.  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
FAULT = 1e-3
FEEDID = "embedder.embed.tables.feedid"


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def card_step(weights: str, out: str, plant_dk: bool = False) -> None:
    """One run: the card's step on the weights' batch, saved to ``out``;
    with ``plant_dk`` the attention's key gradient is scaled by 1 + FAULT."""
    cs = _chip_smoke()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if plant_dk:
        import recalgorithm_tpu_torch.ops.attention as attention

        plain = attention.bst_mha
        attention.bst_mha = lambda q, k, v, lengths, save_bf16=False: plain(
            q, k + FAULT * (k - k.detach()), v, lengths, save_bf16)
    schema, w, cfg, hb = cs.step_setup("BST", weights)
    tr = cs.make_trainer("BST", schema, w, cfg, "cuda", os.path.dirname(out))
    loss, grads, _ = cs.one_step(tr, tr._put_batch(hb))
    np.savez(out, loss=loss, **{k: v.numpy() for k, v in grads.items()})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=10)
    ap.add_argument("--card-step", nargs=2, metavar=("WEIGHTS", "OUT"), help=argparse.SUPPRESS)
    ap.add_argument("--plant-dk", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("gate_repeat: no CUDA device", file=sys.stderr)
        return 1
    if args.card_step:
        card_step(*args.card_step, plant_dk=args.plant_dk)
        return 0
    from recalgorithm_tpu_torch.models.bst import BSTConfig

    cs = _chip_smoke()
    card = cs.card_line()
    print(card, flush=True)
    work = tempfile.mkdtemp(prefix="gate_repeat_")
    t0 = time.perf_counter()
    weights = cs.repeatable_weights("BST", os.path.join(work, "weights"))
    ref = cs.step_reference("BST", weights)
    zero = cs.zero_gradient_params(BSTConfig())
    print(f"reference (weights, f32 and f64 CPU steps): {time.perf_counter() - t0:.1f} s",
          flush=True)

    def step(out, *flags):
        subprocess.run([sys.executable, os.path.abspath(__file__), "--card-step", weights, out,
                        *flags], check=True, timeout=600)
        with np.load(out) as z:
            return float(z["loss"]), {k: torch.from_numpy(z[k]) for k in z.files if k != "loss"}

    def ratios(grads):
        return cs.step_gradient_ratios(grads, ref["cpu_grads"], ref["exact"], zero,
                                       ref["abs_sums"])

    worst = []
    for run in range(args.runs):
        loss, grads = step(os.path.join(work, f"run{run}.npz"))
        if run == 0:
            clean = grads
        r = ratios(grads)
        name = max(r, key=r.get)
        loss_rel = abs(loss - ref["cpu_loss"]) / abs(ref["cpu_loss"])
        worst.append((name, r[name] if loss_rel <= 1e-5 else float("inf")))
        print(f"run {run}: loss {loss} ({loss_rel:.2e} off the f32 CPU step's, limit 1e-5), "
              f"worst tensor {name} at {r[name]:.6f} of its allowance", flush=True)
    print(f"{card}: {args.runs} runs, worst {max(r for _, r in worst):.6f}; per run "
          f"{[(n, round(r, 6)) for n, r in worst]}", flush=True)

    # planted faults: each must take some tensor beyond its allowance
    _, grads = step(os.path.join(work, "dk.npz"), "--plant-dk")
    planted = {f"dk x (1 + {FAULT})": ratios(grads)}
    table = clean[FEEDID] * (1 + FAULT)
    planted[f"{FEEDID} x (1 + {FAULT})"] = ratios(dict(clean, **{FEEDID: table}))
    row = int(ref["exact"][FEEDID].abs().amax(dim=1).argmax())
    one_row = clean[FEEDID].clone()
    one_row[row] *= 1 + FAULT
    terms = float(ref["abs_sums"][FEEDID][row].max() / ref["exact"][FEEDID][row].abs().max())
    planted[f"{FEEDID} row {row} (largest |g|; its sum|terms| / |g| {terms:.1f}) x "
            f"(1 + {FAULT})"] = ratios(dict(clean, **{FEEDID: one_row}))
    caught = []
    for label, r in planted.items():
        top = sorted(r.items(), key=lambda kv: -kv[1])[:3]
        caught.append(top[0][1] > 1.0)
        print(f"planted {label}: {'refused' if caught[-1] else 'PASSED'}; the worst tensors "
              f"{[(n, round(x, 6)) for n, x in top]}", flush=True)
    return 0 if all(r <= 1.0 for _, r in worst) and all(caught) else 1


if __name__ == "__main__":
    sys.exit(main())
