#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (recalgorithm_tpu_torch) on one GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with one NVIDIA GPU (sm_90a: H100
or H200), nvcc and PyTorch built for CUDA.  Phases, each printed:

  1. the card (nvidia-smi name and power limit); TF32 off for matmuls and
     cuDNN, so every f32 product on the card is full f32;
  2. build the CUDA kernels from recalgorithm_tpu_torch/csrc into build/;
  3. each kernel against its plain torch twin on the card, timed with CUDA
     events beside its bound and, for BST attention, beside
     scaled_dot_product_attention: DIN attention at B = 37, 256, 4096; the
     BST forward, P (f32 and bf16) and dq/dk/dv at (B, H, T) = (37|256|4096,
     3, 51) and (4096, 2, 9);
  4. main path 1: full-width DIN (DINConfig defaults, real WeChat table
     sizes, random weights from a seed) exported, served by the port's
     build_server on cuda, 64 HTTP requests from 4 threads, every response
     held against the same export predicted on the CPU (plain twin);
  5. offline Predictor on cuda at B=4096, both use_softmax values, held
     against the CPU; where a batch's time goes at B = 8, 256 and 4096
     (host wall time against device busy time by kernel, torch.profiler);
  6. full-width DIN trains a few steps through cli.main on cuda (the DIN
     kernel's forward, autograd through the recompute for the backward);
  7. main path 2: full-width BST (BSTConfig defaults, real table sizes)
     trains through cli.main.main on cuda at B=4096 with one step-triggered
     eval and a checkpoint, then resumes once; predictions.csv and the best
     export are checked, and each BST kernel's launches against the steps and
     eval batches the run took;
  8. one BST train step on cuda held against the same step on the CPU (loss
     and every gradient); the BST kernels at that step's own inputs; the
     train step's time (CUDA events, host wall), ex/s and device idle share
     (torch.profiler);
  9. the golden recipe of tests/golden_common.py for BST on the card, its
     eval AUC held to the band of tests/golden_bands.json;
 10. the BST export served over HTTP by build_server, every response held
     against the CPU.

Each main path's kernel launch counts are set to 0 just before it and read
just after: a kernel of the path that never launched fails the run.  The
line before the last is one JSON object with each kernel's numbers; the last
line is {"ok": true, "device": {...}}.  Any failure exits non-zero before
either, as does a machine without CUDA.
"""

from __future__ import annotations

import argparse
import atexit
import csv
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from collections import defaultdict

import numpy as np
import torch

# H100 SXM published peaks (NVIDIA data sheet): f32 outside the tensor cores,
# and HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
TOL = dict(rtol=1e-5, atol=1e-5)  # f32 on both sides; summation order only
# GPU sleep that timed launches queue behind: 4e8 cycles last at least 0.2 s
# at the H100's highest clock (1.98 GHz)
SLEEP_CYCLES = 400_000_000
SLEEP_S_MIN = 0.2
SEQ = "his_read_comment_7d_seq"
# phase 5's profile: a small and a full serving bucket, and the offline batch
PROFILE_BATCHES = (8, 256, 4096)
PROFILE_ITERS = 20
PROFILE_TOP = 8
# BST kernels against their twins: shapes (B, H, T); the gradient bars of
# the JAX package's own BST kernel test, 2e-2 where P was saved in bf16
BST_SHAPES = ((37, 3, 51), (256, 3, 51), (4096, 3, 51), (4096, 2, 9))
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
# main path 2: cli.main trains full-width BST at B=4096, evals every
# BST_EVAL_EVERY steps, then resumes to BST_RESUME_STEPS
BST_BATCH = 4096
BST_STEPS = 40
BST_EVAL_EVERY = 20
BST_RESUME_STEPS = 50
DIN_TRAIN_STEPS = 8
STEP_ITERS = 20  # train steps timed / profiled in phase 8
REPO = os.path.dirname(os.path.abspath(__file__))


def phase(name: str) -> None:
    print(f"\n== {name}", flush=True)


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Device ms of one call: CUDA events around `iters` calls queued behind
    a GPU sleep, so the card runs them back to back and the host's cost to
    launch them is not in the number."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_s = time.perf_counter() - t0
    end.record()
    end.synchronize()
    if host_s > SLEEP_S_MIN:
        raise RuntimeError(f"launching {iters} calls took {host_s:.3f} s, longer "
                           "than the GPU sleep: the device time would hold host gaps")
    return start.elapsed_time(end) / iters


def device_events(prof) -> list:
    """The kernels and copies of a torch.profiler run; the GPU-side ranges
    of user annotations (``Optimizer.step#Adam.step``) span kernels already
    counted and are left out."""
    from torch.autograd import DeviceType

    return [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def profile_batch(pred, batch) -> dict:
    """Where a served batch's time goes: host wall time of `predict_batch`
    (numpy in -> numpy out; it ends in a device->host copy, so it is
    synchronous), median of PROFILE_ITERS calls, against the device time of
    every kernel and copy per batch from torch.profiler over PROFILE_ITERS
    more (one stream, so their sum is the busy time)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        pred.predict_batch(batch)
    torch.cuda.synchronize()
    walls = []
    for _ in range(PROFILE_ITERS):
        t0 = time.perf_counter()
        pred.predict_batch(batch)
        walls.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_ITERS):
            pred.predict_batch(batch)
        torch.cuda.synchronize()
    events = device_events(prof)
    by_name: dict[str, float] = defaultdict(float)
    for e in events:
        by_name[e.name] += e.time_range.elapsed_us() / PROFILE_ITERS / 1e3
    att = [e.time_range.elapsed_us() / 1e3 for e in events if "din_attention" in e.name]
    if not att:
        raise AssertionError("the profiled batch ran no din_attention kernel")
    wall_ms = float(np.median(walls)) * 1e3
    busy_ms = sum(by_name.values())
    return {
        "batch": len(batch["dense"]), "wall_ms": wall_ms, "busy_ms": busy_ms,
        "idle_share": 1.0 - busy_ms / wall_ms,
        "device_ops_per_batch": len(events) / PROFILE_ITERS,
        "din_attention_ms": float(np.mean(att)),
        "top": sorted(by_name.items(), key=lambda kv: -kv[1])[:PROFILE_TOP],
    }


def din_attention_bound_ms(lengths: np.ndarray, t: int, use_softmax: bool):
    """Least time for the kernel's work on these lengths (source note of
    csrc/din_attention.cu): 6240 FLOP per valid step + 4096 per example, the
    valid keys read once, q/lengths/out once, the weights once."""
    b = len(lengths)
    steps = np.clip(lengths, 0, t).astype(np.int64)
    flops = 6240 * int(steps.sum()) + 4096 * b
    rows = steps.copy()
    if use_softmax:  # len 0 attends uniformly: all T keys, 16 adds each
        flops += 16 * t * int((steps == 0).sum())
        rows[steps == 0] = t
    nbytes = 4 * (16 * int(rows.sum()) + 33 * b) + 4 * 6273
    t_ops, t_bytes = flops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def bst_bound_ms(lengths: np.ndarray, h: int, t: int, kind: str, p_bytes: int = 4):
    """Least time for a BST kernel's work on these lengths (source note of
    csrc/bst_attention.cu), d = 16, per (b, h) with n = min(len, T) valid
    keys.  FLOP: 4 T n d forward, 8 T n d backward, 2 T^2 d for a len = 0
    row.  Bytes: q and o (forward) or q, do, dq, dk and dv (backward) in
    full; the first n rows of k and v (a len = 0 row: all T rows of v
    forward, none backward, where its dl is 0 and P is the constant 1/T);
    P in full where the forward writes it, its first n columns where the
    backward reads it; lengths once."""
    d = 16
    n = np.clip(lengths, 0, t).astype(np.int64)
    per_row = {"forward": 4, "forward_save": 4, "backward": 8}[kind] * t * n * d
    flops = h * int(np.where(n > 0, per_row, 2 * t * t * d).sum())
    b = len(lengths)
    full = 5 if kind == "backward" else 2
    kv_rows = int(n.sum()) + (0 if kind == "backward" else t * int((n == 0).sum()))
    nbytes = 4 * (full * b * h * t * d + h * d * (int(n.sum()) + kv_rows) + b)
    if kind == "forward_save":
        nbytes += b * h * t * t * p_bytes
    elif kind == "backward":
        nbytes += h * t * int(n.sum()) * p_bytes
    t_ops, t_bytes = flops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def check_grads(name: str, got, want, tol=GRAD_TOL) -> float:
    """rtol, and atol scaled by max|want| (the JAX kernel test's rule)."""
    worst = 0.0
    for label, a, b in zip(("dq", "dk", "dv"), got, want):
        a, b = a.detach().cpu().numpy(), b.detach().cpu().numpy()
        if not np.isfinite(a).all():
            raise AssertionError(f"{name} {label}: not finite")
        scale = max(float(np.abs(b).max()), 1.0)
        if not np.allclose(a, b, rtol=tol["rtol"], atol=tol["atol"] * scale):
            raise AssertionError(f"{name} {label}: max abs err "
                                 f"{float(np.abs(a - b).max()):.3e} beyond {tol} x {scale:.3g}")
        worst = max(worst, float(np.abs(a - b).max()))
    return worst


def bst_case(b: int, h: int, t: int, seed: int):
    rng = np.random.default_rng(seed)
    q, k, v, g = (torch.from_numpy(rng.normal(size=(b, h, t, 16)).astype(np.float32)).cuda()
                  for _ in range(4))
    lengths = rng.integers(0, t + 1, b).astype(np.int32)
    lengths[:3] = (0, t, 1)
    return q, k, v, g, torch.from_numpy(lengths).cuda()


def bst_kernels_vs_twins(q, k, v, g, lengths, timed: bool) -> dict:
    """Each BST kernel against its twin on (q, k, v, lengths): forward, P in
    f32 and bf16, dq/dk/dv from both.  With ``timed``: each kernel's ms, its
    twin's, its bound, and scaled_dot_product_attention's (rows with len >= 1:
    SDPA gives NaN on a fully masked row)."""
    from recalgorithm_tpu_torch.ops.cuda import bst_attention as bk

    b, h, t, _ = q.shape
    want = bk.bst_mha_reference(q, k, v, lengths)
    probs = bk.attention_probs_reference(q, k, lengths)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    twin_out = bk.bst_mha_reference(*leaves, lengths)
    twin_grads = torch.autograd.grad(twin_out, leaves, g, retain_graph=True)
    out = bk.bst_attention_forward(q, k, v, lengths)
    out_s, p32 = bk.bst_attention_forward_save(q, k, v, lengths)
    out_b, p16 = bk.bst_attention_forward_save(q, k, v, lengths, save_bf16=True)
    grads = bk.bst_attention_backward(q, k, v, p32, g, lengths)
    grads16 = bk.bst_attention_backward(q, k, v, p16, g, lengths)
    torch.cuda.synchronize()
    r = {"err": {
        "forward": max(check_close(f"BST forward {tuple(q.shape)}", o.cpu().numpy(),
                                   want.cpu().numpy()) for o in (out, out_s, out_b)),
        "P": check_close("BST P f32", p32.cpu().numpy(), probs.cpu().numpy()),
        "P_bf16": float((p16.float() - probs).abs().max()),
        "backward": check_grads("BST backward", grads, twin_grads),
        "backward_bf16": check_grads("BST backward, bf16 P", grads16, twin_grads, BF16_TOL),
    }}
    if r["err"]["P_bf16"] > BF16_TOL["atol"]:
        raise AssertionError(f"BST P bf16: max abs err {r['err']['P_bf16']:.3e}")
    if not timed:
        return r
    lens = lengths.cpu().numpy()
    mask = (torch.arange(t, device=q.device)[None, :] < lengths[:, None])[:, None, None, :]
    rows = lengths > 0
    sq, sk, sv, sm, sg = (x[rows] for x in (q, k, v, mask, g))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    s_leaves = [x.clone().requires_grad_() for x in (sq, sk, sv)]
    s_out = sdpa(*s_leaves, attn_mask=sm)
    r["ms"] = {
        "forward": cuda_ms(lambda: bk.bst_attention_forward(q, k, v, lengths), iters=100),
        "forward_save": cuda_ms(lambda: bk.bst_attention_forward_save(q, k, v, lengths),
                                iters=100),
        "forward_save_bf16": cuda_ms(
            lambda: bk.bst_attention_forward_save(q, k, v, lengths, True), iters=100),
        "backward": cuda_ms(lambda: bk.bst_attention_backward(q, k, v, p32, g, lengths),
                            iters=100),
        "backward_bf16": cuda_ms(
            lambda: bk.bst_attention_backward(q, k, v, p16, g, lengths), iters=100),
    }
    r["plain_ms"] = {
        "forward": cuda_ms(lambda: bk.bst_mha_reference(q, k, v, lengths)),
        "forward_save": cuda_ms(lambda: torch.einsum(
            "bhij,bhjk->bhik", bk.attention_probs_reference(q, k, lengths), v)),
        "backward": cuda_ms(lambda: torch.autograd.grad(twin_out, leaves, g,
                                                        retain_graph=True)),
    }
    with torch.no_grad():
        sdpa_fwd = cuda_ms(lambda: sdpa(sq, sk, sv, attn_mask=sm))
    r["library_ms"] = {
        "forward": sdpa_fwd,
        "forward_save": cuda_ms(lambda: sdpa(*s_leaves, attn_mask=sm)),
        "backward": cuda_ms(lambda: torch.autograd.grad(s_out, s_leaves, sg,
                                                        retain_graph=True)),
        "sdpa_rows": int(rows.sum()),
    }
    r["bound"] = {
        "forward": bst_bound_ms(lens, h, t, "forward"),
        "forward_save": bst_bound_ms(lens, h, t, "forward_save"),
        "forward_save_bf16": bst_bound_ms(lens, h, t, "forward_save", p_bytes=2),
        "backward": bst_bound_ms(lens, h, t, "backward"),
        "backward_bf16": bst_bound_ms(lens, h, t, "backward", p_bytes=2),
    }
    return r


def bst_counts() -> dict[str, int]:
    from recalgorithm_tpu_torch.ops.cuda import bst_attention as bk

    return {name: getattr(bk, name).launches for name in BST_KERNELS}


def zero_counts() -> None:
    from recalgorithm_tpu_torch.ops.cuda import bst_attention as bk
    from recalgorithm_tpu_torch.ops.cuda.din_attention import din_attention

    din_attention.launches = 0
    for name in BST_KERNELS:
        getattr(bk, name).launches = 0


BST_KERNELS = ("bst_attention_forward", "bst_attention_forward_save", "bst_attention_backward")


def train_cli(model: str, model_dir: str, steps: int, extra=()) -> dict:
    """One run of the port's training entry point on cuda, full width."""
    from recalgorithm_tpu_torch.cli.main import main as train_main

    argv = ["--model", model, "--synthetic", "--synthetic_vocab_scale", "1.0",
            "--batch_size", str(BST_BATCH), "--train_steps", str(steps),
            "--model_dir", model_dir, "--predictions_csv",
            os.path.join(model_dir, "predictions.csv"), "--eval_throttle_secs", "0",
            "--log_every", "10", "--device", "cuda", *extra]
    t0 = time.perf_counter()
    final = train_main(argv)
    torch.cuda.synchronize()
    print(f"cli.main {model} to step {steps}: {time.perf_counter() - t0:.2f} s, "
          f"final eval {final}", flush=True)
    return final


def profile_train_step(trainer, batches) -> dict:
    """Where a BST train step's time goes: device ms of one step from CUDA
    events around STEP_ITERS steps launched back to back (the steady pipeline,
    host gaps included), the median host wall of a step that ends in a
    synchronize, and the device busy time per step (torch.profiler, every
    kernel and copy: one stream, so their sum is the busy time)."""
    from torch.profiler import ProfilerActivity, profile

    for hb in batches[:3]:
        trainer.train_step(hb)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(STEP_ITERS):
        trainer.train_step(batches[i % len(batches)])
    end.record()
    end.synchronize()
    step_ms = start.elapsed_time(end) / STEP_ITERS
    walls = []
    for i in range(STEP_ITERS):
        t0 = time.perf_counter()
        trainer.train_step(batches[i % len(batches)])
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(STEP_ITERS):
            trainer.train_step(batches[i % len(batches)])
        torch.cuda.synchronize()
    events = device_events(prof)
    by_name: dict[str, float] = defaultdict(float)
    for e in events:
        by_name[e.name] += e.time_range.elapsed_us() / STEP_ITERS / 1e3
    busy_ms = sum(by_name.values())
    if not any("bst_attention" in name for name in by_name):
        raise AssertionError("the profiled train steps ran no bst_attention kernel")
    return {"step_ms": step_ms, "wall_ms": float(np.median(walls)) * 1e3,
            "busy_ms": busy_ms, "idle_share": 1.0 - busy_ms / step_ms,
            "device_ops_per_step": len(events) / STEP_ITERS,
            "top": sorted(by_name.items(), key=lambda kv: -kv[1])[:PROFILE_TOP]}


def golden_bst(device: str, model_dir: str) -> float:
    """tests/golden_common.py's fixed-seed recipe for BST (seed 3, vocab
    scale 0.005, B=128, 300 steps, lr 0.01, hidden (64, 32), 32 eval batches
    from seed 5000) through the port's Trainer; returns the eval AUC."""
    from recalgorithm_tpu_torch.data.synthetic import SyntheticConfig, SyntheticWeChat
    from recalgorithm_tpu_torch.features.schema import wechat_schema
    from recalgorithm_tpu_torch.models.bst import BST, BSTConfig
    from recalgorithm_tpu_torch.train import optimizers
    from recalgorithm_tpu_torch.train.loop import Trainer, TrainerConfig

    seed, batch, steps = 3, 128, 300
    gen = SyntheticWeChat(wechat_schema(), SyntheticConfig(seed=seed, vocab_scale=0.005))
    cfg = BSTConfig(batch_size=batch, hidden_units=(64, 32))
    model = BST(cfg, wechat_schema(gen.vocab_sizes()), torch.Generator().manual_seed(seed))
    trainer = Trainer(model, cfg.task_names, optimizers.build("adam", 0.01),
                      TrainerConfig(model_dir=model_dir, train_steps=steps, log_every=1000,
                                    save_checkpoints_steps=0, seed=seed), device=device)
    ev = trainer.train_and_evaluate(gen.batches(batch, steps),
                                    lambda: gen.batches(batch, 32, start_seed=5000),
                                    log_fn=lambda line: None)
    return ev["read_comment_auc"]


BST_REPLACES = {"forward": "recalgorithm_tpu/ops/pallas/bst_attention.py:52",
                "forward_save": "recalgorithm_tpu/ops/pallas/bst_attention.py:68",
                "backward": "recalgorithm_tpu/ops/pallas/bst_attention.py:95"}


def zero_gradient_params(cfg) -> set[str]:
    """The BST parameters whose true gradient is 0 in a train step: with no
    activation in the tower, a shift that reaches a train-mode BatchNorm
    through linear maps only is taken out by its batch mean.  That holds for
    every dense bias, every BatchNorm bias but the last, and the last block's
    ln2 bias, which sum pooling makes one constant for the whole batch."""
    if cfg.mlp_activation != "none" or not cfg.batch_norm:
        raise ValueError("the zero gradients follow from a linear tower with BatchNorm")
    n = len(cfg.hidden_units)
    return ({f"dense_{i}.bias" for i in range(n)} | {f"bn_{i}.bias" for i in range(n - 1)}
            | {f"transformer_{cfg.num_transformer_block - 1}.ln2.bias"})


def bst_step_phase(best_dir: str, train_counts: dict, card: str, kind: str) -> list[dict]:
    """One full-width BST train step (loss and every gradient) on cuda held
    against the same step on the CPU, dropout off so both draw nothing; the
    BST kernels timed at that step's attention inputs; the step profiled.
    Returns the kernels' entries of the JSON line."""
    import recalgorithm_tpu_torch.ops.attention as attention
    from recalgorithm_tpu_torch import convert
    from recalgorithm_tpu_torch.data.synthetic import SyntheticConfig, SyntheticWeChat
    from recalgorithm_tpu_torch.features.schema import wechat_schema
    from recalgorithm_tpu_torch.models.bst import BST, BSTConfig
    from recalgorithm_tpu_torch.train import optimizers
    from recalgorithm_tpu_torch.train.loop import Trainer, TrainerConfig

    gen = SyntheticWeChat(wechat_schema(), SyntheticConfig(seed=7, vocab_scale=1.0))
    schema = wechat_schema(gen.vocab_sizes())
    weights = convert.load_export(best_dir)

    def trainer(device, cfg):
        model = BST(cfg, schema)
        model.load_state_dict(weights)
        return Trainer(model, cfg.task_names, optimizers.build("adam", cfg.learning_rate),
                       TrainerConfig(model_dir=os.path.join(best_dir, "unused")),
                       device=device)

    hb = gen.batch(BST_BATCH, 1)

    def one_step(device):
        tr = trainer(device, BSTConfig(dropout_rate=0.0))
        tr.model.train()
        loss, _ = tr._loss_and_logits(tr._put_batch(hb))
        loss.backward()
        return float(loss.detach()), {n: p.grad.cpu() for n, p in tr.model.named_parameters()}

    captured = {}
    plain_mha = attention.bst_mha

    def capture(q, k, v, lengths, save_bf16=False):
        captured.update(q=q.detach().clone(), k=k.detach().clone(), v=v.detach().clone(),
                        lengths=lengths.clone())
        return plain_mha(q, k, v, lengths, save_bf16)

    attention.bst_mha = capture
    try:
        gpu_loss, gpu_grads = one_step("cuda")
    finally:
        attention.bst_mha = plain_mha
    cpu_loss, cpu_grads = one_step("cpu")
    worst = max(float((gpu_grads[n] - cpu_grads[n]).abs().max()) for n in cpu_grads)
    print(f"train step B={BST_BATCH}: loss cuda {gpu_loss} cpu {cpu_loss}; "
          f"max abs gradient difference over {len(cpu_grads)} tensors {worst:.3e}")
    if not (math.isfinite(gpu_loss) and abs(gpu_loss - cpu_loss) <= 1e-5 * abs(cpu_loss)):
        raise AssertionError("the cuda train step's loss is not the CPU's within rtol 1e-5")
    # Each gradient within rtol 1e-4 and atol 1e-5 x its own max|g|, but for
    # the tensors whose true gradient is 0, where both sides hold rounding
    # noise: they are held to 1e-5 x the step's largest gradient.
    zero = zero_gradient_params(BSTConfig())
    step_scale = max(float(g.abs().max()) for g in cpu_grads.values())
    for name, want in cpu_grads.items():
        got = gpu_grads[name]
        scale = step_scale if name in zero else float(want.abs().max())
        if not torch.allclose(got, want, rtol=GRAD_TOL["rtol"], atol=GRAD_TOL["atol"] * scale):
            raise AssertionError(
                f"gradient of {name}: max abs err {float((got - want).abs().max()):.3e} "
                f"beyond {GRAD_TOL} x {scale:.3g}")

    q, k, v, lengths = (captured[x] for x in ("q", "k", "v", "lengths"))
    g = torch.from_numpy(np.random.default_rng(0).normal(size=tuple(q.shape))
                         .astype(np.float32)).cuda()
    r = bst_kernels_vs_twins(q, k, v, g, lengths, timed=True)
    lens = lengths.cpu().numpy()
    print(f"BST kernels at the train step's attention inputs ({tuple(q.shape)}, mean "
          f"len {lens.mean():.2f}): {json.dumps(r, default=str)}")
    entries = []
    for key in ("forward", "forward_save", "backward"):
        name = "bst_attention_" + key
        bound, by = r["bound"][key]
        err = {"forward": r["err"]["forward"],
               "forward_save": max(r["err"]["forward"], r["err"]["P"]),
               "backward": r["err"]["backward"]}[key]
        entries.append({
            "name": name, "route": "cuda",
            "source": "recalgorithm_tpu_torch/csrc/bst_attention.cu",
            "replaces": BST_REPLACES[key], "launches": train_counts[name],
            "max_abs_err": err, "ms": r["ms"][key], "plain_ms": r["plain_ms"][key],
            "bound_ms": bound, "bound_by": by, "library_ms": r["library_ms"][key]})

    tr = trainer("cuda", BSTConfig())
    prof = profile_train_step(tr, [gen.batch(BST_BATCH, 10 + i) for i in range(4)])
    print(f"BST train step on {kind} ({card}), B={BST_BATCH}, dropout 0.1: "
          f"{prof['step_ms']} ms a step (CUDA events over {STEP_ITERS} steps back to "
          f"back; {BST_BATCH / prof['step_ms'] * 1e3:.0f} ex/s), host wall of a "
          f"synchronized step {prof['wall_ms']} ms (median), device busy "
          f"{prof['busy_ms']} ms, idle share {prof['idle_share']:.4f}, "
          f"{prof['device_ops_per_step']:.0f} kernels+copies per step")
    for kname, ms in prof["top"]:
        print(f"    {ms:9.5f} ms  {kname[:100]}")
    return entries


def serve_bst(best_dir: str, gen) -> None:
    """The BST export served by build_server on cuda; every response held
    against the CPU; only the inference forward may launch."""
    from recalgorithm_tpu_torch.cli.serve import build_server
    from recalgorithm_tpu_torch.features.schema import wechat_schema
    from recalgorithm_tpu_torch.models.bst import BST, BSTConfig
    from recalgorithm_tpu_torch.serving.predictor import Predictor

    args = argparse.Namespace(
        model="BST", model_dir=None, export_dir=best_dir, vocabulary_dir=None,
        synthetic_vocab_scale=1.0, host="127.0.0.1", port=0,
        max_batch_size=256, max_delay_ms=2.0, device="cuda")
    schema = wechat_schema(gen.vocab_sizes())
    hb = gen.batch(32, 4)
    hb[SEQ][0], hb[SEQ + "_len"][0] = 0, 0
    zero_counts()
    httpd, batchers = build_server(args)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    results: dict[int, float] = {}
    errors: list[Exception] = []

    def client(rows):
        try:
            for i in rows:
                results[i] = post(url, payload_of(hb, i, schema))[0]
        except Exception as exc:  # reported below, fails the run
            errors.append(exc)

    try:
        threads = [threading.Thread(target=client, args=(range(j, 32, 4),)) for j in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
    finally:
        httpd.shutdown()
        httpd.server_close()
        for bt in batchers.values():
            bt.close()
    counts = bst_counts()
    if errors or len(results) != 32:
        raise AssertionError(f"{len(results)}/32 responses; errors: {errors[:3]}")
    want = Predictor(BST(BSTConfig(), schema), best_dir, device="cpu").predict_batch(hb)
    err = check_close("BST HTTP responses vs CPU", np.array(
        [results[i] for i in range(32)], np.float32), want["read_comment"])
    print(f"32 BST requests from 4 threads: vs CPU max abs err {err:.3e}; kernel "
          f"launches {counts}")
    if counts["bst_attention_forward"] <= 0 or counts["bst_attention_forward_save"] \
            or counts["bst_attention_backward"]:
        raise AssertionError("BST serving must launch the inference forward only")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def random_attention_case(b: int, seed: int):
    from recalgorithm_tpu_torch.ops.attention import DINAttention

    rng = np.random.default_rng(seed)
    t, h = 50, 16
    q = rng.normal(size=(b, h)).astype(np.float32)
    k = rng.normal(size=(b, t, h)).astype(np.float32)
    lengths = rng.integers(0, t + 1, b).astype(np.int32)
    lengths[:2] = (0, t)
    att = DINAttention(h, generator=torch.Generator().manual_seed(seed))
    weights = [p.detach().cuda() for p in (
        att.f1_att.weight, att.f1_att.bias, att.f2_att.weight,
        att.f2_att.bias, att.f3_att.weight, att.f3_att.bias)]
    dev = [torch.from_numpy(x).cuda() for x in (q, k, lengths)]
    return dev, weights, lengths


def check_close(name: str, got: np.ndarray, want: np.ndarray) -> float:
    if got.shape != want.shape or not np.isfinite(got).all():
        raise AssertionError(f"{name}: shape {got.shape} vs {want.shape}, "
                             f"finite={np.isfinite(got).all()}")
    err = float(np.max(np.abs(got - want))) if got.size else 0.0
    if not np.allclose(got, want, **TOL):
        raise AssertionError(f"{name}: max abs err {err:.3e} beyond {TOL}")
    return err


def payload_of(hb, i, schema) -> dict:
    return {
        "dense": hb["dense"][i].tolist(),
        **{f.name: int(hb[f.name][i]) for f in schema.categorical},
        **{f.name: hb[f.name][i][: int(hb[f.name + "_len"][i])].tolist()
           for f in schema.sequence},
    }


def post(url: str, payload: dict) -> tuple[float, float]:
    req = urllib.request.Request(url + "/predict", data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=120) as r:
        body = json.loads(r.read())
        if r.status != 200:
            raise AssertionError(f"POST /predict -> {r.status}: {body}")
    return body["predictions"]["read_comment"], time.perf_counter() - t0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: no GPU to run on",
              file=sys.stderr)
        return 1

    from recalgorithm_tpu_torch import convert
    from recalgorithm_tpu_torch.cli.serve import build_server
    from recalgorithm_tpu_torch.data.synthetic import SyntheticConfig, SyntheticWeChat
    from recalgorithm_tpu_torch.features.schema import wechat_schema
    from recalgorithm_tpu_torch.models.din import DIN, DINConfig
    from recalgorithm_tpu_torch.ops.cuda import _build
    from recalgorithm_tpu_torch.ops.cuda.din_attention import (
        din_attention,
        din_attention_reference,
    )
    from recalgorithm_tpu_torch.serving.predictor import Predictor

    phase("1. card")
    card = card_line()
    print(card)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; device 0: {kind}; "
          f"count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, "
          "torch.backends.cudnn.allow_tf32 = False")

    phase("2. build kernels (nvcc, sm_90a)")
    t0 = time.perf_counter()
    libs = _build.build()
    print(f"built {sorted(libs)} in {time.perf_counter() - t0:.2f} s")
    for name, log in _build.build_logs.items():
        for line in log.splitlines():
            if any(w in line for w in ("registers", "spill", "smem", "error")):
                print(f"  {name}: {line.strip()}")

    phase(f"3. kernel vs plain twin on the card (tolerance {TOL})")
    print("  B     softmax  max_abs_err  kernel_ms  twin_ms   bound_ms (bound by)")
    for b in (37, 256, 4096):
        for sm in (False, True):
            dev, weights, lengths = random_attention_case(b, seed=b)
            got = din_attention(*dev, *weights, use_softmax=sm)
            want = din_attention_reference(*dev, *weights, use_softmax=sm)
            torch.cuda.synchronize()
            err = check_close(f"din_attention B={b} softmax={sm}",
                              got.cpu().numpy(), want.cpu().numpy())
            row = f"  {b:<5} {sm!s:<8} {err:.3e}"
            if b in (256, 4096):
                k_ms = cuda_ms(
                    lambda: din_attention(*dev, *weights, use_softmax=sm), iters=200)
                p_ms = cuda_ms(lambda: din_attention_reference(
                    *dev, *weights, use_softmax=sm))
                bound, by = din_attention_bound_ms(lengths, 50, sm)
                row += f"    {k_ms:.5f}    {p_ms:.5f}  {bound:.5f} ({by})"
            print(row, flush=True)
    print("  BST attention: forward, P (f32, bf16) and dq/dk/dv vs the twin; "
          f"gradients {GRAD_TOL} x max|g|, bf16 P {BF16_TOL}")
    bst_rows = {}
    for b, h, t in BST_SHAPES:
        r = bst_kernels_vs_twins(*bst_case(b, h, t, seed=b + t), timed=True)
        bst_rows[(b, h, t)] = r
        print(f"  B={b} H={h} T={t}: max abs err {json.dumps(r['err'])}", flush=True)
        if "ms" in r:
            for kname, ms in r["ms"].items():
                base = kname.replace("_bf16", "")
                bound, by = r["bound"][kname]
                print(f"    {kname:<18} kernel {ms:.5f} ms  twin "
                      f"{r['plain_ms'].get(base, float('nan')):.5f} ms  sdpa "
                      f"{r['library_ms'].get(base, float('nan')):.5f} ms  bound "
                      f"{bound:.5f} ms ({by})", flush=True)

    phase("4. main path 1: full-width DIN served over HTTP on cuda")
    schema = wechat_schema()
    model = DIN(DINConfig(), schema, torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():  # non-trivial BatchNorm statistics
        for name, buf in model.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(0.1 * torch.randn(buf.shape, generator=g))
            elif name.endswith("running_var"):
                buf.copy_(torch.rand(buf.shape, generator=g) * 1.5 + 0.5)
    model_dir = tempfile.mkdtemp(prefix="chip_smoke_")
    atexit.register(shutil.rmtree, model_dir, ignore_errors=True)
    export_dir = convert.save_export(model_dir, 1, 0.5, model)
    print(f"exported full-width DIN to {export_dir}: feedid table "
          f"{tuple(model.embedder.embed.tables['feedid'].shape)}, fcn "
          f"{model.fcn.dense_0.in_features}->{DINConfig().hidden_units}->1")
    args = argparse.Namespace(
        model="DIN", model_dir=model_dir, export_dir=None, vocabulary_dir=None,
        synthetic_vocab_scale=1.0, host="127.0.0.1", port=0,
        max_batch_size=256, max_delay_ms=2.0, device="cuda")

    zero_counts()
    t0 = time.perf_counter()
    httpd, batchers = build_server(args)
    print(f"build_server (load export + warm every bucket "
          f"{batchers['DIN'].buckets}): {time.perf_counter() - t0:.2f} s")
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    gen = SyntheticWeChat(schema, SyntheticConfig(seed=0, vocab_scale=1.0))
    hb = gen.batch(64, 1)
    hb[SEQ][0], hb[SEQ + "_len"][0] = 0, 0  # empty history
    hb[SEQ][1] = np.arange(1, 51, dtype=np.int32) * 997
    hb[SEQ + "_len"][1] = 50                # full 50-long history
    results: dict[int, tuple[float, float]] = {}
    errors: list[Exception] = []

    def client(rows):
        try:
            for i in rows:
                results[i] = post(url, payload_of(hb, i, schema))
        except Exception as exc:  # reported below, fails the run
            errors.append(exc)

    try:
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            if r.read() != b"ok":
                raise AssertionError("GET /healthz did not answer ok")
        threads = [threading.Thread(target=client, args=(range(j, 64, 4),))
                   for j in range(4)]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        wall = time.perf_counter() - t0
        with urllib.request.urlopen(url + "/metrics", timeout=60) as r:
            metrics = json.loads(r.read())
    finally:
        httpd.shutdown()
        httpd.server_close()
        gpu_pred = batchers["DIN"].predictor
        for bt in batchers.values():
            bt.close()
    serve_launches = din_attention.launches
    if errors or len(results) != 64:
        raise AssertionError(f"{len(results)}/64 responses; errors: {errors[:3]}")
    cpu_pred = Predictor(DIN(DINConfig(), schema), export_dir, device="cpu")
    want = cpu_pred.predict_batch(hb)["read_comment"]
    got = np.array([results[i][0] for i in range(64)], np.float32)
    err = check_close("HTTP responses vs CPU twin", got, want)
    lat = np.sort([results[i][1] * 1e3 for i in range(64)])
    print(f"64 requests from 4 threads in {wall:.3f} s; responses vs CPU: "
          f"max abs err {err:.3e}")
    print(f"request latency ms: p50 {np.percentile(lat, 50):.3f} "
          f"p99 {np.percentile(lat, 99):.3f}")
    print(f"server stats: {json.dumps(metrics)}")
    print(f"din_attention launches on the serving path: {serve_launches}")
    if serve_launches <= 0:
        raise AssertionError("the serving path never launched the din_attention kernel")

    phase("5. offline Predictor on cuda, B=4096, and where a batch's time goes")
    big = gen.batch(4096, 2)
    captured = {}

    def capture(module, inputs, output):
        captured["inputs"] = [x.clone() for x in inputs]

    din_attention.launches = 0
    hook = gpu_pred.model.attention.register_forward_hook(capture)
    probs = gpu_pred.predict(iter([big]))["read_comment"]  # keeps the kernel's inputs
    hook.remove()
    offline_launches = din_attention.launches
    if offline_launches <= 0:
        raise AssertionError("offline predict never launched the din_attention kernel")
    err_off = check_close("offline B=4096 vs CPU", probs,
                          cpu_pred.predict_batch(big)["read_comment"])
    print(f"Predictor.predict B=4096: vs CPU max abs err {err_off:.3e}; "
          f"kernel launches {offline_launches}")
    print(f"Predictor.predict_batch on {kind} ({card}): wall = median host time of "
          f"{PROFILE_ITERS} calls; busy = device time of its kernels and copies "
          "(torch.profiler)")
    for b in PROFILE_BATCHES:
        r = profile_batch(gpu_pred, big if b == len(big["dense"]) else gen.batch(b, 3))
        print(f"  B={b}: wall {r['wall_ms']} ms ({b / r['wall_ms'] * 1e3:.0f} ex/s), "
              f"device busy {r['busy_ms']} ms, idle share {r['idle_share']:.4f}, "
              f"{r['device_ops_per_batch']:.0f} kernels+copies per batch, "
              f"din_attention {r['din_attention_ms']} ms")
        for kname, ms in r["top"]:
            print(f"    {ms:9.5f} ms  {kname[:100]}")
    sm_pred = Predictor(DIN(DINConfig(use_softmax=True), schema), export_dir,
                        device="cuda")
    din_attention.launches = 0
    sm_probs = sm_pred.predict_batch(big)["read_comment"]
    sm_launches = din_attention.launches
    sm_cpu = Predictor(DIN(DINConfig(use_softmax=True), schema), export_dir, device="cpu")
    err_sm = check_close("offline softmax B=4096 vs CPU", sm_probs,
                         sm_cpu.predict_batch(big)["read_comment"])
    if sm_launches <= 0:
        raise AssertionError("use_softmax=True never launched the kernel")
    print(f"use_softmax=True B=4096: vs CPU max abs err {err_sm:.3e}; "
          f"kernel launches {sm_launches}")

    # the kernel at the main path's own inputs (offline B=4096 batch)
    q, keys, lengths = captured["inputs"]
    att = gpu_pred.model.attention
    weights = [p.detach() for p in (att.f1_att.weight, att.f1_att.bias,
                                    att.f2_att.weight, att.f2_att.bias,
                                    att.f3_att.weight, att.f3_att.bias)]
    with torch.inference_mode():
        got = din_attention(q, keys, lengths, *weights)
        want = din_attention_reference(q, keys, lengths, *weights)
        torch.cuda.synchronize()
        max_err = check_close("din_attention at main-path inputs",
                              got.cpu().numpy(), want.cpu().numpy())
        k_ms = cuda_ms(lambda: din_attention(q, keys, lengths, *weights), iters=200)
        p_ms = cuda_ms(lambda: din_attention_reference(q, keys, lengths, *weights))
    lens = lengths.cpu().numpy()
    bound, by = din_attention_bound_ms(lens, keys.shape[1], False)
    print(f"din_attention at the offline batch's inputs (B={len(lens)}, "
          f"mean len {lens.mean():.2f}): kernel {k_ms:.5f} ms, twin {p_ms:.5f} ms, "
          f"bound {bound:.5f} ms ({by}), max abs err {max_err:.3e}")

    din_entry = {
        "name": "din_attention", "route": "cuda",
        "source": "recalgorithm_tpu_torch/csrc/din_attention.cu",
        "replaces": "recalgorithm_tpu/ops/pallas/din_attention.py:35",
        "launches": serve_launches, "max_abs_err": max_err,
        "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound, "bound_by": by,
        "library_ms": None,
    }

    phase("6. full-width DIN trains on cuda through cli.main")
    work = tempfile.mkdtemp(prefix="chip_smoke_train_")
    atexit.register(shutil.rmtree, work, ignore_errors=True)
    zero_counts()
    din_final = train_cli("DIN", os.path.join(work, "din"), DIN_TRAIN_STEPS)
    din_train_launches = din_attention.launches
    print(f"din_attention launches in DIN training: {din_train_launches}")
    if din_train_launches <= 0 or not math.isfinite(din_final["loss"]):
        raise AssertionError("DIN training never launched din_attention or lost finiteness")

    phase(f"7. main path 2: full-width BST trains through cli.main on cuda, "
          f"B={BST_BATCH}, {BST_STEPS} steps (eval every {BST_EVAL_EVERY}), "
          f"then resumes to {BST_RESUME_STEPS}")
    from recalgorithm_tpu_torch.cli.main import EVAL_BATCHES

    bst_dir = os.path.join(work, "bst")
    zero_counts()
    first = train_cli("BST", bst_dir, BST_STEPS,
                      ["--eval_every_steps", str(BST_EVAL_EVERY),
                       "--save_checkpoints_steps", str(BST_EVAL_EVERY)])
    resumed = train_cli("BST", bst_dir, BST_RESUME_STEPS,
                        ["--eval_every_steps", str(BST_EVAL_EVERY),
                         "--save_checkpoints_steps", str(BST_EVAL_EVERY)])
    train_counts = bst_counts()
    print(f"BST kernel launches on the training path: {train_counts}")
    # inference forwards: every step-triggered eval, the final eval and the
    # predictions of each run, EVAL_BATCHES batches each
    evals = (BST_STEPS // BST_EVAL_EVERY + 2
             + (BST_RESUME_STEPS // BST_EVAL_EVERY - BST_STEPS // BST_EVAL_EVERY) + 2)
    want_counts = {"bst_attention_forward": EVAL_BATCHES * evals,
                   "bst_attention_forward_save": BST_RESUME_STEPS,
                   "bst_attention_backward": BST_RESUME_STEPS}
    if train_counts != want_counts:
        raise AssertionError(f"launches {train_counts}, want {want_counts} (one forward "
                             "with P and one backward per train step, one forward "
                             "without P per eval or predict batch)")
    for final in (first, resumed):
        if not all(math.isfinite(x) for x in final.values()):
            raise AssertionError(f"non-finite eval metrics: {final}")
    with open(os.path.join(bst_dir, "predictions.csv")) as f:
        rows = list(csv.reader(f))
    if rows[0] != ["read_comment_probabilities"] or len(rows) != 1 + EVAL_BATCHES * BST_BATCH:
        raise AssertionError(f"predictions.csv: header {rows[0]}, {len(rows)} lines")
    ckpts = sorted(os.listdir(os.path.join(bst_dir, "checkpoints")))
    best_dir = Predictor.latest_best(bst_dir)
    print(f"checkpoints {ckpts}; best export {best_dir}; predictions.csv "
          f"{len(rows) - 1} rows; final eval after resume {resumed}")
    if f"ckpt_{BST_RESUME_STEPS}.pt" not in ckpts or not os.path.exists(
            os.path.join(best_dir, convert.EXPORT_FILE)):
        raise AssertionError("missing checkpoint or best export")

    phase("8. one BST train step on cuda vs the CPU; kernels at its inputs; "
          "where a train step's time goes")
    bst_report = bst_step_phase(best_dir, train_counts, card, kind)

    phase("9. golden recipe (tests/golden_common.py) for BST on cuda")
    with open(os.path.join(REPO, "tests", "golden_bands.json")) as f:
        band = json.load(f)["BST"]
    center, width = band["auc"]["read_comment_auc"], band["band"]["read_comment_auc"]
    t0 = time.perf_counter()
    auc = golden_bst("cuda", os.path.join(work, "golden"))
    print(f"golden BST read_comment_auc {auc} (band {center} +- {width}), "
          f"{time.perf_counter() - t0:.2f} s")
    if not abs(auc - center) <= width:
        raise AssertionError(f"golden AUC {auc} outside {center} +- {width}")

    phase("10. the BST export served over HTTP on cuda")
    serve_bst(best_dir, gen)

    report = {"kernels": [din_entry, *bst_report]}
    print()
    print(card)
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
