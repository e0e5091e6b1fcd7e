"""Peaks of one NVIDIA H100 and the least time of the hand kernels' work.

The bound arithmetic is a frozen copy of the port's ``chip_smoke.py``
(``din_attention_bound_ms``, ``bst_bound_ms``): the FLOP and the bytes the
run's own lengths need, each over its published peak, the larger of the two.
Peaks: NVIDIA's H100 SXM data sheet, float32 outside the tensor cores, and
HBM3 bandwidth, at the full 700 W power limit.
"""

from __future__ import annotations

import numpy as np

PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def din_attention_bound_ms(lengths: np.ndarray, t: int, use_softmax: bool):
    """Least time for the DIN attention kernel's work on these lengths (source
    note of csrc/din_attention.cu): 6240 FLOP per valid step + 4096 per
    example, the valid keys read once, q/lengths/out once, the weights once.
    Returns (ms, "operations" or "bytes")."""
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
    backward reads it; lengths once.  Returns (ms, "operations" or
    "bytes")."""
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
