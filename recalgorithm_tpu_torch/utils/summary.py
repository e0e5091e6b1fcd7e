"""Scalar and histogram summaries as JSONL, and a profiler scope.

Counterpart of ``recalgorithm_tpu/utils/summary.py`` (its TensorBoard
mirror is not ported): an append-only ``scalars.jsonl`` of ``{"step",
"time", tag: value}`` and histogram records that any tool can read, and
:func:`profile`, the ``torch.profiler`` counterpart of its ``jax.profiler``
scope.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Mapping


class SummaryWriter:
    """JSONL scalar and histogram sink."""

    def __init__(self, log_dir: str, enabled: bool = True):
        """``enabled=False`` (a process other than 0 of several) writes nothing."""
        self._f = None
        if enabled:
            os.makedirs(log_dir, exist_ok=True)
            self._f = open(os.path.join(log_dir, "scalars.jsonl"), "a", buffering=1)

    def scalars(self, step: int, values: Mapping[str, float]) -> None:
        if self._f is None:
            return
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: float(v) for k, v in values.items()})
        self._f.write(json.dumps(rec) + "\n")

    def histogram(self, step: int, tag: str, values, bins: int = 30) -> None:
        """tf.summary.histogram parity: binned counts and moments, one JSONL
        record."""
        if self._f is None:
            return
        import numpy as np

        v = np.asarray(values, dtype=np.float64).ravel()
        counts, edges = np.histogram(v, bins=bins)
        rec = {
            "step": int(step), "time": time.time(), "histogram": tag,
            "mean": float(v.mean()), "std": float(v.std()),
            "min": float(v.min()), "max": float(v.max()),
            "counts": counts.tolist(),
            "edges": [float(e) for e in edges],
        }
        self._f.write(json.dumps(rec) + "\n")

    def close(self) -> None:
        if self._f is not None:
            self._f.close()


@contextlib.contextmanager
def profile(log_dir: str, enabled: bool = True):
    """``torch.profiler`` scope over the host and, where there is one, the
    card; writes ``<log_dir>/trace.json`` (Chrome trace format, opened by
    chrome://tracing or Perfetto) when the scope ends."""
    if not enabled:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
