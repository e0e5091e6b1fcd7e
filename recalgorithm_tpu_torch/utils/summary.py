"""Scalar and histogram summaries as JSONL, and a profiler scope.

Counterpart of ``recalgorithm_tpu/utils/summary.py``: an append-only
``scalars.jsonl`` of ``{"step", "time", tag: value}`` and histogram records
that any tool can read, mirrored to TensorBoard event files through
``torch.utils.tensorboard`` wherever that imports (the ``tensorboard``
package; optional, never required, as the JAX writer's ``flax.metrics``
mirror), and :func:`profile`, the ``torch.profiler`` counterpart of its
``jax.profiler`` scope.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Mapping


class SummaryWriter:
    """JSONL scalar and histogram sink with an optional TensorBoard mirror."""

    def __init__(self, log_dir: str, enabled: bool = True):
        """``enabled=False`` (a process other than 0 of several) writes nothing."""
        self._f = self._tb = None
        if enabled:
            os.makedirs(log_dir, exist_ok=True)
            self._f = open(os.path.join(log_dir, "scalars.jsonl"), "a", buffering=1)
            try:  # optional: mirror to TensorBoard where the package is installed
                from torch.utils.tensorboard import SummaryWriter as EventWriter

                self._tb = EventWriter(log_dir)
            except Exception:
                self._tb = None

    def scalars(self, step: int, values: Mapping[str, float]) -> None:
        if self._f is None:
            return
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: float(v) for k, v in values.items()})
        self._f.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            for k, v in values.items():
                self._tb.add_scalar(k, float(v), step)

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
        if self._tb is not None:
            try:
                self._tb.add_histogram(tag, v, step)
            except Exception:
                pass

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
        if self._tb is not None:
            self._tb.close()


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
