"""Scalar summaries as JSONL.

Counterpart of ``recalgorithm_tpu/utils/summary.py`` (the JSONL sink only;
its TensorBoard mirror, histograms and ``jax.profiler`` scope are not
ported): an append-only ``scalars.jsonl`` of ``{"step", "time", tag: value}``
records that any tool can read.
"""

from __future__ import annotations

import json
import os
import time
from typing import Mapping


class SummaryWriter:
    """JSONL scalar sink."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self._f = open(os.path.join(log_dir, "scalars.jsonl"), "a", buffering=1)

    def scalars(self, step: int, values: Mapping[str, float]) -> None:
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: float(v) for k, v in values.items()})
        self._f.write(json.dumps(rec) + "\n")

    def close(self) -> None:
        self._f.close()
