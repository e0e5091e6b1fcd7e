"""The program's own spans, as the span readers (``metrics/step_*_ms.train.py``,
``metrics/*.serve.py`` of source ``program_span``) read them.

The program (``recalgorithm_tpu_torch/utils/summary.py``) records spans only
while a torch profiler runs, so in a ``--trace 1`` run they are the traced
window's.  Where the program has no recorder, or its buffer dropped spans,
every reader finds nothing.  Times are ``time.perf_counter()`` seconds.
"""

from __future__ import annotations

import statistics


def recorded() -> list | None:
    """The program's spans; None where it has no recorder or dropped some."""
    try:
        from recalgorithm_tpu_torch.utils import summary

        records, dropped = summary.spans(), summary.dropped()
    except (ImportError, AttributeError):
        return None
    return None if dropped else records


def under(records: list, parent: str, child: str) -> tuple[list, int]:
    """Durations (s) of the ``child`` spans whose parent is a ``parent``
    span, and how many ``parent`` spans there are."""
    ids = {r.id for r in records if r.name == parent}
    return [r.end - r.start for r in records if r.name == child and r.parent in ids], len(ids)


def per_step_ms(trace, phase: str) -> float | None:
    """ms a train step spends in ``phase``: its spans under ``train.step``,
    summed, over the ``train.step`` spans."""
    records = recorded() if trace.kind == "train" else None
    if not records:
        return None
    took, steps = under(records, "train.step", phase)
    return 1e3 * sum(took) / steps if took else None


def per_batch_ms(trace, name: str) -> float | None:
    """Mean ms of ``name`` a served batch: its spans under a ``serve.flush``
    (one a batch; a batch cut by the window's edge has none)."""
    records = recorded() if trace.kind == "serve" else None
    if not records:
        return None
    took, _ = under(records, "serve.flush", name)
    return 1e3 * sum(took) / len(took) if took else None


def median_ms(trace, name: str) -> float | None:
    """Median ms over the ``name`` spans under a ``serve.flush``."""
    records = recorded() if trace.kind == "serve" else None
    if not records:
        return None
    took, _ = under(records, "serve.flush", name)
    return 1e3 * statistics.median(took) if took else None
