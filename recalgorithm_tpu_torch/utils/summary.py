"""Scalar and histogram summaries as JSONL, a profiler scope, and spans.

Counterpart of ``recalgorithm_tpu/utils/summary.py``: an append-only
``scalars.jsonl`` of ``{"step", "time", tag: value}`` and histogram records
that any tool can read, mirrored to TensorBoard event files through
``torch.utils.tensorboard`` wherever that imports (the ``tensorboard``
package; optional, never required, as the JAX writer's ``flax.metrics``
mirror), and :func:`profile`, the ``torch.profiler`` counterpart of its
``jax.profiler`` scope.

The port's phases record spans (:func:`span`, :func:`add_span`) while a
torch profiler runs, and only then: :func:`profile`, ``cli/main.py
--profile_dir``, or any other ``torch.profiler.profile``.  A scoped span is
kept in memory (:func:`spans`) and entered as a ``record_function``, so it
also lands in the profiler's trace, nested over the operations and kernels
it issued, where the profiler records its thread (by default only the
thread that started the profiler: the batcher's worker spans are then in
memory only).  With no profiler running a span costs one flag check.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from typing import Mapping, NamedTuple

import torch
from torch.autograd import profiler as _autograd_profiler


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
    chrome://tracing or Perfetto) when the scope ends.  The port's spans
    (:func:`span`) are recorded while it runs, and those of the thread that
    entered it (``train.step`` over its phases) ride its trace as user
    annotations, on the clock of the operations and kernels beneath them."""
    if not enabled:
        yield
        return
    from torch.profiler import ProfilerActivity

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


# -- spans --------------------------------------------------------------------

MAX_SPANS = 1 << 20  # records kept; later ones are counted as dropped


class SpanRecord(NamedTuple):
    """One span, ``start`` and ``end`` on ``time.perf_counter()``; ``parent``
    is the id of the innermost span open on the same thread when it began
    (None at a root)."""

    name: str
    id: int
    parent: int | None
    start: float
    end: float


_records: list[SpanRecord] = []
_dropped = 0
_lock = threading.Lock()
_ids = itertools.count(1)
_local = threading.local()  # .stack: ids of the thread's open recorded spans
# The recorder is on exactly while a torch profiler runs: span() and
# add_span() read the profiler's own Python flag, set on its start and
# cleared on its stop (one attribute read; record_function costs ~10 us
# even with no profiler).


def _stack() -> list[int]:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def _keep(record: SpanRecord) -> None:
    global _dropped
    with _lock:
        if len(_records) < MAX_SPANS:
            _records.append(record)
        else:
            _dropped += 1


class _Span:
    """A scoped span.  ``id`` is None where the recorder was off at its
    start: then it records nothing and enters no ``record_function``, and
    only reads the clock (a ``timed`` span, whose caller uses the times)."""

    __slots__ = ("name", "id", "parent", "start", "end", "_fn")

    def __init__(self, name: str, keep: bool):
        self.name = name
        self.id = next(_ids) if keep else None
        self.parent = None

    def __enter__(self) -> "_Span":
        if self.id is not None:
            stack = _stack()
            self.parent = stack[-1] if stack else None
            stack.append(self.id)
            self._fn = torch.profiler.record_function(self.name)
            self._fn.__enter__()
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self.end = time.perf_counter()
        if self.id is not None:
            self._fn.__exit__(*exc)
            _stack().pop()
            _keep(SpanRecord(self.name, self.id, self.parent, self.start, self.end))
        return False


class _Off:
    """The span of a recorder that is off: no clock, no record."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


def span(name: str, timed: bool = False):
    """Context manager timing the host from entry to exit as span ``name``,
    child of the innermost span open on this thread.  It is kept if the
    recorder is on at entry.  ``timed=True`` reads the clock even when it is
    off, for a caller that uses ``.start`` and ``.end`` itself.  Spans time
    the host only: they add no synchronization."""
    if _autograd_profiler._is_profiler_enabled:
        return _Span(name, True)
    return _Span(name, False) if timed else _OFF


def add_span(name: str, start: float, end: float, parent: int | None = None) -> None:
    """Record a span whose start was taken earlier (``perf_counter()``
    times), while the recorder is on; in memory only, not in the trace."""
    if _autograd_profiler._is_profiler_enabled:
        _keep(SpanRecord(name, next(_ids), parent, start, end))


def spans() -> list[SpanRecord]:
    """The kept spans, in the order they ended."""
    with _lock:
        return list(_records)


def dropped() -> int:
    """Spans not kept because the buffer held MAX_SPANS."""
    return _dropped


def clear() -> None:
    """Forget the kept spans and the drop count."""
    global _dropped
    with _lock:
        _records.clear()
        _dropped = 0
