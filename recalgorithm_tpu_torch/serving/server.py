"""Dynamic-batching serving loop: concurrent requests -> padded device batches.

The reference delegates serving to TF-Serving, whose core runtime feature is
request batching (SavedModel export + "for tf-serving deployment",
reference README.md:8).  This is the built-in equivalent: a background
worker drains a request queue, coalesces single examples into one padded
batch (bucketed to a few fixed shapes, so the device sees a handful of batch
shapes, never one per request), runs the forward, and resolves per-request
futures.

Latency/throughput contract: a request waits at most ``max_delay_ms`` for
co-batching; under load, batches fill to ``max_batch_size`` and the delay
never engages.  Bucketing pads with zero rows masked out via ``_weights``
(the framework's standard padded-tail convention), so results are identical
to unbatched prediction.

Each flush is the span ``serve.flush`` (``utils/summary.py``) over
``serve.stack``, the predictor's own spans and ``serve.resolve``; while a
profiler runs it also records each example's ``serve.queue``, from its
enqueue to the flush's start.  ``stats()`` keeps the last 4,096 flush
durations and the last 4,096 batches' oldest queue waits.
"""

from __future__ import annotations

import collections
import queue
import threading
import time
from concurrent.futures import Future
from typing import Mapping

import numpy as np

from recalgorithm_tpu_torch.utils import summary


_SENTINEL = object()
RING = 4096  # batches whose flush time and queue wait stats() summarizes


class BatchingPredictor:
    """Wraps a Predictor (or any ``predict_batch(dict)->dict``) with a
    dynamic-batching worker thread."""

    def __init__(
        self,
        predictor,
        max_batch_size: int = 256,
        max_delay_ms: float = 2.0,
        buckets: tuple[int, ...] | None = None,
    ):
        self.predictor = predictor
        self.max_batch_size = max_batch_size
        self.max_delay_s = max_delay_ms / 1e3
        # always include max_batch_size itself: a full queue drains
        # max_batch_size requests at once and _bucket must have a shape
        # >= any pending count (a bucket smaller than the row count would
        # truncate _weights and bring an unseen shape to the hot path)
        self.buckets = tuple(sorted(
            {b for b in (buckets or (8, 32, 128, 256, 512, 1024))
             if b <= max_batch_size} | {max_batch_size}
        ))
        self._q: queue.Queue = queue.Queue()
        # serving counters (read by stats()/the /metrics endpoint): updated
        # only on the worker thread, snapshot under the lock
        self._stats_lock = threading.Lock()
        self._n_requests = 0
        self._n_batches = 0
        self._n_errors = 0
        # last RING flush durations, and each batch's oldest queue wait (s)
        self._flush_s: collections.deque = collections.deque(maxlen=RING)
        self._wait_s: collections.deque = collections.deque(maxlen=RING)
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    # -- client API ----------------------------------------------------------

    def predict_async(self, features: Mapping[str, np.ndarray]) -> Future:
        """Enqueue ONE example (unbatched feature dict); resolves to a dict
        of per-task probabilities (scalars)."""
        fut: Future = Future()
        self._q.put((features, fut, time.perf_counter()))
        return fut

    def predict_one(self, features: Mapping[str, np.ndarray]) -> dict:
        return self.predict_async(features).result()

    def warmup(self, example: Mapping[str, np.ndarray]) -> None:
        """Run every bucket shape once up front (one forward per bucket) so
        no client request pays a first-call cost (kernel build and load,
        library handles, allocator growth)."""
        for b in self.buckets:
            batch = {
                k: np.broadcast_to(
                    np.asarray(v)[None], (b,) + np.asarray(v).shape
                ).copy()
                for k, v in example.items()
            }
            batch["_weights"] = np.ones(b, np.float32)
            self.predictor.predict_batch(batch)

    def close(self):
        self._q.put(_SENTINEL)
        self._worker.join(timeout=10)

    def stats(self) -> dict:
        """Serving counters, and percentiles of the flush time (the batch
        from stacking to its answers) and of each batch's oldest queue wait
        over the last RING batches (for /metrics)."""
        with self._stats_lock:
            flush, wait = sorted(self._flush_s), sorted(self._wait_s)
            out = {
                "requests": self._n_requests,
                "batches": self._n_batches,
                "errors": self._n_errors,
                "queue_depth": self._q.qsize(),
                "mean_batch_size": round(
                    self._n_requests / self._n_batches, 2
                ) if self._n_batches else 0.0,
            }
        for key, lat in (("batch_latency", flush), ("queue_wait", wait)):
            if lat:
                out[f"{key}_ms_p50"] = round(lat[len(lat) // 2] * 1e3, 2)
                out[f"{key}_ms_p99"] = round(
                    lat[min(int(len(lat) * 0.99), len(lat) - 1)] * 1e3, 2)
        return out

    # -- worker --------------------------------------------------------------

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def _run(self):
        while True:
            item = self._q.get()
            if item is _SENTINEL:
                return
            pending = [item]
            deadline = time.monotonic() + self.max_delay_s
            while len(pending) < self.max_batch_size:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is _SENTINEL:
                    self._flush(pending)
                    return
                pending.append(nxt)
            self._flush(pending)

    def _flush(self, pending):
        with summary.span("serve.flush", timed=True) as flush:
            if flush.id is not None:
                for _, _, enqueued in pending:
                    summary.add_span("serve.queue", enqueued, flush.start, flush.id)
            served = self._serve(pending)
        if served:
            with self._stats_lock:
                self._flush_s.append(flush.end - flush.start)
                self._wait_s.append(flush.start - pending[0][2])

    def _serve(self, pending) -> bool:
        """One padded batch through the predictor, its answers to the
        futures; False where it failed (every future then holds the error)."""
        # the ENTIRE flush runs under the except-to-futures net: a single
        # malformed request (missing key, ragged shape) must fail its batch's
        # futures, not kill the worker thread and hang every later request
        n = len(pending)
        try:
            with summary.span("serve.stack"):
                b = self._bucket(n)
                feats = [f for f, _, _ in pending]
                batch: dict[str, np.ndarray] = {}
                for key in feats[0]:
                    rows = np.stack([np.asarray(f[key]) for f in feats])
                    if n < b:
                        pad = np.zeros((b - n,) + rows.shape[1:], rows.dtype)
                        rows = np.concatenate([rows, pad])
                    batch[key] = rows
                batch["_weights"] = (np.arange(b) < n).astype(np.float32)
            probs = self.predictor.predict_batch(batch)
            with summary.span("serve.resolve"):
                # scalar per task (rankers) stays a float; vector per task
                # (retrieval top-k ids/scores) comes back as an ndarray row
                results = [
                    {t: (float(p[i]) if np.ndim(p[i]) == 0 else np.asarray(p[i]))
                     for t, p in probs.items()}
                    for i in range(n)
                ]
                with self._stats_lock:
                    self._n_requests += n
                    self._n_batches += 1
                for res, (_, fut, _) in zip(results, pending):
                    fut.set_result(res)
        except Exception as exc:  # propagate to every waiting client
            with self._stats_lock:
                self._n_errors += n
            for _, fut, _ in pending:
                if not fut.done():
                    fut.set_exception(exc)
            return False
        return True
