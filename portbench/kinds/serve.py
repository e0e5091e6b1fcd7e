"""Serving cells: ranking requests through ``BatchingPredictor`` over
``Predictor``, as ``cli/serve.py`` serves them.

Set-up makes the weights from the seed on the device, writes them as an
export under TMPDIR (``convert.save_export``), loads it through
``Predictor`` into a model built on the host, wraps it in the batcher with
the configuration's settings, and runs every bucket once (the batcher's
``warmup``) and one request through the queue.  The window is an open loop:
request r is due at its arrival time, and all its candidates are enqueued
then; its latency runs from that due time to its last candidate's answer.
After the last arrival the run waits up to ``DRAIN_SECONDS`` for answers; a
request with a candidate that failed or is still unanswered then counts as
failed, with the drain's end as its latency.  A traced run profiles the
window's first ``TRACE_SECONDS``, times each ``predict_batch`` call of the
window and reads the batcher's counters over it; the readings of the whole
process (the tail, the interpreter's pauses) are taken over the window's
quiet part, from ``SETTLE_SECONDS`` after collecting the trace let the
process go to the window's end.
"""

from __future__ import annotations

import dataclasses
import functools
import time

import numpy as np

from portbench import check, harness, weights
from portbench.kinds import program_model
from portbench.kinds.train import free_device
from portbench.traffic import serve as traffic

DRAIN_SECONDS = 60.0
TRACE_SECONDS = 2.0
SETTLE_SECONDS = 1.0  # after the profiler's stop, before the quiet part of a traced window
LEAD_SECONDS = 0.05  # from the window's start to its first due time
POLL_SECONDS = 0.01  # how often the drain looks for the last answers


@dataclasses.dataclass
class Served:
    predictor: object
    batcher: object


def build(cfg: dict, seed: int, device: str, workload: str) -> Served:
    from recalgorithm_tpu_torch import convert
    from recalgorithm_tpu_torch.serving.predictor import Predictor
    from recalgorithm_tpu_torch.serving.server import BatchingPredictor

    w = weights.make(cfg, seed, device)
    model, _ = program_model(cfg, w, device)
    model_dir = harness.scratch_dir(workload) / "model"
    export_dir = convert.save_export(str(model_dir), 0, 0.0, model)
    del model, w
    host_model, _ = program_model(cfg, None, "cpu")
    pred = Predictor(host_model, export_dir, device=device)
    s = cfg["serving"]
    batcher = BatchingPredictor(pred, max_batch_size=s["max_batch_size"],
                                max_delay_ms=s["max_delay_ms"], buckets=tuple(s["buckets"]))
    return Served(pred, batcher)


def warm(served: Served, reqs: traffic.Requests) -> None:
    """Every bucket once, then one request through the queue."""
    served.batcher.warmup(reqs.features(0)[0])
    futures = [served.batcher.predict_async(f) for f in reqs.features(0)]
    for f in futures:
        f.result()


def _answer(done: np.ndarray, probs: np.ndarray, c: int, future) -> None:
    """A candidate's answer: when it came, and its probability (NaN and no
    time where the future failed).  The future is not kept: the run holds
    no more objects than a server would."""
    if future.exception() is None:
        probs[c] = future.result()["read_comment"]
        done[c] = time.perf_counter()
    else:
        done[c] = -1.0


class CallTimer:
    """Wraps ``predict_batch``: each call's host start and end, its real
    rows (``_weights`` > 0) and their history lengths."""

    def __init__(self, predictor, history: str):
        self.inner = predictor.predict_batch
        self.history = history
        self.calls: list = []
        predictor.predict_batch = self

    def __call__(self, batch):
        t0 = time.perf_counter()
        out = self.inner(batch)
        real = np.asarray(batch["_weights"]) > 0
        self.calls.append((t0, time.perf_counter(), batch[self.history + "_len"][real]))
        return out


@dataclasses.dataclass
class Window:
    latency_ms: np.ndarray    # (N,)
    failed: np.ndarray        # (N,) bool
    probs: np.ndarray         # (C,) served probability, NaN where none
    answered_s: float         # when the last answer came, after the window opened
    late_ms: np.ndarray       # (N,) how late the generator enqueued each request
    trace: object = None


def drive(served: Served, reqs: traffic.Requests, seconds: float, trace_cfg=None,
          drain: float = DRAIN_SECONDS) -> Window:
    """The open loop over ``reqs``; with ``trace_cfg`` the first
    TRACE_SECONDS are profiled."""
    batcher = served.batcher
    n, c = len(reqs), reqs.candidates
    done = np.full(c, np.nan)   # answer time; -1 where the candidate failed
    probs = np.full(c, np.nan)
    late = np.zeros(n)
    session = timer = None
    if trace_cfg is not None:
        from portbench.trace import Session

        timer = CallTimer(served.predictor, reqs.history)
        stats0 = batcher.stats()
        session = Session()
        session.start()
    t0 = time.perf_counter() + LEAD_SECONDS
    trace_end = t0 + TRACE_SECONDS
    for r in range(n):
        due = t0 + reqs.arrivals[r]
        wait = due - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        late[r] = time.perf_counter() - due
        for i, feats in enumerate(reqs.features(r)):
            batcher.predict_async(feats).add_done_callback(
                functools.partial(_answer, done, probs, reqs.offsets[r] + i))
        if session is not None and session.t1 is None and time.perf_counter() >= trace_end:
            session.stop()
    deadline = t0 + seconds + drain
    while np.isnan(done).any() and time.perf_counter() < deadline:
        time.sleep(POLL_SECONDS)
    if session is not None and session.t1 is None:
        session.stop()
    bad = np.isnan(done) | (done < 0)
    due = t0 + reqs.arrivals
    last = np.maximum.reduceat(np.where(bad, deadline, done), reqs.offsets[:-1])
    failed = np.logical_or.reduceat(bad, reqs.offsets[:-1])
    trace = None
    if session is not None:
        stats1 = batcher.stats()
        quiet = session.closed + SETTLE_SECONDS
        trace = session.read("serve", trace_cfg, {
            "quiet_latency_ms": ((last - due) * 1e3)[due >= quiet],
            "quiet": (quiet, t0 + seconds),
            "calls": timer.calls,
            "traced_calls": sum(session.t0 <= x[0] < session.t1 for x in timer.calls),
            "requests": stats1["requests"] - stats0["requests"],
            "batches": stats1["batches"] - stats0["batches"]})
    return Window(latency_ms=(last - due) * 1e3, failed=failed, probs=probs,
                  answered_s=float(np.max(np.where(bad, -np.inf, done)) - t0),
                  late_ms=late * 1e3, trace=trace)


def reference_probs(cfg: dict, seed: int, reqs: traffic.Requests, idx: np.ndarray, device,
                    tf32: bool = False, block: int = 65536) -> np.ndarray:
    """The reference's probabilities of candidates ``idx``, from the seed's
    weights, in blocks."""
    import torch

    from portbench import reference
    from portbench.reference import din

    params = weights.make(cfg, seed, device)
    out = []
    with reference.precision(tf32):
        for i in range(0, len(idx), block):
            rows = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                    for k, v in reqs.rows(idx[i:i + block]).items()}
            out.append(din.probabilities(params, cfg, rows).double().cpu().numpy())
    return np.concatenate(out) if out else np.zeros(0)


def compare(cfg: dict, seed: int, reqs: traffic.Requests, probs: np.ndarray, device
            ) -> tuple[float, int]:
    """The largest |served - reference| over the answered candidates, and
    how many were compared."""
    answered = np.flatnonzero(~np.isnan(probs))
    ref = reference_probs(cfg, seed, reqs, answered, device)
    return (float(np.abs(probs[answered] - ref).max()) if len(answered) else 0.0), len(answered)


def run(run: harness.Run) -> harness.Result:
    import torch

    cfg = run.cfg
    harness.mark(run, "imports")
    reqs = traffic.requests(cfg["schema"], run.cell["traffic"], run.seconds, run.seed)
    harness.mark(run, "requests")
    served = build(cfg, run.seed, run.device, run.workload)
    harness.mark(run, "export and predictor")
    warm(served, reqs)
    setup_s = time.perf_counter() - run.started
    cpu0 = time.process_time()
    with harness.GCPauses() as pauses:
        win = drive(served, reqs, run.seconds, cfg if run.trace else None)
    if win.trace is not None:
        start, end = win.trace.data["quiet"]
        win.trace.data["quiet_gc_share"] = sum(
            took for at, took in pauses.pauses if start <= at < end) / (end - start)
    harness.log(f"process CPU over the window and drain {time.process_time() - cpu0:.3f} s; "
                f"garbage collection: {pauses}")
    peak = torch.cuda.max_memory_allocated() if run.device == "cuda" else 0
    served.batcher.close()
    del served
    free_device()
    p50, p99 = (float(np.percentile(win.latency_ms, q)) for q in (50, 99))
    harness.log(f"window: {len(reqs)} requests, {reqs.candidates} candidates, "
                f"{int(win.failed.sum())} failed, last answer at {win.answered_s:.6f} s, "
                f"p50 {p50:.6f} ms, p99 {p99:.6f} ms, generator late p99 "
                f"{float(np.percentile(win.late_ms, 99)):.6f} ms, set-up {setup_s:.3f} s")
    gap, compared = compare(cfg, run.seed, reqs, win.probs, run.device)
    harness.log(f"prob_gap {gap!r} over {compared} answered candidates")
    correct, checks = check.judge({"prob_gap": (gap, "")}, run.cell["limits"])
    correct = correct and compared > 0 and not win.failed.any()
    return harness.Result(correct=correct, attempted=len(reqs), failed=int(win.failed.sum()),
                          e2e={"serve_p50_ms": p50, "setup_s": setup_s},
                          checks=checks, trace=win.trace, memory_peak_bytes=peak)
