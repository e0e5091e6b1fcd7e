"""The traced window: ``torch.profiler`` over part of a ``--trace 1`` run.

Device time is the union of the intervals in which a kernel or a copy ran
(one stream, so this is the sum of their durations); ``busy_s`` is it and
``window_s`` the host clock from the profiler's start to its stop, which
follows a ``torch.cuda.synchronize()``.  The breakdown lists the device
operations that took most time, and the idle gaps between device work, each
named by the innermost host operation running when it opened.
"""

from __future__ import annotations

import bisect
import dataclasses
import time
from collections import defaultdict

TOP = 10
NAME_CHARS = 160  # a kernel's name is cut to this many characters in the breakdown
LOOKBACK = 256  # host events searched back from a gap for the one covering it


@dataclasses.dataclass
class Trace:
    """What the per-layer readers read (``metrics/<name>.py``)."""

    kind: str
    cfg: dict
    window_s: float
    busy_s: float
    events: list          # (name, start_us, duration_us) of every device op
    breakdown: dict
    data: dict            # what the cell's driver counted in the window

    def device_ms(self, *patterns: str) -> tuple[float, int]:
        """Total ms and count of the device ops whose name holds a pattern."""
        hits = [d for n, _, d in self.events if any(p in n for p in patterns)]
        return sum(hits) / 1e3, len(hits)


class Session:
    """One profiler window; ``stop`` synchronizes the device first."""

    def __init__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self._torch = torch
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.t0 = self.t1 = self.closed = None

    def start(self) -> None:
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        """Ends the window at ``t1``; collecting the trace holds the process
        until ``closed``."""
        self._torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.__exit__(None, None, None)
        self.closed = time.perf_counter()

    def read(self, kind: str, cfg: dict, data: dict) -> Trace:
        from torch.autograd import DeviceType

        device, host = [], []
        for e in self.prof.events():
            start, end = e.time_range.start, e.time_range.end
            if e.device_type == DeviceType.CUDA:
                if not getattr(e, "is_user_annotation", False):
                    device.append((e.name, start, end - start))
            elif not getattr(e, "is_user_annotation", False):
                host.append((start, end, e.name))
        if not device:
            raise RuntimeError("the traced window holds no device operation")
        busy, gaps = _busy_and_gaps(device)
        by_name: dict[str, float] = defaultdict(float)
        for name, _, dur in device:
            by_name[name] += dur / 1e6
        return Trace(kind=kind, cfg=cfg, window_s=self.t1 - self.t0, busy_s=busy / 1e6,
                     events=device, data=data, breakdown={
                         "device_ops": _top(by_name),
                         "idle_gaps": _top(_name_gaps(gaps, host))})


def _busy_and_gaps(device: list) -> tuple[float, list]:
    """Union length of the device intervals (us) and the gaps between them."""
    spans = sorted((s, s + d) for _, s, d in device)
    busy, gaps = 0.0, []
    cur_s, cur_e = spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return busy + cur_e - cur_s, gaps


def _name_gaps(gaps: list, host: list) -> dict[str, float]:
    """Seconds of idle device time by the innermost host op covering each
    gap's start ("python" where none does)."""
    host.sort()
    starts = [h[0] for h in host]
    out: dict[str, float] = defaultdict(float)
    for g0, g1 in gaps:
        i = bisect.bisect_right(starts, g0)
        best = None
        for start, end, name in reversed(host[max(0, i - LOOKBACK):i]):
            if end >= g0 and (best is None or end - start < best[0]):
                best = (end - start, name)
        out[best[1] if best else "python"] += (g1 - g0) / 1e6
    return out


def _top(totals: dict[str, float]) -> list:
    return [[name[:NAME_CHARS], secs] for name, secs in
            sorted(totals.items(), key=lambda kv: -kv[1])[:TOP]]
