"""The device trace of a traced run's steady sub-window (torch.profiler,
CUPTI), reduced to what the readers need: the seconds in which some
device activity ran (the union of the activities' intervals), the traced
window's length, the device seconds by activity name, the longest idle
gaps named by the benchmark's own span (`record_function("bench.*")`)
that was open on the host when the gap began, and the device seconds of
the kernels whose names match given patterns (summed, or as the union of
their intervals).

Only device activity is recorded (CUPTI), not the host's operators,
whose recording would slow the host-bound steps it measures.  The
benchmark's spans (`span`) are kept by the benchmark itself on the wall
clock (`time.time_ns`), the clock kineto stamps its events with.  The raw
kineto events are read directly: `key_averages()` builds the host event
tree first, which takes tens of seconds for ~10^5 kernels.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, List, Optional, Tuple

_SPANS: List[Tuple[int, int, str]] = []
_LOCK = threading.Lock()


@contextlib.contextmanager
def span(name: str):
    """A host span of the benchmark's own, named `name` ("bench.*")."""
    t0 = time.time_ns()
    try:
        yield
    finally:
        with _LOCK:
            _SPANS.append((t0, time.time_ns(), name))


class Trace:
    def __init__(self):
        self.prof = None
        self.t0 = self.t1 = 0.0

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        with _LOCK:
            _SPANS.clear()
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self) -> "Summary":
        import torch

        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.__exit__(None, None, None)
        with _LOCK:
            spans = list(_SPANS)
        return summarize(self.prof, self.t1 - self.t0, spans)


class Summary:
    def __init__(self, window_s: float, busy_s: float,
                 by_name: Dict[str, float], gaps: List[Tuple[str, float]],
                 intervals: Tuple[Tuple[int, int, str], ...] = ()):
        self.window_s, self.busy_s = window_s, busy_s
        self.by_name, self.gaps = by_name, gaps
        self.intervals = intervals

    def seconds_of(self, patterns) -> float:
        return sum(s for n, s in self.by_name.items()
                   if any(p in n for p in patterns))

    def union_seconds(self, patterns) -> float:
        """The seconds in which some device activity whose name holds one
        of `patterns` ran: the union of their intervals, so activities
        that overlap (on other streams) count once."""
        spans = sorted((s, e) for s, e, n in self.intervals
                       if any(p in n for p in patterns))
        total, cur_s, cur_e = 0, None, 0
        for s, e in spans:
            if cur_s is None or s > cur_e:
                if cur_s is not None:
                    total += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_s is not None:
            total += cur_e - cur_s
        return total / 1e9

    def breakdown(self) -> Dict[str, list]:
        top = sorted(self.by_name.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n[:160], s] for n, s in top],
                "idle_gaps": [[n, s] for n, s in self.gaps[:10]]}


def summarize(prof, window_s: float, spans) -> Summary:
    from torch.autograd import DeviceType

    dev: List[Tuple[int, int]] = []
    intervals: List[Tuple[int, int, str]] = []
    by_name: Dict[str, float] = {}
    for e in prof.profiler.kineto_results.events():
        start, dur = e.start_ns(), e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            dev.append((start, start + dur))
            intervals.append((start, start + dur, e.name()))
            by_name[e.name()] = by_name.get(e.name(), 0.0) + dur / 1e9
    dev.sort()
    busy, gaps = 0, []
    cur_s: Optional[int] = None
    cur_e = 0
    for s, e in dev:
        if cur_s is None:
            cur_s, cur_e = s, e
        elif s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_s is not None:
        busy += cur_e - cur_s
    gaps.sort(key=lambda g: g[0] - g[1])
    named = []
    for g0, g1 in gaps[:10]:
        open_spans = [sp for sp in spans if sp[0] <= g0 < sp[1]]
        name = (min(open_spans, key=lambda sp: sp[1] - sp[0])[2]
                if open_spans else "bench.none")
        named.append((name, (g1 - g0) / 1e9))
    return Summary(window_s, busy / 1e9, by_name, named, tuple(intervals))
