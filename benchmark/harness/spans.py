"""The program's own spans (llavamod_tpu_torch/runtime/trace.py), for the
per-layer metrics that read them.

The program records its spans while a `torch.profiler` runs, so a traced
run's profiled sub-window carries them.  `of(ctx)` collects them once,
after the run's last synchronise, into `ctx["spans"]`, where every metric
that reads them finds them; against a program without the recorder it
gives None, and so do those metrics.  A span is a dict: name, sid, parent,
id, thread, start_ns and end_ns (on `time.time_ns`, the clock kineto
stamps device activity with), cpu_ns, device_ms (spans with CUDA events)
and attrs.
"""

from __future__ import annotations

from typing import Iterable, List, Optional


def of(ctx: dict) -> Optional[List[dict]]:
    """The run's program spans, collected once into ctx["spans"]; None
    where the program records none."""
    if "spans" not in ctx:
        try:
            from llavamod_tpu_torch.runtime import trace
        except ImportError:
            ctx["spans"] = None
        else:
            ctx["spans"] = trace.collect()
    return ctx["spans"] or None


def named(spans: Iterable[dict], name: str) -> List[dict]:
    return [s for s in spans if s["name"] == name]


def host_ms(s: dict) -> float:
    return (s["end_ns"] - s["start_ns"]) / 1e6


def mean(values: Iterable[float]) -> Optional[float]:
    values = list(values)
    return sum(values) / len(values) if values else None
