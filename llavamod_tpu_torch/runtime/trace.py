"""Program spans: named intervals at the port's layer boundaries, kept in
memory on the clock the device trace uses.

    from llavamod_tpu_torch.runtime import trace

    trace.enable()
    with trace.span("train.update", device=True) as sp:
        ...
        sp.set(applied=True)
    torch.cuda.synchronize()
    records = trace.collect()

A span has a name, a start and an end on `time.time_ns` (the clock kineto
stamps device events with, so a span lines up with a `torch.profiler`
trace), the thread's CPU time over it (`time.thread_time_ns`: wall time
less CPU time is time the thread waited, on the interpreter lock, a
blocking copy to the host or a queue), its thread, the span that caused it
(`parent`: the innermost span open on the thread) and an identifier shared
by the spans of one request or one batch (`id`: the parent's, unless
given).  With `device=True` it also records a CUDA event pair on the
current stream at its edges; `collect()` resolves the pair to the device
milliseconds between them, so call it after the work has been
synchronised.  Nothing here synchronises on the hot path.

The recorder is off by default, and then `span` returns one shared no-op
context after two flag checks: it reads no clock, records no event and
keeps nothing.  It is on between `enable()` and `disable()`, and while a
`torch.profiler` runs, so that a profiled window carries the program's
spans on the profile's own clock without a call into this module (the
benchmark's traced runs read them so).  While a profiler runs each span is
also a `record_function`, which a profile with CPU activity shows by name.

Records live in a bounded buffer (the oldest go first).  Where the spans
sit and which metric reads each: PERF.md, section 3.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import Any, Dict, List

import torch
from torch.autograd import profiler as _profiler

MAX_RECORDS = 20_000

_on = False
_records: collections.deque = collections.deque(maxlen=MAX_RECORDS)
_sids = itertools.count(1)
_local = threading.local()


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def _stack() -> list:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


class _NullSpan:
    """What `span` returns while the recorder is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


_NULL = _NullSpan()


class Span:
    __slots__ = ("name", "id", "parent", "attrs", "sid", "thread",
                 "start_ns", "end_ns", "cpu_ns", "_events", "_rf")

    def __init__(self, name: str, id, device: bool, attrs: Dict[str, Any]):
        self.name, self.id, self.parent, self.attrs = name, id, None, attrs
        self.sid = next(_sids)
        self.thread = threading.get_ident()
        self.start_ns = self.end_ns = self.cpu_ns = self._rf = None
        self._events = ((torch.cuda.Event(enable_timing=True),
                         torch.cuda.Event(enable_timing=True))
                        if device and torch.cuda.is_available() else None)

    def set(self, **attrs) -> None:
        """Add attributes known only inside the span."""
        self.attrs.update(attrs)

    def __enter__(self):
        st = _stack()
        if st:
            self.parent = st[-1].sid
            if self.id is None:
                self.id = st[-1].id
        st.append(self)
        if _profiler._is_profiler_enabled:
            self._rf = _profiler.record_function(self.name)
            self._rf.__enter__()
        if self._events is not None:
            self._events[0].record()
        self.cpu_ns = time.thread_time_ns()
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.time_ns()
        self.cpu_ns = time.thread_time_ns() - self.cpu_ns
        if self._events is not None:
            self._events[1].record()
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        st = _stack()
        if st and st[-1] is self:
            st.pop()
        _records.append(self)
        return False

    def as_dict(self) -> Dict[str, Any]:
        device_ms = None
        if self._events is not None:
            self._events[1].synchronize()
            device_ms = self._events[0].elapsed_time(self._events[1])
        return {"name": self.name, "sid": self.sid, "parent": self.parent,
                "id": self.id, "thread": self.thread,
                "start_ns": self.start_ns, "end_ns": self.end_ns,
                "cpu_ns": self.cpu_ns, "device_ms": device_ms,
                "attrs": self.attrs}


def span(name: str, *, id=None, device: bool = False, **attrs):
    """A context manager that records the block as span `name` while the
    recorder is on."""
    if not _on and not _profiler._is_profiler_enabled:
        return _NULL
    return Span(name, id, device, attrs)


def stamp() -> int:
    """`time.time_ns()` while the recorder is on, else 0: the start of a
    span that `record` closes later."""
    if not _on and not _profiler._is_profiler_enabled:
        return 0
    return time.time_ns()


def record(name: str, start_ns: int, *, id=None, **attrs) -> None:
    """Record a span from `start_ns` (a `stamp()`; 0 records nothing) until
    now: a request's wait, which belongs to no thread (its `thread` and
    `cpu_ns` are None).  Its parent is the span open on the calling
    thread."""
    if not start_ns or (not _on and not _profiler._is_profiler_enabled):
        return
    st = _stack()
    _records.append({"name": name, "sid": next(_sids),
                     "parent": st[-1].sid if st else None, "id": id,
                     "thread": None, "start_ns": start_ns,
                     "end_ns": time.time_ns(), "cpu_ns": None,
                     "device_ms": None, "attrs": attrs})


def collect() -> List[Dict[str, Any]]:
    """The records in the order they closed, as dicts (name, sid, parent,
    id, thread, start_ns, end_ns, cpu_ns, device_ms, attrs); clears the
    buffer."""
    out = []
    while _records:
        r = _records.popleft()
        out.append(r.as_dict() if isinstance(r, Span) else r)
    return out
