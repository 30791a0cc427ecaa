"""The per-layer metrics that read the program's spans, each fed a
synthetic span list and checked against its value worked by hand, and
their reading of the program's recorder."""

import sys

import pytest

from benchmark import run

MS = 1_000_000


def S(name, t0, t1, *, thread=1, sid=None, parent=None, device_ms=None,
      **attrs):
    """A span from t0 to t1 milliseconds."""
    return {"name": name, "sid": sid, "parent": parent, "id": None,
            "thread": thread, "start_ns": int(t0 * MS), "end_ns": int(t1 * MS),
            "cpu_ns": 0, "device_ms": device_ms, "attrs": attrs}


SERVE = [
    S("serve.queue", 0, 10, thread=None), S("serve.queue", 5, 35, thread=None),
    S("generate.prefill", 0, 50, device_ms=50.0),      # no batch before it
    S("generate.decode_step", 50, 60, device_ms=5.0),
    S("serve.fanout", 100, 110),
    S("other.span", 110, 120, thread=2),               # another thread
    S("generate.prefill", 140, 200, device_ms=70.0),   # gap 140 - 100
    S("generate.decode_step", 200, 210, device_ms=7.0),
    S("generate.decode_step", 210, 220, device_ms=9.0),
    S("serve.fanout", 300, 310),
    S("generate.prefill", 310, 400, device_ms=60.0),   # gap 310 - 300
]
TRAIN = [
    S("data.next", 0, 5), S("data.wait", 1, 4), S("data.send", 4, 5),
    S("train.teacher_fwd", 10, 40, device_ms=30.0),
    S("train.update", 40, 42, applied=False),
    S("data.next", 50, 52), S("data.wait", 50, 51),
    S("train.teacher_fwd", 60, 110, device_ms=50.0),
    S("train.update", 110, 210, applied=True),
]


@pytest.mark.parametrize("metric,spans,want", [
    ("queue_wait_ms.serve", SERVE, 20.0),
    ("batch_gap_ms.serve", SERVE, 25.0),
    ("prefill_ms.serve", SERVE, 60.0),
    ("decode_step_ms.serve", SERVE, 7.0),
    ("loader_wait_ms.train", TRAIN, 2.0),
    ("update_ms.train", TRAIN, 100.0),
    ("teacher_fwd_ms.train", TRAIN, 40.0),
])
def test_each_span_metric_by_hand(metric, spans, want):
    assert run.read_metric(metric, {"spans": spans}) == pytest.approx(want)
    # nothing to read: another cell's spans, or none
    other = TRAIN if spans is SERVE else SERVE
    assert run.read_metric(metric, {"spans": other}) is None
    assert run.read_metric(metric, {"spans": []}) is None


def test_spans_come_from_the_program_once(monkeypatch):
    from llavamod_tpu_torch.runtime import trace

    trace.collect()
    trace.enable()
    try:
        with trace.span("serve.queue"):
            pass
    finally:
        trace.disable()
    ctx = {}
    assert run.read_metric("queue_wait_ms.serve", ctx) is not None
    assert [s["name"] for s in ctx["spans"]] == ["serve.queue"]
    assert run.read_metric("queue_wait_ms.serve", ctx) is not None


def test_a_program_without_the_recorder_reads_none(monkeypatch):
    import llavamod_tpu_torch.runtime as runtime
    from llavamod_tpu_torch.runtime import trace

    trace.enable()
    try:
        with trace.span("serve.queue"):
            pass
    finally:
        trace.disable()
    # the parent commit's program: no runtime/trace.py
    monkeypatch.delattr(runtime, "trace")
    monkeypatch.setitem(sys.modules, "llavamod_tpu_torch.runtime.trace", None)
    for metric in ("queue_wait_ms.serve", "update_ms.train"):
        assert run.read_metric(metric, {}) is None
    monkeypatch.undo()
    assert [s["name"] for s in trace.collect()] == ["serve.queue"]
