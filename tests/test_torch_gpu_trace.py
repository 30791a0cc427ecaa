"""The span recorder against the card: a kernel launched inside a program
span starts, on the device trace's clock (kineto's `start_ns`, as
benchmark/harness/trace.py reads it), after the span opened and before it
closed plus the launch's slack; and a `device=True` span's milliseconds
are those of CUDA events around the same launches.  Needs a CUDA device,
so these tests carry the `gpu` marker and skip elsewhere; run them on the
card with

    python -m pytest tests/test_torch_gpu_trace.py -m gpu
"""

import time

import pytest
import torch

from llavamod_tpu_torch.runtime import trace

pytestmark = pytest.mark.gpu

N = 8192
SLACK_NS = 2_000_000       # the launch's queueing, and the clocks' offset


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the spans' CUDA events and the "
                    "device trace exist only on the card")
    trace.collect()
    yield torch.device("cuda", 0)
    trace.disable()
    trace.collect()


def _operands(dev):
    g = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn((N, N), generator=g, device=dev, dtype=torch.bfloat16)
    b = torch.randn((N, N), generator=g, device=dev, dtype=torch.bfloat16)
    a @ b                  # warm: the cuBLAS handle and its heuristics
    torch.cuda.synchronize()
    return a, b


def test_a_kernel_starts_inside_its_span_on_the_trace_clock(dev):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    a, b = _operands(dev)
    # as the benchmark traces: device activity only; the recorder runs
    # while the profiler does
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(0.05)           # the card idles: nothing is queued
        with trace.span("probe.matmul"):
            time.sleep(0.005)
            a @ b
        torch.cuda.synchronize()
    rec, = [r for r in trace.collect() if r["name"] == "probe.matmul"]
    kernels = [(e.duration_ns(), e.start_ns())
               for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA]
    assert kernels
    _, start = max(kernels)        # the GEMM, the longest
    assert rec["start_ns"] + 4_000_000 <= start <= rec["end_ns"] + SLACK_NS, (
        start - rec["start_ns"], rec["end_ns"] - rec["start_ns"])


def test_a_device_span_agrees_with_cuda_events(dev):
    a, b = _operands(dev)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    trace.enable()
    e0.record()
    with trace.span("probe.matmuls", device=True):
        for _ in range(20):
            a @ b
    e1.record()
    trace.disable()
    torch.cuda.synchronize()
    rec, = trace.collect()
    want = e0.elapsed_time(e1)
    assert abs(rec["device_ms"] - want) <= 0.05 * want, (rec["device_ms"],
                                                          want)
