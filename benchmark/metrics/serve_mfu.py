"""serve_mfu: the least seconds that the H100's published dense bf16 peak
(989 TFLOP/s) allows for the operations the requests completed in the
window required (tower and projector, prefill of the real prompt tokens,
decode steps; benchmark/harness/flops.py), over the window's seconds, in
percent."""

from benchmark.harness import flops


def read(ctx):
    if not ctx.get("flops") or not ctx.get("window_s"):
        return None
    return 100.0 * flops.least_seconds(ctx["flops"]) / ctx["window_s"]
