"""train_mfu: the least seconds that the H100's published dense peaks allow
for the operations the window's microbatches required (bf16 at 989
TFLOP/s, int8 at 1,979 TOP/s; benchmark/harness/flops.py), over the
window's seconds, in percent."""

from benchmark.harness import flops


def read(ctx):
    if not ctx.get("flops") or not ctx.get("window_s"):
        return None
    return 100.0 * flops.least_seconds(ctx["flops"]) / ctx["window_s"]
