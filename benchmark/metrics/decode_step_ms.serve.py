"""decode_step_ms.serve: device milliseconds of one decode step of a batch
(the program's `generate.decode_step` span, between its CUDA events),
averaged over the steps of the traced run's profiled batches."""

from benchmark.harness import spans as sp


def read(ctx):
    spans = sp.of(ctx)
    if not spans:
        return None
    return sp.mean(s["device_ms"]
                   for s in sp.named(spans, "generate.decode_step")
                   if s["device_ms"] is not None)
