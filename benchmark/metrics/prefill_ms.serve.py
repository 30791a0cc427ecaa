"""prefill_ms.serve: device milliseconds of a batch's prefill (the
program's `generate.prefill` span, between its CUDA events: the prompt's
forward through the first token's pick), averaged over the traced run's
profiled batches."""

from benchmark.harness import spans as sp


def read(ctx):
    spans = sp.of(ctx)
    if not spans:
        return None
    return sp.mean(s["device_ms"] for s in sp.named(spans, "generate.prefill")
                   if s["device_ms"] is not None)
