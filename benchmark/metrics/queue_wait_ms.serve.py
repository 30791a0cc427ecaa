"""queue_wait_ms.serve: host milliseconds a request waits in the engine's
queue, from `submit`'s put until the batch that serves it starts (the
program's `serve.queue` spans), averaged over the requests of the traced
run's profiled batches."""

from benchmark.harness import spans as sp


def read(ctx):
    spans = sp.of(ctx)
    if not spans:
        return None
    return sp.mean(sp.host_ms(s) for s in sp.named(spans, "serve.queue"))
