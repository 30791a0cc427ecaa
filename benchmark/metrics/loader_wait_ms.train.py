"""loader_wait_ms.train: host milliseconds a microbatch's step of the
prefetcher spends blocked in the loader's `next` (the program's
`data.wait` spans, summed, over its `data.next` spans), over the traced
run's profiled accumulation cycle."""

from benchmark.harness import spans as sp


def read(ctx):
    spans = sp.of(ctx)
    if not spans:
        return None
    steps = sp.named(spans, "data.next")
    if not steps:
        return None
    waits = sum(sp.host_ms(s) for s in sp.named(spans, "data.wait"))
    return waits / len(steps)
