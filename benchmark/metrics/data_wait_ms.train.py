"""data_wait_ms.train: host milliseconds a microbatch of the window waits
for its batch from the program's data path (the benchmark's span around
the prefetcher's `next`), averaged over the window."""


def read(ctx):
    waits = ctx.get("data_wait_s")
    if not waits:
        return None
    return 1e3 * sum(waits) / len(waits)
