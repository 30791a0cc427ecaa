"""rows_per_batch.serve: the engine's own counters (`stats_snapshot()`),
batched rows over batches run in the window."""


def read(ctx):
    if not ctx.get("batches"):
        return None
    return ctx["rows"] / ctx["batches"]
