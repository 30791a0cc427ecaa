"""generate_ms.serve: host milliseconds of the benchmark's span around each
`generation.generate` call of the traced run, ending in a synchronise,
averaged over the window's batches."""


def read(ctx):
    spans = ctx.get("generate_s")
    if not spans:
        return None
    return 1e3 * sum(spans) / len(spans)
