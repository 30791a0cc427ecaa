"""peak_mem_gib.train: torch.cuda.max_memory_allocated over set-up and
window, in GiB."""


def read(ctx):
    peak = ctx.get("memory_peak_bytes")
    return peak / 2 ** 30 if peak else None
