"""encode_host_ms.serve: host milliseconds a batch spends in the runner's
batch building (`VQARunner.timings["encode"]`: tokenize, splice, copy to
the device), per batch of the window."""


def read(ctx):
    if not ctx.get("batches"):
        return None
    return 1e3 * ctx["encode_s"] / ctx["batches"]
