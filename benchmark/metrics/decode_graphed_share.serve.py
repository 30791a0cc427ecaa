"""decode_graphed_share.serve: the share, in %, of the decode steps of the
traced run's profiled batches that replayed a captured CUDA graph (the
program's `generate.decode_step` spans whose `graph` attribute is
"replay").  None where the program's spans say nothing of a graph."""

from benchmark.harness import spans as sp


def read(ctx):
    spans = sp.of(ctx)
    if not spans:
        return None
    paths = [s["attrs"].get("graph")
             for s in sp.named(spans, "generate.decode_step")]
    if not any(paths):
        return None
    return 100.0 * paths.count("replay") / len(paths)
