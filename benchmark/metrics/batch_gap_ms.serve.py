"""batch_gap_ms.serve: host milliseconds on the engine thread from one
batch's return from `generate` (its `serve.fanout` span opens) to the next
batch's `generate.prefill`: the fan-out, the drain, the padding and the
encode, while the card has nothing queued.  Averaged over the consecutive
pairs of the traced run's profiled batches."""

from benchmark.harness import spans as sp


def read(ctx):
    spans = sp.of(ctx)
    if not spans:
        return None
    gaps, returned = [], None
    for s in sorted((s for s in spans
                     if s["name"] in ("serve.fanout", "generate.prefill")),
                    key=lambda s: s["start_ns"]):
        if s["name"] == "serve.fanout":
            returned = s["start_ns"]
        elif returned is not None:
            gaps.append((s["start_ns"] - returned) / 1e6)
            returned = None
    return sp.mean(gaps)
