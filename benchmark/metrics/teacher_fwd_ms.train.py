"""teacher_fwd_ms.train: device milliseconds of the teacher's forward (the
program's `train.teacher_fwd` span, between its CUDA events), averaged
over the microbatches of the traced run's profiled accumulation cycle."""

from benchmark.harness import spans as sp


def read(ctx):
    spans = sp.of(ctx)
    if not spans:
        return None
    return sp.mean(s["device_ms"] for s in sp.named(spans, "train.teacher_fwd")
                   if s["device_ms"] is not None)
