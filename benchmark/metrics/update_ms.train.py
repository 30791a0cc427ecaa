"""update_ms.train: host milliseconds of an optimizer update (the
program's `train.update` spans whose `applied` is true: the clip, decided
on the host from the device norm, and AdamW), averaged over the updates of
the traced run's profiled accumulation cycle."""

from benchmark.harness import spans as sp


def read(ctx):
    spans = sp.of(ctx)
    if not spans:
        return None
    return sp.mean(sp.host_ms(s) for s in sp.named(spans, "train.update")
                   if s["attrs"].get("applied"))
