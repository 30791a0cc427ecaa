"""collective_share.train: the share of rank 0's busy device time in the
traced sub-window (one accumulation cycle after the window) in which an
NCCL kernel ran: the expert all-to-all, FSDP2's all-gathers and
reduce-scatters, the gradients' all-reduce over the replicas and the
gating gather, as the union of their intervals over rank 0's busy
seconds, in percent.  Nothing to read on one card, where no NCCL kernel
runs."""

PATTERNS = ("nccl", "NCCL")


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or tr.busy_s <= 0:
        return None
    nccl = tr.union_seconds(PATTERNS)
    return 100.0 * nccl / tr.busy_s if nccl > 0 else None
