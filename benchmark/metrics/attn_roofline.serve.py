"""attn_roofline.serve: the roofline least time of the traced batches'
attention work (each prefill over the rows' real prompt tokens, and
each decode step over the rows' contexts; flops.attention_work),
over the device seconds of the attention kernels (K1, K2) in the
trace, in percent."""

KERNELS = ("flash_fwd_kernel", "flash_decode_split_kernel",
           "flash_decode_combine_kernel")


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or not ctx.get("attn_least_s"):
        return None
    busy = tr.seconds_of(KERNELS)
    return 100.0 * ctx["attn_least_s"] / busy if busy > 0 else None
