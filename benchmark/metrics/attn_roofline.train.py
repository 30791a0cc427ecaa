"""attn_roofline.train: the roofline least time of the traced microbatches'
attention work (the student's forward and backward, the teacher's
forward, counted from their real token counts; flops.attention_work),
over the device seconds of the attention kernels (K1, K3, K4) in the
trace, in percent.  The student's recomputed forward is work the kernels
do that no count asks for."""

KERNELS = ("flash_fwd_kernel", "flash_dq_kernel", "flash_dkv_kernel")


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or not ctx.get("attn_least_s"):
        return None
    busy = tr.seconds_of(KERNELS)
    return 100.0 * ctx["attn_least_s"] / busy if busy > 0 else None
