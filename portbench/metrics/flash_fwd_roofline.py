"""``flash_fwd_roofline``: the flash forward's (B1, ``flash_fwd*``
kernels) share of its roofline on rank 0: the sum of each launch's bound
over the sum of their device times in the traced steps.  Every launch of
a cell has the cell's shape: ``[batch × heads, seq, head dim]``."""

from portbench.work.counts import bound_s, flash_fwd_launch


def read(ctx):
    ops = [op for op in ctx.trace.device_ops(ctx.trace.window(),
                                             kernels_only=True)
           if "flash_fwd" in op.name]
    if not ops or ctx.peaks is None:
        return None
    s = ctx.shape
    work = flash_fwd_launch(ctx.batch * s["n_head"], ctx.seq, ctx.seq,
                            s["d_model"] // s["n_head"], s["causal"])
    bound = bound_s(work["flops"], work["bytes"], ctx.peaks) * len(ops)
    spent = sum(op.end - op.start for op in ops) * 1e-6
    return 100.0 * bound / spent
