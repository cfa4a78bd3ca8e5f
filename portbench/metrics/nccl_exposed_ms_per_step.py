"""``nccl_exposed_ms_per_step``: device ms a step on rank 0 in which an
NCCL kernel runs and no other device operation does, from the union of
intervals over the traced steps."""

from portbench.core.trace import clip, minus


def read(ctx):
    window = ctx.trace.window()
    ops = ctx.trace.device_ops(window)
    nccl = [(op.start, op.end) for op in ops if "nccl" in op.name.lower()]
    if not nccl:
        return None
    other = [(op.start, op.end) for op in ops if "nccl" not in op.name.lower()]
    exposed = minus(clip(nccl, window), clip(other, window))
    return exposed * 1e-3 / ctx.traced_steps
