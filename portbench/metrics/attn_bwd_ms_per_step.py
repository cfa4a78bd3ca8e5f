"""``attn_bwd_ms_per_step``: device ms a step on rank 0 of the kernels
launched inside the ``_Flash3Backward`` autograd node (the attention
backward, plain torch), linked to their launch by correlation id, in
the trace that holds the host's ops."""


def read(ctx):
    trace = ctx.host_trace
    ops = trace.launched_under("_Flash3Backward",
                               trace.device_ops(trace.window()))
    if not ops:
        return None
    return sum(op.end - op.start for op in ops) * 1e-3 / ctx.traced_steps
