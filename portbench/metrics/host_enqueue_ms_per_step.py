"""``host_enqueue_ms_per_step``: the host's ms a step inside the step
call (the benchmark's span around each call, no synchronise), summed
over the untraced window of the traced run and divided by its steps."""


def read(ctx):
    host = ctx.window["host_s"]
    return 1e3 * sum(host) / len(host) if host else None
