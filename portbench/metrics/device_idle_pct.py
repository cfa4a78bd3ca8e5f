"""``device_idle_pct``: one minus the union of rank 0's device
operations over the traced window (the trace of the device alone), in
%: the share of the result's ``device`` busy and window seconds on rank
0.  CUPTI's tracing of every launch slows the host, so in a step the
host holds back the traced window idles more than the untraced one."""

from portbench.core.trace import busy_and_window


def read(ctx):
    bw = busy_and_window(ctx.trace)
    if bw is None:
        return None
    busy, window = bw
    return 100.0 * (1.0 - busy / window)
