"""``wire_local_ms_per_step``: ``wire_ms_per_step`` without NCCL's
kernels: device ms a step on rank 0 of the rank's own work inside the
port's ``hvd_tpu_wire`` span (error feedback, the int8 kernels B2-B4,
the casts, the write-back).  The NCCL kernels, which count the wait for
the slowest rank whole, are left out, so a change to the rank's own
wire work shows here through the stragglers' noise."""

from portbench.core.spans import ms_per_step


def read(ctx):
    return ms_per_step(ctx, "hvd_tpu_wire", nccl=False)
