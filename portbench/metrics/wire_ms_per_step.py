"""``wire_ms_per_step``: device ms a step on rank 0 of the operations
launched inside the port's ``hvd_tpu_wire`` span
(``DistributedOptimizer.synchronize``): error feedback, the compressed
fused allreduce with its NCCL kernels, the write-back.  NCCL kernels
count whole, the wait for the other ranks included."""

from portbench.core.spans import ms_per_step


def read(ctx):
    return ms_per_step(ctx, "hvd_tpu_wire")
